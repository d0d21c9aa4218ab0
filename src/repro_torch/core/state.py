"""Configuration state space for annealing-based procurement.

The paper's annealing state ``x`` is a cluster configuration drawn from a
large discrete domain ``D`` (instance type, number of cores, memory per
core, ...).  Section 5 of the paper generalizes ``x`` to a vector whose
elements count service instances of each type.  We implement a generic
ordered-discrete product space with a validity predicate, which covers

* the paper's EC2 space: (instance_family, cores_per_node, n_nodes),
* the TPU procurement space: (slice_type, dp_degree, microbatch, remat,
  compression, ...),
* synthetic 1-D landscapes used in the paper's illustrative figures.

States are index vectors into per-dimension value tuples; neighborhoods are
incremental (+-1 on one dimension), matching the paper's ``z_n = x_{n-1} +
e_v`` incremental-exploration requirement, and the induced move graph is
connected on the valid region whenever the valid region is coordinate-wise
connected (checked by :func:`repro_torch.core.neighborhood.check_connected` for
small spaces in tests).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dimension:
    """One discrete configuration dimension.

    ``kind`` distinguishes the paper's "partially categorical" axes:

    * ``"ordinal"`` — ``values`` are ordered so adjacent values are "close"
      in effect; neighborhoods move +-1 along the axis.  (The paper notes
      that a poor ordering of categorical instance types can introduce
      artificial local minima, sec. 4.2.1.)
    * ``"categorical"`` — no meaningful order (e.g. remat strategy); the
      traced proposal kernel resamples uniformly among the other values
      instead of stepping, which removes the artificial-adjacency problem.

    The Python-side :class:`repro_torch.core.neighborhood.StepNeighborhood` treats
    every axis ordinally; ``kind`` is consumed by the compiled N-dim engine
    (:func:`repro_torch.core.annealing.anneal_chain_nd`).
    """

    name: str
    values: tuple[Any, ...]
    kind: str = "ordinal"

    def __post_init__(self) -> None:
        if len(self.values) == 0:
            raise ValueError(f"dimension {self.name!r} has no values")
        if len(set(map(repr, self.values))) != len(self.values):
            raise ValueError(f"dimension {self.name!r} has duplicate values")
        if self.kind not in ("ordinal", "categorical"):
            raise ValueError(f"dimension {self.name!r}: bad kind {self.kind!r}")

    def __len__(self) -> int:
        return len(self.values)


@dataclasses.dataclass(frozen=True)
class ConfigSpace:
    """Product of ordered discrete dimensions with an optional validity rule."""

    dimensions: tuple[Dimension, ...]
    is_valid: Callable[[Mapping[str, Any]], bool] | None = None

    def __post_init__(self) -> None:
        names = [d.name for d in self.dimensions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dimension names: {names}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(d.name for d in self.dimensions)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(d) for d in self.dimensions)

    def size(self) -> int:
        n = 1
        for d in self.dimensions:
            n *= len(d)
        return n

    def decode(self, idx: Sequence[int]) -> dict[str, Any]:
        """Index vector -> concrete configuration mapping."""
        if len(idx) != len(self.dimensions):
            raise ValueError(
                f"index length {len(idx)} != ndim {len(self.dimensions)}"
            )
        return {d.name: d.values[i] for d, i in zip(self.dimensions, idx)}

    def encode(self, cfg: Mapping[str, Any]) -> tuple[int, ...]:
        """Concrete configuration -> index vector (inverse of decode)."""
        idx = []
        for d in self.dimensions:
            try:
                idx.append(d.values.index(cfg[d.name]))
            except (KeyError, ValueError) as e:
                raise ValueError(
                    f"config {cfg!r} invalid on dimension {d.name!r}"
                ) from e
        return tuple(idx)

    def contains(self, idx: Sequence[int]) -> bool:
        for d, i in zip(self.dimensions, idx):
            if not (0 <= i < len(d)):
                return False
        if self.is_valid is not None:
            return bool(self.is_valid(self.decode(idx)))
        return True

    def valid_states(self) -> list[tuple[int, ...]]:
        """Enumerate valid index vectors.  Only for small spaces (tests)."""
        if self.size() > 200_000:
            raise ValueError(f"space too large to enumerate: {self.size()}")
        out = []
        for idx in itertools.product(*(range(len(d)) for d in self.dimensions)):
            if self.contains(idx):
                out.append(idx)
        return out

    def validity_mask(self, max_size: int = 200_000) -> np.ndarray | None:
        """Boolean array of shape :attr:`shape`; None when every index is
        valid (no ``is_valid`` predicate).  Requires an enumerable space."""
        if self.is_valid is None:
            return None
        if self.size() > max_size:
            raise ValueError(f"space too large to tabulate: {self.size()}")
        mask = np.zeros(self.shape, dtype=bool)
        for idx in itertools.product(*(range(len(d)) for d in self.dimensions)):
            mask[idx] = self.contains(idx)
        return mask

    def encoded(self, max_size: int = 200_000) -> "EncodedSpace":
        """Static, trace-friendly view consumed by the compiled engine."""
        return EncodedSpace(
            shape=self.shape,
            categorical=tuple(d.kind == "categorical" for d in self.dimensions),
            valid_mask=self.validity_mask(max_size),
        )


@dataclasses.dataclass(frozen=True, eq=False)  # eq would compare the mask array
class EncodedSpace:
    """A ConfigSpace flattened for the pure-JAX chain.

    ``shape`` and ``categorical`` are Python tuples — static under jit, so
    they can parameterize compiled proposal kernels; ``valid_mask`` is a
    host-side boolean array over the full product (None == all valid) that
    the chain consults as data, turning the constrained region into a
    rejection mask.
    """

    shape: tuple[int, ...]
    categorical: tuple[bool, ...]
    valid_mask: np.ndarray | None = None

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.categorical):
            raise ValueError("shape/categorical rank mismatch")
        if self.valid_mask is not None and self.valid_mask.shape != self.shape:
            raise ValueError(
                f"valid_mask shape {self.valid_mask.shape} != {self.shape}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def random_valid_state(
    space: ConfigSpace, rng: np.random.Generator, tries: int = 10_000
) -> tuple[int, ...]:
    """Uniform rejection sample from the valid region (paper sec. 3:
    "Starting with a random configuration for x_0").  The single
    implementation behind :class:`repro_torch.core.annealing.Annealer` and the
    surrogate subsystem's samplers."""
    for _ in range(tries):
        idx = tuple(int(rng.integers(n)) for n in space.shape)
        if space.contains(idx):
            return idx
    raise ValueError(
        f"no valid state found in ConfigSpace"
        f"({', '.join(space.names)}) shape={space.shape} "
        f"after {tries} uniform samples — the validity predicate may "
        f"reject every state (or the valid region is vanishingly small; "
        f"pass an explicit init)")


# ---------------------------------------------------------------------------
# Concrete cluster configuration (decoded view used by evaluators)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """A procured cluster: the decoded, validated annealing state.

    This is the vector-state extension from paper sec. 5: it names the
    service (instance/slice) type, the scale, and — for the TPU adaptation —
    the parallelism layout knobs that determine execution time.
    """

    instance_type: str          # catalog key, e.g. "m6i" or "v5e"
    n_workers: int              # nodes (VMs) or chips (TPU)
    cores_per_worker: int = 1   # vCPUs per node; 1 for TPU chips
    # --- TPU-adaptation knobs (ignored by the VM evaluators) ---
    dp_degree: int = 1          # data-parallel mesh extent
    tp_degree: int = 1          # tensor/model-parallel mesh extent
    microbatches: int = 1       # gradient-accumulation factor
    remat: str = "none"         # "none" | "block" | "full"
    compression: str = "none"   # "none" | "int8" (gradient all-reduce)

    @property
    def total_cores(self) -> int:
        return self.n_workers * self.cores_per_worker

    def replace(self, **kw: Any) -> "ClusterConfig":
        return dataclasses.replace(self, **kw)


def cluster_config_from(cfg: Mapping[str, Any]) -> ClusterConfig:
    """Build a ClusterConfig from a decoded ConfigSpace mapping.

    Unknown keys are ignored so that spaces can carry extra evaluator-only
    dimensions.
    """
    fields = {f.name for f in dataclasses.fields(ClusterConfig)}
    return ClusterConfig(**{k: v for k, v in cfg.items() if k in fields})
