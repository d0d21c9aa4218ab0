"""Carry state across from the reference package.

What a long-running controller has learned is its measurement store and
its control state (incumbent, round index, reheat schedule, drift-detector
statistics).  These functions take that state as plain numpy/Python
values — read off a controller of either package — and rebuild it here, so
a loop started under the JAX package continues in the port.  The LM
stack's weights come across the same way, as the reference's parameter
tree of arrays (:func:`model_params_from_jax`), and a training run's
whole state (:func:`train_state_from_jax`).  Nothing here imports the
reference package: foreign objects are only read through their attributes
and arrays.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .core.surrogate import MeasurementStore
from .device import resolve_device
from .models.attention import Attention
from .models.mlp import MLP
from .models.transformer import Block, Model, Norm, stack_plan
from .optim.optimizer import OptState
from .runtime.train import TrainState, TrainStepOptions

_SCHEDULE_FIELDS = ("tau_base", "tau_hot", "relax", "_reheat_at")
_DETECTOR_FIELDS = ("delta", "threshold", "min_obs", "z_clip",
                    "_n", "_mean", "_m2", "_up", "_down")


def measurement_store_from_arrays(
    obs: np.ndarray | Sequence[Sequence[int]],
    ys: np.ndarray | Sequence[float],
    ts: np.ndarray | Sequence[float],
    half_life: float | None = None,
    capacity: int = 8192,
) -> MeasurementStore:
    """A :class:`MeasurementStore` holding ``obs`` (M, ndim) states with
    objectives ``ys`` and timestamps ``ts`` (M,), added in the given
    (refresh) order — e.g. the ``arrays()`` of another package's store."""
    obs = np.asarray(obs, np.int64)
    ys = np.asarray(ys, np.float64)
    ts = np.asarray(ts, np.float64)
    if obs.ndim != 2 or ys.shape != (len(obs),) or ts.shape != (len(obs),):
        raise ValueError(f"obs {obs.shape}, ys {ys.shape}, ts {ts.shape}: "
                         f"want (M, ndim), (M,), (M,)")
    store = MeasurementStore(obs.shape[1], half_life=half_life,
                             capacity=capacity)
    for s, y, t in zip(obs, ys, ts):
        store.add(s, float(y), float(t))
    return store


def sizing_state(controller: Any) -> dict[str, Any]:
    """The control state of a sizing controller of either package, as
    plain Python values: ``incumbent``, ``round``, ``reheat_pending``,
    ``schedule`` (the :class:`AdaptiveReheat` fields) and ``detector``
    (the :class:`PageHinkley` fields, or None without a detector)."""
    det = controller._detector
    return {
        "incumbent": tuple(int(i) for i in controller.incumbent),
        "round": int(controller._round),
        "reheat_pending": bool(controller._reheat_pending),
        "schedule": {k: getattr(controller._schedule, k)
                     for k in _SCHEDULE_FIELDS},
        "detector": (None if det is None else
                     {k: getattr(det, k) for k in _DETECTOR_FIELDS}),
    }


def load_sizing_state(controller: Any, state: Mapping[str, Any]) -> None:
    """Set a :class:`repro_torch.core.sizing.SizingController`'s control
    state from :func:`sizing_state`'s dict, so its next round continues
    the source controller's run (same round index, incumbent, schedule
    and detector)."""
    inc = tuple(int(i) for i in state["incumbent"])
    if not controller.space.contains(inc):
        raise ValueError(f"incumbent {inc} not in the space")
    controller.incumbent = inc
    controller._round = int(state["round"])
    controller._reheat_pending = bool(state["reheat_pending"])
    sched = state["schedule"]
    for k in _SCHEDULE_FIELDS:
        setattr(controller._schedule, k, sched[k])
    det = state.get("detector")
    if det is not None and controller._detector is not None:
        for k in _DETECTOR_FIELDS:
            setattr(controller._detector, k, det[k])


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor of the same type.  The ml_dtypes
    bfloat16 that ``np.asarray`` gives for a JAX bf16 array is not a type
    ``torch.from_numpy`` takes; its bits go across as uint16."""
    a = np.array(a)                        # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def model_params_from_jax(tree: Mapping[str, Any], config: Any,
                          device: str | torch.device = "cuda") -> Model:
    """The port's :class:`repro_torch.models.transformer.Model` holding the
    weights of a reference model: ``tree`` is the value tree of the
    reference's ``split_boxes(init_model(key, config, tp=1))[0]`` (nested
    dicts of numpy or JAX arrays), ``config`` the port's copy of the
    model's config.  The weights go to ``device``, the card unless the
    caller names another.  The scanned stack's leading reps dimension is
    split into one block per layer.  Trees built with tp > 1 (padded
    heads) are refused: one device has no use for the padding."""
    dev = resolve_device(device)
    plan = stack_plan(config)
    stack = tree["stack"]

    def norm(p):
        return Norm(_tensor(p["scale"], dev),
                    None if "bias" not in p else _tensor(p["bias"], dev))

    def block(p, lk):
        a, f = p["attn"], p["ffn"]
        H, K = np.shape(a["wq"])[1], np.shape(a["wk"])[1]
        if (H, K) != (config.n_heads, config.n_kv_heads):
            raise ValueError(
                f"attention has {H} query / {K} kv heads where "
                f"{config.name} has {config.n_heads} / {config.n_kv_heads}: "
                f"a tree built with tp > 1 has padded heads; build it with "
                f"tp=1")
        return Block(lk, norm(p["ln1"]), norm(p["ln2"]), Attention(
            *(_tensor(a[w], dev) for w in ("wq", "wk", "wv", "wo")),
            q_norm=_tensor(a["q_norm"], dev) if "q_norm" in a else None,
            k_norm=_tensor(a["k_norm"], dev) if "k_norm" in a else None),
            MLP(_tensor(f["w_in"], dev), _tensor(f["w_out"], dev),
                _tensor(f["w_gate"], dev) if "w_gate" in f else None))

    def unstack(t, r):
        if isinstance(t, Mapping):
            return {k: unstack(v, r) for k, v in t.items()}
        return np.asarray(t)[r]

    layers = []
    for r in range(plan.reps):
        for pi, lk in enumerate(plan.pattern):
            layers.append(block(unstack(stack["scan"][pi], r), lk))
    for lk, p in zip(plan.tail, stack["tail"]):
        layers.append(block(p, lk))
    return Model(config, _tensor(tree["embed"], dev),
                 _tensor(tree["lm_head"], dev), norm(tree["final_norm"]),
                 layers)


def train_state_from_jax(state: Any, config: Any,
                         options: TrainStepOptions | None = None,
                         device: str | torch.device = "cuda") -> TrainState:
    """The port's :class:`repro_torch.runtime.train.TrainState` holding a
    reference ``TrainState``: its params (through
    :func:`model_params_from_jax`), its AdamW moments ``opt.m``/``opt.v``
    and step count, and its error-feedback residual, the stacked leaves
    unstacked into one tensor per layer as the params are, each keyed by
    the port's parameter name.  Types are kept.  ``options`` (the port's
    copy of the step's options) is checked against the state: int8
    compression needs the residual, "none" has none.  The tensors go to
    ``device``, the card unless the caller names another."""
    dev = resolve_device(device)
    model = model_params_from_jax(state.params, config, dev)
    model.requires_grad_(True)

    def named(tree):
        return {n: p.detach() for n, p in
                model_params_from_jax(tree, config, dev).named_parameters()}

    residual = None if state.residual is None else named(state.residual)
    if options is not None and (residual is None) != (
            options.compression != "int8"):
        raise ValueError(f"compression {options.compression!r} and a state "
                         f"{'without' if residual is None else 'with'} an "
                         f"error-feedback residual do not match")
    count = torch.tensor(int(np.asarray(state.opt.count)), dtype=torch.int32,
                         device=dev)
    return TrainState(model, OptState(m=named(state.opt.m),
                                      v=named(state.opt.v), count=count),
                      residual)
