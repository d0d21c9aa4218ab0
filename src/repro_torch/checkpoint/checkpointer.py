"""Atomic, async checkpointing on plain numpy files.

The counterpart of the reference package's ``checkpoint/checkpointer.py``,
in its on-disk layout.  Per step directory:
    step_000123/
      manifest.json        # tree structure, leaf dtypes/shapes, extra
      arr_00000.npy ...    # one file per leaf (copied to the host)
      _COMMITTED           # atomicity marker, written last

A tree is nested dicts (keys in sorted order, as the reference flattens
them), lists or tuples of tensors; ``None`` is an empty subtree.
  * atomic: readers only consume directories with the _COMMITTED marker;
    a crash mid-write leaves a garbage directory that is skipped and
    removed on the next save;
  * async: ``save(..., blocking=False)`` copies the tensors to the host at
    the call (the state at save time is what lands on disk, even when the
    caller then updates its tensors in place) and writes them on a thread;
  * keep-last-k, never deleting the newest committed checkpoint;
  * restore places each tensor on a named device (default: its template
    leaf's).  The reference's restore re-places arrays against a mesh's
    shardings; that waits for the multi-card slice.

bfloat16 leaves are stored as uint16 raw bits (npy has no bf16 dtype).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

_BF16 = "bfloat16"


def _leaves(tree: Any) -> list[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _structure(tree: Any) -> Any:
    """The tree's shape as JSON values: "*" for a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(t) for t in tree]
    return "*"


def _unflatten(template: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


@dataclasses.dataclass(frozen=True)
class _HostArray:
    """A leaf copied to the host: its array and logical dtype string."""

    arr: np.ndarray
    dtype: str


def _to_host(t) -> _HostArray:
    if isinstance(t, _HostArray):
        return t
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return _HostArray(t.view(torch.int16).numpy().view(np.uint16), _BF16)
    arr = t.numpy()
    return _HostArray(arr, str(arr.dtype))


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(tree: Any, directory: str, *, step: int,
                extra: dict | None = None) -> str:
    """Write one atomic checkpoint; returns the committed path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves = _leaves(tree)
    manifest = {
        "step": step,
        "treedef": json.dumps(_structure(tree)),
        "n_leaves": len(leaves),
        "extra": extra or {},
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        host = _to_host(leaf)
        np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), host.arr,
                allow_pickle=False)
        manifest["leaves"].append(
            {"dtype": host.dtype, "shape": list(host.arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "_COMMITTED")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def restore_pytree(template: Any, directory: str, *,
                   step: int | None = None,
                   device: str | torch.device | None = None
                   ) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` (a tree of tensors, or of
    anything with ``shape`` and ``device``), placing each tensor on
    ``device`` (default: its template leaf's device).  Returns (tree,
    manifest extra)."""
    steps = committed_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    leaves = _leaves(template)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves; template has "
            f"{len(leaves)} — structure mismatch")
    out = []
    for i, tpl in enumerate(leaves):
        arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"),
                      allow_pickle=False)
        t = _from_numpy(arr, manifest["leaves"][i]["dtype"])
        want = tuple(getattr(tpl, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"leaf {i}: ckpt shape {tuple(t.shape)} != "
                             f"{want}")
        out.append(t.to(device if device is not None
                        else getattr(tpl, "device", "cpu")))
    return _unflatten(template, out), manifest.get("extra", {})


@dataclasses.dataclass
class CheckpointManager:
    """keep-last-k manager with async commit and crash-garbage GC."""

    directory: str
    keep: int = 3

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []

    # -- save --
    def save(self, tree: Any, step: int, *, extra: dict | None = None,
             blocking: bool = True) -> None:
        self.wait()
        # device->host now (state must be snapshot at call time)
        host = _unflatten(tree, [_to_host(t) for t in _leaves(tree)])

        def work():
            try:
                save_pytree(host, self.directory, step=step, extra=extra)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error.append(e)

        if blocking:
            work()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error:
            raise RuntimeError("async checkpoint failed") from self._error.pop()

    # -- restore --
    def restore(self, template: Any, *, step: int | None = None,
                device: str | torch.device | None = None
                ) -> tuple[Any, dict]:
        self.wait()
        return restore_pytree(template, self.directory, step=step,
                              device=device)

    def latest_step(self) -> int | None:
        steps = committed_steps(self.directory)
        return steps[-1] if steps else None

    # -- gc --
    def _gc(self) -> None:
        steps = committed_steps(self.directory)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
        # crash garbage
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
