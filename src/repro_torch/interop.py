"""Carry a running controller's state across from the reference package.

The system has no weights: what a long-running controller has learned is
its measurement store and its control state (incumbent, round index,
reheat schedule, drift-detector statistics).  These functions take that
state as plain numpy/Python values — read off a controller of either
package — and rebuild it here, so a loop started under the JAX package
continues in the port.  Nothing here imports the reference package: a
foreign controller is only read through its attributes.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from .core.surrogate import MeasurementStore

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
