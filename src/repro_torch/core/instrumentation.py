"""Observation seams for the analysis layer (repro.analysis).

The runtime sanitizer and the race detector need to see two things the
core cannot know it is being watched for:

* **controller-round boundaries** — the sanitizer attributes compile and
  device->host-transfer counts to rounds, and the zero-retrace invariant
  is "no recompilation after the warm-up round";
* **shared-state accesses inside their guarding critical sections** — a
  lockset race detector must observe the access *while* the guarding
  lock is held, which an outside-in wrapper cannot do.

Both are plain hook lists, empty by default.  The guards below compile
to one global load + truth test on the hot path, so production runs pay
nothing; ``repro.analysis.sanitize`` / ``repro.analysis.racecheck``
register themselves here when installed.  Core never imports the
analysis package — the dependency points analysis -> core only.
"""

from __future__ import annotations

from typing import Any, Callable

# fired as hook(controller_name, controller) at the end of each control
# round (ProcurementController.submit, FleetController.round,
# SizingController.round, SurrogateAnnealer.round)
ROUND_HOOKS: list[Callable[[str, Any], None]] = []

# fired as hook(resource_label, owner, is_write) at each instrumented
# shared-state access, from inside the guarding critical section (if any)
RACE_HOOKS: list[Callable[[str, Any, bool], None]] = []


def note_round(name: str, owner: Any) -> None:
    if ROUND_HOOKS:
        for hook in ROUND_HOOKS:
            hook(name, owner)


def race_access(resource: str, owner: Any, write: bool = True) -> None:
    if RACE_HOOKS:
        for hook in RACE_HOOKS:
            hook(resource, owner, write)
