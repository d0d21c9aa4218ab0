"""Violation-window postmortems over telemetry snapshots.

When the fleet's aggregate constraints were breached, the operator's
first question is "what happened around the breach?".  This module
answers it from a ``TELEMETRY_*.json`` snapshot (the
:func:`repro_torch.telemetry.report.build_snapshot` payload, which
embeds the provenance flight recorder and the alert engine):

1. :func:`violation_windows` scans the ``fleet/violation`` series (round
   axis) for contiguous runs of positive aggregate overshoot, pads each
   run by a round on both sides, and merges overlaps;
2. :func:`render_postmortem` prints, per window, an interleaved timeline
   of drift detections, reheats, churn events (arrive/depart/phase),
   fired alerts, and the non-trivial decision records (defers, preempts,
   positive marginal violations) inside the window — each with its
   one-line ``why``.

Exposed through the report CLI as
``python -m repro_torch.telemetry.report TELEMETRY_x.json --section postmortem``.

Stdlib-only, pure functions over the snapshot dict.
"""

from __future__ import annotations

from typing import Any

__all__ = ["violation_windows", "render_postmortem"]

#: Aggregate overshoot below this is numerical noise, not a breach.
DEFAULT_THRESHOLD = 1e-9


def _violation_series(snap: dict[str, Any]) -> tuple[list[float], list[float]]:
    """(rounds, violations) from the snapshot; prefers the fleet's
    round-keyed series over the replay's event-time-keyed one."""
    series = snap.get("metrics", {}).get("series", {})
    s = series.get("fleet/violation")
    if s and s.get("v"):
        return list(s["t"]), list(s["v"])
    return [], []


def violation_windows(snap: dict[str, Any],
                      threshold: float = DEFAULT_THRESHOLD,
                      pad: int = 1) -> list[tuple[int, int]]:
    """Inclusive ``(r0, r1)`` round windows where the aggregate was
    infeasible, padded by ``pad`` rounds and merged when overlapping."""
    ts, vs = _violation_series(snap)
    runs: list[tuple[int, int]] = []
    start: int | None = None
    prev_r = 0
    for t, v in zip(ts, vs):
        r = int(t)
        if v > threshold:
            if start is None:
                start = r
        elif start is not None:
            runs.append((start, prev_r))
            start = None
        prev_r = r
    if start is not None:
        runs.append((start, prev_r))
    merged: list[tuple[int, int]] = []
    for r0, r1 in runs:
        r0, r1 = r0 - pad, r1 + pad
        if merged and r0 <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(merged[-1][1], r1))
        else:
            merged.append((max(0, r0), r1))
    return merged


def _timeline(snap: dict[str, Any], r0: int, r1: int,
              max_records: int = 24) -> list[tuple[int, str, str]]:
    """Sorted ``(round, kind, line)`` entries inside the window."""
    entries: list[tuple[int, str, str]] = []
    prov = snap.get("provenance", {})
    for ev in prov.get("events", []):
        r = int(ev.get("round", 0))
        if r0 <= r <= r1:
            who = f" {ev['tenant']}" if ev.get("tenant") else ""
            extra = f" ({ev['detail']})" if ev.get("detail") else ""
            entries.append((r, ev.get("kind", "event"),
                            f"{ev.get('kind', 'event')}{who}{extra}"))
    for a in snap.get("alerts", {}).get("fired", []):
        r = int(a.get("round", 0))
        if r0 <= r <= r1:
            entries.append((r, "alert",
                            f"ALERT[{a.get('severity', 'warn')}] "
                            f"{a.get('rule')}: {a.get('message')}"))
    shown = 0
    for rec in prov.get("records", []):
        r = int(rec.get("round", 0))
        if not (r0 <= r <= r1):
            continue
        nontrivial = (rec.get("action") in ("defer", "preempt")
                      or rec.get("violation", 0.0) > DEFAULT_THRESHOLD
                      or rec.get("reheated"))
        if not nontrivial:
            continue
        if shown < max_records:
            entries.append((r, "decision", rec.get("why", "")))
        shown += 1
    entries.sort(key=lambda e: (e[0], e[1]))
    if shown > max_records:
        entries.append((r1, "zz-note",
                        f"... {shown - max_records} more decision "
                        f"records in window (truncated)"))
    return entries


def render_postmortem(snap: dict[str, Any], width: int = 48,
                      threshold: float = DEFAULT_THRESHOLD) -> str:
    """Human-readable violation postmortem for the snapshot."""
    ts, vs = _violation_series(snap)
    lines: list[str] = ["== postmortem =="]
    if not vs:
        lines.append("  no fleet/violation series in snapshot "
                     "(run with telemetry armed)")
        return "\n".join(lines)
    windows = violation_windows(snap, threshold=threshold)
    if not windows:
        lines.append(f"  aggregate stayed feasible for all "
                     f"{len(vs)} recorded rounds — nothing to explain")
        return "\n".join(lines)
    by_round = {int(t): v for t, v in zip(ts, vs)}
    for r0, r1 in windows:
        peak = max((by_round.get(r, 0.0) for r in range(r0, r1 + 1)),
                   default=0.0)
        lines.append(f"  window rounds {r0}..{r1} "
                     f"(peak overshoot {peak:.4g}):")
        entries = _timeline(snap, r0, r1)
        if not entries:
            lines.append("    (no provenance in window — recorder "
                         "dropped it or provenance was dark)")
        for r, kind, line in entries:
            if kind == "zz-note":
                lines.append(f"    {line}")
            else:
                lines.append(f"    r{r:<5d} {line}")
    return "\n".join(lines)
