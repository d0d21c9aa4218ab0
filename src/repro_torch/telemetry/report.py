"""Telemetry snapshots and the terminal dashboard CLI.

:func:`build_snapshot` folds a :class:`~repro_torch.telemetry.registry.
MetricsRegistry` and a :class:`~repro_torch.telemetry.spans.SpanRecorder` into
one plain-JSON dict — the payload ``benchmarks/run.py`` writes as
``TELEMETRY_<suite>.json`` next to each ``BENCH_<suite>.json``.
:func:`render` turns that snapshot into a terminal dashboard: one
sparkline row per recorded series (per-round objective / cost / SLO
attainment), then counters, gauges, histogram percentiles, and the span
wall-clock table.

CLI::

    python -m repro_torch.telemetry.report TELEMETRY_trace.json
    python -m repro_torch.telemetry.report TELEMETRY_trace.json --section series
    python -m repro_torch.telemetry.report TELEMETRY_trace.json --section alerts \
        --fail-on-alerts              # CI gate: exit 1 if any rule fired
    python -m repro_torch.telemetry.report TELEMETRY_trace.json --section terms
    python -m repro_torch.telemetry.report TELEMETRY_trace.json --section postmortem

``--fail-on-alerts`` also accepts a bare ``ALERTS_*.json`` artifact (the
alert engine's own dump) in place of the full snapshot.

The Perfetto trace is the companion artifact (``*.perfetto.json``) —
open that in https://ui.perfetto.dev; this module is the "no browser at
hand" view of the same run.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Iterable

from .registry import MetricsRegistry
from .spans import SpanRecorder

__all__ = ["SPARK", "sparkline", "build_snapshot", "render", "main"]

SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: Iterable[float], width: int = 48) -> str:
    """Unicode sparkline of ``values`` downsampled to ``width`` chars."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        # bucket-mean downsample so spikes survive visually
        step = len(vals) / width
        vals = [sum(vals[int(i * step):max(int((i + 1) * step),
                                           int(i * step) + 1)])
                / max(int((i + 1) * step) - int(i * step), 1)
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return SPARK[0] * len(vals)
    return "".join(SPARK[min(int((v - lo) / span * (len(SPARK) - 1)
                                 + 0.5), len(SPARK) - 1)] for v in vals)


def build_snapshot(metrics: MetricsRegistry | None = None,
                   spans: SpanRecorder | None = None,
                   meta: dict[str, Any] | None = None,
                   provenance: Any = None,
                   alerts: Any = None) -> dict[str, Any]:
    """One JSON-serializable dict for the whole run.  ``provenance`` is
    a :class:`~repro_torch.telemetry.provenance.FlightRecorder` and ``alerts``
    an :class:`~repro_torch.telemetry.alerts.AlertEngine` (both optional —
    their sections stay empty when dark)."""
    return {
        "meta": dict(meta or {}),
        "metrics": metrics.snapshot() if metrics is not None else {
            "counters": {}, "gauges": {}, "series": {}, "histograms": {}},
        "spans": {
            "summary": spans.summary() if spans is not None else {},
            "dropped": spans.dropped if spans is not None else 0,
            "count": len(spans.spans()) if spans is not None else 0,
        },
        "provenance": (provenance.snapshot() if provenance is not None
                       else {"records": [], "events": [], "summary": {}}),
        "alerts": (alerts.snapshot() if alerts is not None
                   else {"rules": [], "fired": [], "active": []}),
    }


def _fmt(v: float) -> str:
    if v != v:                      # NaN
        return "nan"
    if abs(v) >= 1e5 or (0 < abs(v) < 1e-3):
        return f"{v:.3g}"
    if float(v).is_integer() and abs(v) < 1e9:
        return str(int(v))
    return f"{v:.4g}"


#: Sections rendered by default; "terms" and "postmortem" are opt-in
#: (``--section``), "alerts" renders only when something fired.
DEFAULT_SECTIONS = ("series", "counters", "gauges", "histograms", "spans",
                    "alerts")
ALL_SECTIONS = DEFAULT_SECTIONS + ("terms", "postmortem")


def render(snap: dict[str, Any], width: int = 48,
           sections: tuple[str, ...] = DEFAULT_SECTIONS) -> str:
    """Terminal dashboard for a :func:`build_snapshot` payload."""
    out: list[str] = []
    meta = snap.get("meta") or {}
    if meta:
        out.append("== run: " + ", ".join(
            f"{k}={v}" for k, v in sorted(meta.items())))
    m = snap.get("metrics") or {}

    series = m.get("series") or {}
    if "series" in sections and series:
        out.append("-- per-round series " + "-" * (width + 6))
        name_w = max(len(n) for n in series)
        for name in sorted(series):
            v = series[name].get("v", [])
            if not v:
                continue
            spark = sparkline(v, width)
            out.append(
                f"{name:<{name_w}}  n={len(v):<5d} "
                f"min={_fmt(min(v)):>8} last={_fmt(v[-1]):>8} "
                f"max={_fmt(max(v)):>8}  {spark}")
            if series[name].get("dropped"):
                out.append(f"{'':<{name_w}}  ({series[name]['dropped']} "
                           "older points dropped from ring)")

    counters = m.get("counters") or {}
    if "counters" in sections and counters:
        out.append("-- counters")
        name_w = max(len(n) for n in counters)
        for name in sorted(counters):
            out.append(f"{name:<{name_w}}  {_fmt(counters[name])}")

    gauges = m.get("gauges") or {}
    if "gauges" in sections and gauges:
        out.append("-- gauges")
        name_w = max(len(n) for n in gauges)
        for name in sorted(gauges):
            out.append(f"{name:<{name_w}}  {_fmt(gauges[name])}")

    hists = m.get("histograms") or {}
    if "histograms" in sections and hists:
        out.append("-- histograms (seconds unless suffixed otherwise)")
        name_w = max(len(n) for n in hists)
        for name in sorted(hists):
            h = hists[name]
            out.append(
                f"{name:<{name_w}}  count={int(h['count']):<6d} "
                f"mean={_fmt(h['mean']):>9} p50={_fmt(h['p50']):>9} "
                f"p90={_fmt(h['p90']):>9} p99={_fmt(h['p99']):>9} "
                f"max={_fmt(h['max']):>9}")

    sp = (snap.get("spans") or {}).get("summary") or {}
    if "spans" in sections and sp:
        out.append("-- spans (wall-clock, retained window)")
        name_w = max(len(n) for n in sp)
        for name in sorted(sp, key=lambda n: -sp[n]["total_ms"]):
            st = sp[name]
            out.append(
                f"{name:<{name_w}}  count={int(st['count']):<6d} "
                f"total={st['total_ms']:>10.2f}ms "
                f"mean={st['mean_ms']:>8.3f}ms")
        if snap["spans"].get("dropped"):
            out.append(f"({snap['spans']['dropped']} older spans dropped "
                       "from ring)")

    al = snap.get("alerts") or {}
    fired = al.get("fired") or []
    if "alerts" in sections and (fired or al.get("active")):
        out.append("-- alerts (edge-triggered firings)")
        for a in fired:
            out.append(
                f"{a.get('severity', 'warn').upper():<5} "
                f"r{int(a.get('round', 0)):<5d} {a.get('rule')}: "
                f"{a.get('message')} "
                f"(value={_fmt(float(a.get('value', 0.0)))}, "
                f"threshold={_fmt(float(a.get('threshold', 0.0)))})")
        if al.get("active"):
            out.append("still active: " + ", ".join(al["active"]))

    prov = snap.get("provenance") or {}
    summary = prov.get("summary") or {}
    if "terms" in sections and summary:
        out.append("-- objective terms (per committed decision)")
        for ctl in sorted(summary):
            c = summary[ctl]
            out.append(f"{ctl}: {c.get('records', 0)} records, actions "
                       + ", ".join(f"{k}={v}" for k, v in
                                   sorted(c.get("actions", {}).items())))
            terms = c.get("terms") or {}
            if terms:
                name_w = max(len(n) for n in terms)
                for name in terms:           # ladder order preserved
                    tv = terms[name]
                    out.append(f"  {name:<{name_w}}  "
                               f"last={_fmt(tv['last']):>10} "
                               f"mean={_fmt(tv['mean']):>10}")
            if c.get("last_why"):
                out.append(f"  why: {c['last_why']}")
        if prov.get("dropped"):
            out.append(f"({prov['dropped']} older decision records "
                       "dropped from ring)")

    if "postmortem" in sections:
        from . import postmortem as _postmortem
        out.append(_postmortem.render_postmortem(snap, width=width))

    return "\n".join(out) if out else "(empty telemetry snapshot)"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Render a TELEMETRY_*.json snapshot as a terminal "
                    "dashboard.")
    ap.add_argument("path", help="snapshot JSON written by "
                                 "Telemetry.write_artifacts / run.py")
    ap.add_argument("--width", type=int, default=48,
                    help="sparkline width (chars)")
    ap.add_argument("--section", action="append", default=None,
                    choices=list(ALL_SECTIONS),
                    help="render only these sections (repeatable)")
    ap.add_argument("--fail-on-alerts", action="store_true",
                    help="exit 1 if any alert fired (CI gate)")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        snap = json.load(f)
    if "metrics" not in snap and "fired" in snap:
        # a bare ALERTS_*.json artifact: wrap it as a snapshot
        snap = {"meta": {}, "metrics": {}, "spans": {}, "alerts": snap,
                "provenance": {}}
    sections = tuple(args.section) if args.section else DEFAULT_SECTIONS
    try:
        print(render(snap, width=args.width, sections=sections))
    except BrokenPipeError:        # e.g. piped into `head`
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    if args.fail_on_alerts and (snap.get("alerts") or {}).get("fired"):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
