"""What the figure modules share: CSV/JSON evidence and claim checks."""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from pathlib import Path
from typing import Callable, Sequence

#: The repository root (``src/repro_torch/figures`` is three levels down).
ROOT = Path(__file__).resolve().parents[3]


def out_dir() -> Path:
    """Where the evidence goes: ``REPRO_BENCH_OUT``, else the git-ignored
    ``build/figures`` at the repository root."""
    env = os.environ.get("REPRO_BENCH_OUT")
    path = Path(env) if env else ROOT / "build" / "figures"
    path.mkdir(parents=True, exist_ok=True)
    return path


def write_csv(name: str, header: list[str], rows: list[list]) -> Path:
    path = out_dir() / name
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


def write_json(name: str, obj) -> Path:
    path = out_dir() / name
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    return path


class Bench:
    """One paper-figure reproduction: runs, records, checks its claims."""

    def __init__(self, name: str, paper_ref: str):
        self.name = name
        self.paper_ref = paper_ref
        self.checks: list[tuple[str, bool]] = []
        self.numbers: dict = {}
        self._t0 = time.perf_counter()

    def check(self, description: str, ok: bool) -> None:
        self.checks.append((description, bool(ok)))

    def finish(self) -> dict:
        ok = all(c[1] for c in self.checks)
        res = {
            "bench": self.name,
            "paper_ref": self.paper_ref,
            "ok": ok,
            "wall_s": time.perf_counter() - self._t0,
            "checks": [{"description": d, "ok": o} for d, o in self.checks],
            "numbers": self.numbers,
        }
        print(f"[{'PASS' if ok else 'FAIL'}] {self.name} ({self.paper_ref}) "
              f"{res['wall_s']:.1f}s", flush=True)
        for d, o in self.checks:
            print(f"    {'ok  ' if o else 'FAIL'} {d}", flush=True)
        return res


def main(benches: Sequence[Callable[..., dict]],
         argv: Sequence[str] | None = None, smoke: bool = False) -> int:
    """Run ``benches`` on the ``--device`` given (with ``smoke``, each
    also takes the ``--smoke`` flag as ``smoke=``); 0 when every check
    passed, else 1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    if smoke:
        ap.add_argument("--smoke", action="store_true",
                        help="the reference's reduced configuration")
    args = ap.parse_args(argv)
    kw = {"smoke": args.smoke} if smoke else {}
    if args.device == "cuda":
        import torch

        from ..device import resolve_device

        resolve_device("cuda")
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    results = [bench(args.device, **kw) for bench in benches]
    n_ok = sum(r["ok"] for r in results)
    n_checks = sum(len(r["checks"]) for r in results)
    n_pass = sum(c["ok"] for r in results for c in r["checks"])
    print(f"{n_ok}/{len(results)} figures passed ({n_pass}/{n_checks} "
          f"checks) on {args.device}")
    return 0 if n_ok == len(results) else 1
