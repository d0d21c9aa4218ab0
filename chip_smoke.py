#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--profile]

What it does, in order; any failure exits non-zero:

1. prints the card (``nvidia-smi`` name and power limit) and the
   torch/CUDA versions, and turns TF32 off for matmul and cuDNN;
2. builds every hand kernel from ``src/repro_torch/kernels/csrc`` into a
   fresh ``build/chip_smoke`` (one ``nvcc`` per source, started together)
   and prints the build times and the ptxas register/spill lines;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the control loop gives it (real inputs of paths A and B, plus
   random ones), with the JAX tests' tolerances;
4. path A: the container-sizing controller on the 8-tier e-commerce DAG's
   coarse menu (65,536 states), 12 rounds with a day -> evening drift of
   the request mix; whole-grid tables go through ``sizing_latency``;
5. path B: the rich menu (1,679,616 states, past the 200k tabulation cap)
   through ``SurrogateSource(n_probe=1024)``, 3 rounds; every table build
   interpolates the grid through ``fused_interp`` (206 launches);
6. times each kernel and its plain version with CUDA events at the path
   shapes, beside the least time the card could take (its bound);
7. prints one JSON line of kernel records, then the card line, then the
   result line ``{"ok": true, "device": {...}}`` last.

With ``--profile`` it also traces a few more rounds of each path with
``torch.profiler`` (after step 5) and prints the device's busy time and
idle share per round.

It exits with code 2 and prints no result when there is no CUDA device,
or when it stands in a directory without the rest of the repository.
The DAG and mixes are copied from ``benchmarks/container_sizing.py``
(lines 70-131), the reference package's container-sizing benchmark.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SIZING_TOL = dict(rtol=1e-5, atol=1e-7)      # tests/test_sizing.py:123-126
INTERP_TOL = dict(atol=2e-5, rtol=1e-4)      # tests/test_kernels.py:326-328

LAMBDA_COST = 0.5
SLO_PENALTY = 100.0
MIX_DAY = {"browse": 45.0, "search": 25.0, "checkout": 6.0}
MIX_EVENING = {"browse": 14.0, "search": 8.0, "checkout": 30.0}


def make_sizing_dag(ms):
    """The 8-tier e-commerce DAG of benchmarks/container_sizing.py."""
    tiers = (
        ms.ServiceTier("gateway", base_rate=70.0, gamma=0.8),
        ms.ServiceTier("auth", base_rate=90.0, gamma=0.7),
        ms.ServiceTier("search", base_rate=30.0, gamma=0.75,
                       mem_per_rps_gb=0.1),
        ms.ServiceTier("catalog", base_rate=45.0, gamma=0.75,
                       mem_per_rps_gb=0.08),
        ms.ServiceTier("orders", base_rate=40.0, gamma=0.7),
        ms.ServiceTier("product", base_rate=35.0, gamma=0.75),
        ms.ServiceTier("pricing", base_rate=100.0, gamma=0.8),
        ms.ServiceTier("inventory", base_rate=55.0, gamma=0.7),
    )
    edges = (
        ("gateway", "auth"), ("gateway", "search"), ("gateway", "catalog"),
        ("gateway", "orders"), ("search", "product"),
        ("catalog", "product"), ("orders", "pricing"),
        ("orders", "inventory"), ("product", "pricing"),
        ("product", "inventory"),
    )
    classes = (
        ms.RequestClass("browse", "gateway",
                        {"gateway": 1, "catalog": 1, "product": 2,
                         "pricing": 2, "inventory": 1}, slo_s=0.25),
        ms.RequestClass("search", "gateway",
                        {"gateway": 1, "search": 1, "product": 1,
                         "pricing": 1}, slo_s=0.28),
        ms.RequestClass("checkout", "gateway",
                        {"gateway": 1, "auth": 1, "orders": 1, "pricing": 1,
                         "inventory": 2}, slo_s=0.40),
    )
    return ms.MicroserviceDAG(tiers, edges, classes)


def make_specs(sz, ms):
    """(small, large): the coarse menu of path A, the rich one of path B."""
    small = sz.SizingSpace(
        make_sizing_dag(ms),
        sizes=(ms.ContainerSize("small", 1, 2.0),
               ms.ContainerSize("large", 4, 8.0)),
        replica_counts=(1, 2), lambda_cost=LAMBDA_COST,
        slo_penalty=SLO_PENALTY)
    large = sz.SizingSpace(
        make_sizing_dag(ms),
        sizes=(ms.ContainerSize("small", 1, 2.0),
               ms.ContainerSize("medium", 2, 4.0),
               ms.ContainerSize("large", 4, 8.0)),
        replica_counts=(1, 2), lambda_cost=LAMBDA_COST,
        slo_penalty=SLO_PENALTY)
    return small, large


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    print(("ok    " if ok else "FAIL  ") + msg, flush=True)
    if not ok:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(torch, fn, iters: int, warm: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, from
    CUDA events around the whole run, after ``warm`` calls.  The device is
    first parked in a spin kernel for twice the host's measured enqueue
    time of the run, so the events see the calls back to back and not the
    host's launch overhead between them."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    host_s = (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0 * host_s * iters * 2.0e9) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profile_rounds(torch, ctrl, n: int, label: str,
                   untraced_ms: float) -> None:
    """Trace ``n`` more rounds of ``ctrl`` with torch.profiler and print
    the device's busy time per round (its kernels and copies), its idle
    share against ``untraced_ms`` (the round's wall time without the
    profiler), device operations per round, and the top device-time ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ctrl.round()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print(f"profile {label}: no device time in the trace (not measured)")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3 / n
    print(f"profile {label}: {n} rounds, device busy {busy_ms:.3f} ms/round,"
          f" {sum(r[1] for r in rows) / n:.0f} device ops/round; idle share "
          f"{1 - busy_ms / untraced_ms:.4f} of the untraced round "
          f"({untraced_ms:.2f} ms; {traced_ms:.2f} ms traced)")
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        print(f"    {dev_us / 1e3 / n:8.4f} ms/round {count / n:6.1f}x  "
              f"{key[:72]}")


def compare(torch, name, outputs, got, want, tol) -> float:
    """Max abs error of kernel outputs ``got`` against plain ``want``;
    fails unless every pair is allclose at ``tol``."""
    err = 0.0
    for out, g, w in zip(outputs, got, want):
        ok = torch.allclose(g, w, **tol)
        e = float((g - w).abs().max())
        err = max(err, e)
        check(ok, f"{name} {out}: max abs err {e:.3e} within {tol}")
    return err


def main(argv: list[str]) -> int:
    profile = "--profile" in argv
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: no src/repro_torch beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()

    # -- 1. the card --------------------------------------------------------
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda")

    # -- 2. build the kernels from the checkout's sources -------------------
    build_dir = ROOT / "build" / "chip_smoke"
    shutil.rmtree(build_dir, ignore_errors=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build_dir)
    from repro_torch.kernels import build, ops, ref

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(build.build_log)} in {build_s:.2f} s (parallel)")
    check(set(build.build_log) == set(build.SOURCES),
          "every kernel source was built in this run")
    for name, (secs, log) in sorted(build.build_log.items()):
        print(f"  {name}: nvcc {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    from repro_torch.core import sizing as sz
    from repro_torch.core.surrogate import (
        MeasurementStore,
        SpaceEncoding,
        SurrogateSource,
    )
    from repro_torch.workloads import microservice as ms

    small, large = make_specs(sz, ms)
    records = {}

    # -- 3. each kernel against its plain version, on the card --------------
    f32 = torch.float32
    rates_day = torch.tensor(small.dag.rates_array(MIX_DAY), dtype=f32,
                             device=dev)
    grid_a = small.grid_candidates(dev)
    sl_args = small.kernel_inputs(grid_a, rates_day)      # path A's rows
    B, K = sl_args[0].shape
    c_max = small.c_max
    errs = [compare(torch, f"sizing_latency path A ({B}x{K}, c_max "
                           f"{c_max})", ("sojourn", "path"),
                    ops.sizing_latency(*sl_args, c_max=c_max),
                    ref.sizing_latency_ref(*sl_args, c_max=c_max),
                    SIZING_TOL)]
    gen = torch.Generator(device=dev).manual_seed(0)
    for (b, k, c) in [(B, K, c_max), (64, 10, 6)]:
        mu = 5.0 + 55.0 * torch.rand((b, k), generator=gen, device=dev)
        repl = torch.randint(1, c + 1, (b, k), generator=gen,
                             device=dev).to(f32)
        lam = (0.05 + 1.15 * torch.rand((b, k), generator=gen, device=dev)) \
            * mu * repl
        w = 2.0 * torch.rand((b, k), generator=gen, device=dev)
        adj = torch.triu(torch.rand((k, k), generator=gen, device=dev) < 0.4,
                         1)
        errs.append(compare(
            torch, f"sizing_latency random ({b}x{k}, c_max {c})",
            ("sojourn", "path"),
            ops.sizing_latency(lam, mu, repl, w, adj, c_max=c),
            ref.sizing_latency_ref(lam, mu, repl, w, adj, c_max=c),
            SIZING_TOL))
    records["sizing_latency"] = {"max_abs_err": max(errs)}

    # path B's chunk: 1,024 probes of the rich menu against the first
    # 8,192 grid states, as SurrogateModel.predict hands them over
    enc_b = SpaceEncoding.from_space(large.space)
    probes = SurrogateSource(n_probe=1024, seed=3)._probe_states(
        large.space, None)
    store = MeasurementStore(len(large.space.shape))
    for s in probes:
        store.add(s, float(large.host_objective(
            large.space.decode([int(i) for i in s]), MIX_DAY)["y"]), 0.0)
    obs, ys, _ = store.arrays()
    M = len(obs)
    check(M == 1024, f"path B store holds {M} probes")
    xm_b = torch.as_tensor(enc_b.features(obs), device=dev)
    y_b = torch.as_tensor(ys, dtype=f32, device=dev)
    w_b = torch.ones(M, dtype=f32, device=dev)
    grid_b = sz.full_grid(large.space)
    xq_b = torch.as_tensor(enc_b.features(grid_b[:8192]), device=dev)
    Q, F = xq_b.shape
    fi_real = (xq_b, xm_b, y_b, w_b)
    errs = []
    for kind in ("idw", "rbf"):
        errs.append(compare(
            torch, f"fused_interp path B {kind} ({Q}x{M}x{F}; y up to "
                   f"{float(y_b.max()):.3g})", ("mean", "dmin"),
            ops.fused_interp(*fi_real, kind=kind),
            ref.fused_interp_ref(*fi_real, kind=kind), INTERP_TOL))
    fi_rand = (torch.randn((Q, F), generator=gen, device=dev),
               torch.randn((M, F), generator=gen, device=dev),
               torch.randn((M,), generator=gen, device=dev),
               0.1 + 0.9 * torch.rand((M,), generator=gen, device=dev))
    for kind in ("idw", "rbf"):
        errs.append(compare(
            torch, f"fused_interp random {kind} ({Q}x{M}x{F})",
            ("mean", "dmin"),
            ops.fused_interp(*fi_rand, kind=kind),
            ref.fused_interp_ref(*fi_rand, kind=kind), INTERP_TOL))
    records["fused_interp"] = {"max_abs_err": max(errs)}
    torch.cuda.synchronize()

    # -- 4. path A: coarse menu, drifting mix, whole-grid tables ------------
    n_a, change_at = 12, 4
    opt = {k: float(sz.sizing_table_device(small, m, device=dev).min())
           for k, m in (("day", MIX_DAY), ("evening", MIX_EVENING))}
    sched = ms.DriftingMix(MIX_DAY, MIX_EVENING, change_at=change_at)
    ctrl_a = sz.SizingController(small, sched, steps_per_round=64,
                                 n_chains=16, seed=0, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    round_s_a = []
    ds_a = []
    for _ in range(n_a):
        t0 = time.perf_counter()
        ds_a.append(ctrl_a.round())
        torch.cuda.synchronize()
        round_s_a.append(time.perf_counter() - t0)
    launches_a = dict(ops.LAUNCHES)
    print(f"path A: {small.space.size():,} states, {n_a} rounds, launches "
          f"{launches_a}, round wall s {[round(s, 4) for s in round_s_a]}")
    for d in ds_a:
        print(f"  round {d.n:2d} y {d.y:.6f} $/hr {d.usd_per_hr:.3f} "
              f"slo {d.slo_attainment:.3f} cores {d.config.total_cores}"
              f"{' reheated' if d.reheated else ''}")
    check(launches_a["sizing_latency"] > 0,
          f"path A launched sizing_latency "
          f"{launches_a['sizing_latency']} times")
    check(all(d.y == small.host_objective(d.sizing, sched.at(d.n))["y"]
              for d in ds_a),
          "every path-A decision's y is the numpy ground truth at its "
          "sizing")
    check(all(d.slo_attainment == 1.0 for d in ds_a[3:]),
          "path A SLO attainment 1.0 after the 3 warm-up rounds")
    check(ds_a[change_at - 1].y <= 1.25 * opt["day"]
          and ds_a[-1].y <= 1.25 * opt["evening"],
          f"path A within 1.25x of the grid optimum before and after the "
          f"drift ({ds_a[change_at - 1].y:.4f} vs {opt['day']:.4f}, "
          f"{ds_a[-1].y:.4f} vs {opt['evening']:.4f})")

    # -- 5. path B: rich menu through the surrogate -------------------------
    n_b = 3
    src_b = SurrogateSource(n_probe=1024, seed=3, device="cuda")
    ctrl_b = sz.SizingController(large, MIX_DAY, objective_source=src_b,
                                 steps_per_round=64, n_chains=16, seed=3,
                                 device="cuda")
    y_cold = float(large.host_objective(
        large.space.decode(ctrl_b.incumbent), MIX_DAY)["y"])
    torch.cuda.synchronize()
    ops.reset_launches()
    round_s_b = []
    ds_b = []
    for _ in range(n_b):
        t0 = time.perf_counter()
        ds_b.append(ctrl_b.round())
        torch.cuda.synchronize()
        round_s_b.append(time.perf_counter() - t0)
    launches_b = dict(ops.LAUNCHES)
    builds = len(ctrl_b._tables)
    per_build = -(-large.space.size() // 8192)
    print(f"path B: {large.space.size():,} states, {n_b} rounds, "
          f"{builds} table build(s), launches {launches_b}, round wall s "
          f"{[round(s, 4) for s in round_s_b]}, measures {src_b.counts()}")
    for d in ds_b:
        print(f"  round {d.n:2d} y {d.y:.6f} $/hr {d.usd_per_hr:.3f} "
              f"slo {d.slo_attainment:.3f}")
    check(builds >= 1 and launches_b["fused_interp"] >= per_build * builds,
          f"path B launched fused_interp {launches_b['fused_interp']} times "
          f"for {builds} table build(s) (>= {per_build} each)")
    check(src_b.true_measures == 1024,
          f"path B probed {src_b.true_measures} real states")
    check(all(d.y == large.host_objective(d.sizing, MIX_DAY)["y"]
              for d in ds_b),
          "every path-B decision's y is the numpy ground truth")
    check(ds_b[-1].y < y_cold,
          f"path B improves the cold-start deployment ({y_cold:.4g} -> "
          f"{ds_b[-1].y:.4g})")

    if profile:
        profile_rounds(torch, ctrl_a, 4, "path A (table cached)",
                       1e3 * sum(round_s_a[1:]) / (n_a - 1))
        profile_rounds(torch, ctrl_b, 2, "path B (table cached)",
                       1e3 * sum(round_s_b[1:]) / (n_b - 1))

    # -- 6. times at the path shapes ----------------------------------------
    nb = sum(t.numel() * t.element_size() for t in sl_args) \
        + 2 * B * K * 4
    edges = int(sl_args[4].sum())
    # per row: c_max Erlang-B steps (4 ops) + ~12 for the sojourn, per
    # tier; K relaxation steps over the E edges and K nodes (2 ops each)
    nops = B * (K * (4 * c_max + 12) + K * (edges + 2 * K))
    sl_bound = max(nb / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
    records["sizing_latency"].update(
        ms=time_ms(torch, lambda: ops.sizing_latency(*sl_args, c_max=c_max),
                   200),
        plain_ms=time_ms(torch, lambda: ref.sizing_latency_ref(
            *sl_args, c_max=c_max), 20),
        bound_ms=sl_bound,
        bound_by="bytes" if nb / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S
        else "operations")
    nb = sum(t.numel() * 4 for t in fi_real) + 2 * Q * 4
    # per pair: the 2F-op dot product, the expansion (3), the IDW weight
    # (2), the recency weight (1), the two running sums (3), the min (1);
    # plus the 2F-op norms of every row
    nops = Q * M * (2 * F + 10) + (Q + M) * 2 * F
    fi_bound = max(nb / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
    records["fused_interp"].update(
        ms=time_ms(torch, lambda: ops.fused_interp(*fi_real), 200),
        plain_ms=time_ms(torch, lambda: ref.fused_interp_ref(*fi_real), 20),
        bound_ms=fi_bound,
        bound_by="bytes" if nb / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S
        else "operations")
    for name, rec in records.items():
        print(f"{name}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
              f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"library none")
    print(f"path A mean round {sum(round_s_a[1:]) / (n_a - 1):.4f} s "
          f"(rounds 1-{n_a - 1}), path B round 0 (table build) "
          f"{round_s_b[0]:.3f} s, later rounds "
          f"{sum(round_s_b[1:]) / max(n_b - 1, 1):.4f} s")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    # -- 7. the record lines --------------------------------------------------
    meta = {
        "sizing_latency": ("src/repro_torch/kernels/csrc/sizing_latency.cu",
                           "src/repro/kernels/sizing_latency.py:124",
                           launches_a["sizing_latency"]),
        "fused_interp": ("src/repro_torch/kernels/csrc/fused_interp.cu",
                         "src/repro/kernels/surrogate_distance.py:162",
                         launches_b["fused_interp"]),
    }
    kernels = []
    for name, (source, replaces, launches) in meta.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
