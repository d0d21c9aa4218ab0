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
   shapes its path gives it (real inputs of paths A and B; the serve
   paths' prefill and decode shapes for the attention kernels, hd 128
   with 4 query heads per kv head and hd 256 with 10; path D's and
   qwen3-8b's training head layout for the attention backward; paths E's
   and F's prefills for ``rglru_scan`` and ``wkv6``; path B's probes and
   grid chunk for ``pairwise_sqdist``), plus random ones (every mask kind,
   softcap, ragged lengths, float32, up to 16 query heads per kv head;
   rows of up to 32,768 for ``quantize_int8`` and ragged scans for
   ``rglru_scan``, both bit-equal; initial states and strided inputs for
   ``wkv6``), with the JAX tests' tolerances; and the bf16 attention
   kernels' score sums (tensor cores plus the exact-sum fallback) against
   cuBLAS's float32 product, score by score;
4. path A: the container-sizing controller on the 8-tier e-commerce DAG's
   coarse menu (65,536 states), 12 rounds with a day -> evening drift of
   the request mix; whole-grid tables go through ``sizing_latency``, and
   each round's chains walk in one ``anneal_walk`` launch;
5. path B: the rich menu (1,679,616 states, past the 200k tabulation cap)
   through ``SurrogateSource(n_probe=1024)``, 3 rounds; every table build
   interpolates the grid through ``fused_interp`` (206 launches), one
   ``anneal_walk`` a round;
5b. path G, the paper's procurement loop: (a) ``anneal_walk`` bit-equal
   to its plain version on paths A's and B's real inputs, Fig. 4's and
   Fig. 5's tables, a noisy chain, per-chain tables with extra rows and a
   valid mask, 16 axes and C = 1, 33, 1,024; (b) both figure modules
   (``repro_torch.figures``: Figs. 2-5 and 6-11) on the card, every check
   passing, ``fig4_engine_speedup``'s >= 10x included; (c)
   ``ProcurementController`` on the paper's EC2 space with the
   quickstart's blend: ``plan()`` through the exhaustive table and
   through ``SurrogateSource`` (each planned y within 1.02x of its table's
   valid minimum, one ``anneal_walk`` launch a plan), then 300 jobs; (d)
   ``fleet_chains`` at 1,000 tenants (bucket 1,024) x 32 steps with
   per-tenant tables and extra rows, rows 0..999 bit-equal unpadded;
5c. path H, the multi-tenant fleet (``repro_torch.figures.trace_fleet``'s
   controller, the reference's constants): (a) its smoke replay, 64
   tenants over 600 s of the trace ``BENCH_trace.json`` holds, on the
   card (SLO attainment 1.0, no violation round, as the reference's) and
   on the host in the same process, the two FleetDecision logs equal
   field for field; (b) 1,024 tenants over 3,600 s and the 64-tenant
   baseline over the same horizon, five turns of each in alternation: no
   violation in the final quarter, SLO attainment >= 0.8, < 60% of
   tenant-rounds annealed, the wall time (each size's fastest turn)
   <= half the 16x tenant ratio; in both, one ``anneal_walk`` launch in
   each round that annealed a chain (none in the others) and at most one
   synchronizing call a round (the read-back), counted by torch's sync
   debug mode while the replay runs;
6. path C: the annealed serve loop (``repro_torch.serving.anneal``) on
   qwen3-8b at its full width and depth (36 layers, random bf16 weights
   from a seed): 6 rounds of 24 requests of 512 tokens, 16 new tokens
   each, batch menu (1, 2, 4, 8, 16); checks every request's tokens and
   that ``flash_attention`` ran 36 times per prefill and ``flash_decode``
   36 times per decode step; then the same loop for 3 rounds on
   recurrentgemma-2b (path E: 26 layers, 8 x (R, R, A) + (R, R); 18
   ``rglru_scan`` and 8 ``flash_attention`` launches per prefill, 8
   ``flash_decode`` per decode step) and on rwkv6-7b (path F: 32 layers;
   32 ``wkv6`` launches per prefill), each model freed before the next;
7. path D: training repro-100m at its full size (12 layers, d 768, 163.6 M
   parameters, random from seed 0) through ``repro_torch.launch.train``
   (batch 8 x 256, int8 compression, 2 microbatches, block remat) for 100
   steps with checkpoints, checking that the loss drops and that every
   step launched ``quantize_int8`` once per parameter tensor (111),
   ``flash_attention`` 48 times (12 layers x 2 microbatches, twice with
   the remat) and its backward 24 times; the quantizer on the run's real
   gradients; then ``repro_torch.launch.train_anneal`` (microbatches x
   remat annealed on measured step times) for 10 rounds of 10 steps;
8. a 2-layer model at qwen3-8b's full width, a 3-layer (R, R, A)
   recurrentgemma-2b and a 2-layer rwkv6-7b, through the kernels on the
   card and with the same weights through the plain path on the host
   (prompt 128, batch 2, 4 teacher-forced decode steps): with the weights
   in float32 the logits agree at the float32 tolerance, and in bf16 the
   card's gap to the host is within the host's own bf16-vs-float32 gap;
   a 2-layer model at repro-100m's full width through one train step on
   both (loss, gradients and new parameters in float32; gradients in bf16
   within the host's own gap); and one train step of a 2-layer qwen3-8b
   at full width (1 x 4096 tokens) on the card alone;
9. times each kernel and its plain version with CUDA events at the path
   shapes (the attention kernels also at PREFILL_32K and DECODE_32K with
   the batch cut and at path E's hd-256 shapes, the forward also at path
   D's training microbatch, the backward also at qwen3-8b's training head
   layout; every kernel with a cold L2, ``time_cold_ms``), beside the
   least time the card could take (its bound, and the share of the
   kernel's time it is), the kernel's achieved bytes/s, ``flash_decode``'s
   split count, and the library's time on the same inputs where one
   PyTorch call computes the function: ``scaled_dot_product_attention``
   forward or backward for attention, ``torch.cdist`` squared for
   ``pairwise_sqdist`` (timed only; the port never calls them); and
   ``pairwise_sqdist`` beside the card's own write of its (Q, M) result
   (``fill_``, cold and warm), the floor of a write-bound kernel; and
   ``anneal_walk`` at path A's round, Fig. 4's sweep, ``fleet_chains``'
   bucket, path B's round and path H's largest round (its fleet bucket)
   on the inputs those paths gave it, its bytes counted from what
   each walk looked up, beside its latency bound (S dependent loads at
   the latency a one-thread pointer chase measures on the card, the
   probe ``kernels/probes/dependent_load.cu``) and the time of its first
   chain alone (the serial chain of S steps);
10. prints one JSON line of kernel records (each with every timed shape
   under ``shapes``), then the card line, then the result line
   ``{"ok": true, "device": {...}}`` last.

With ``--profile`` it also traces a few more rounds of paths A and B with
``torch.profiler`` (after step 5) and one path-B table build (206
``fused_interp`` launches; its wall time, device busy time, idle share and
``fused_interp``'s share of the device time), one burst of paths C's, E's
and F's workloads at batch 16 (in step 6), the first 8 ticks of path H's
1,024-tenant replay (in step 5c) and three path-D train steps (in step
7), and prints the device's busy time and idle share of each.

It exits with code 2 and prints no result when there is no CUDA device,
or when it stands in a directory without the rest of the repository.
The DAG and mixes are copied from ``benchmarks/container_sizing.py``
(lines 70-131), the reference package's container-sizing benchmark.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores, bf16 on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

SIZING_TOL = dict(rtol=1e-5, atol=1e-7)      # tests/test_sizing.py:123-126
INTERP_TOL = dict(atol=2e-5, rtol=1e-4)      # tests/test_kernels.py:326-328
# tests/test_kernels.py:17-18; the attention kernels round scores and
# weights where their plain versions (the model's math) do, but sum in
# another order and take exp on the card
BF16_TOL = dict(atol=0.03, rtol=0.05)
F32_TOL = dict(atol=2e-5, rtol=1e-4)
WKV_TOL = dict(atol=5e-4, rtol=1e-3)         # tests/test_kernels.py:185-201
SQDIST_TOL = dict(atol=1e-4, rtol=1e-4)      # tests/test_surrogate.py:54-66

# path C's workload: the defaults of ``python -m repro_torch.serving.anneal``;
# paths E and F serve the same bursts for fewer rounds
SERVE_PROMPT, SERVE_NEW, SERVE_REQUESTS, SERVE_ROUNDS = 512, 16, 24, 6
RECURRENT_ROUNDS = 3
# path D's: ``python -m repro_torch.launch.train`` at the reference's
# defaults (batch 8, seq 256) with int8 compression, 2 microbatches and
# block remat; then ``launch.train_anneal`` (batch 4), shortened
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 100, 8, 256, 2
ANNEAL_ROUNDS, ANNEAL_EVERY = 10, 10

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


def profile_rounds(torch, ctrl, n: int, label: str, untraced_ms: float,
                   share_of: str | None = None) -> None:
    """Trace ``n`` more rounds of ``ctrl`` with torch.profiler and print
    the device's busy time per round (its kernels and copies), its idle
    share against ``untraced_ms`` (the round's wall time without the
    profiler), device operations per round, the top device-time ops and
    the port's own kernels; with ``share_of``, that kernel's share of the
    device time."""
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
    if share_of is not None:
        mine = [r for r in rows if share_of + "_kernel" in r[2]]
        own_ms = sum(r[0] for r in mine) / 1e3 / n
        print(f"profile {label}: {share_of} {own_ms:.3f} ms/round over "
              f"{sum(r[1] for r in mine) / n:.0f} launches, "
              f"{own_ms / busy_ms:.4f} of the device time")
    ranked = sorted(rows, reverse=True)
    # the six largest, then the port's own kernels wherever they rank
    for rank, (dev_us, count, key) in enumerate(ranked):
        if rank < 6 or key.split("(anonymous namespace)::")[0] in (
                "", "void "):
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


def time_cold_ms(torch, fn, iters: int, warm: int = 2,
                 flush_bytes: int = 256 << 20) -> float:
    """Mean device time of one ``fn()`` call found with a cold L2 cache, as
    a call between other layers' work finds it: a 256 MB buffer is written
    before each call, and CUDA events around each call time it alone.  The
    device is parked in a spin kernel while the calls are enqueued, so the
    host's overhead between calls is not in the events' intervals."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    stops = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(int(min(2.0 * host_s * iters, 2.0) * 2.0e9) + 1_000_000)
    for a, b in zip(starts, stops):
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, stops)) / iters


def profile_serve(torch, config, batch: int) -> None:
    """Trace one burst of the serve paths' workload on ``config`` served at
    ``batch`` (a prefill and its decode steps per batch) with
    torch.profiler; prints the device's busy time and idle share of the
    burst."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import generator
    from repro_torch.models.transformer import init_model
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step
    from repro_torch.serving import Request, ServeEngine

    with torch.no_grad():
        params = init_model(generator(0, device="cuda"), config)
    shape = ShapeConfig("serve", SERVE_PROMPT + SERVE_NEW + 1, batch,
                        "decode")
    eng = ServeEngine(params, build_prefill_step(config, shape),
                      build_decode_step(config, shape), max_batch=batch,
                      prompt_len=SERVE_PROMPT)
    rng = np.random.default_rng(0)

    class Burst:
        def round(self):
            for i in range(SERVE_REQUESTS):
                eng.submit(Request(rid=i, prompt=rng.integers(
                    0, config.vocab, SERVE_PROMPT, dtype=np.int32),
                    max_new=SERVE_NEW))
            eng.drain()
            eng.results.clear()

    burst = Burst()
    burst.round()                          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    burst.round()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    profile_rounds(torch, burst, 1, f"{config.name} burst at batch {batch}",
                   untraced_ms)
    del eng, params
    torch.cuda.empty_cache()


def check_attention_kernels(torch, ops, ref, dev) -> dict[str, float]:
    """Each attention kernel against its plain version on the card: at the
    serve path's shapes, then random shapes covering every mask kind,
    softcap, ragged lengths and float32.  Returns the max abs errors."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)) \
            .to(dtype)

    def tol(dtype):
        return BF16_TOL if dtype == torch.bfloat16 else F32_TOL

    errs = {"flash_attention": [], "flash_decode": []}
    cases = [  # (label, B, Sq, Sk, H, K, hd, kind, window, softcap, dtype)
        ("serve prefill", 16, SERVE_PROMPT, SERVE_PROMPT, 32, 8, 128,
         "causal", 0, 0.0, torch.bfloat16),
        ("path E prefill", 16, SERVE_PROMPT, SERVE_PROMPT, 10, 1, 256,
         "window", 2048, 0.0, torch.bfloat16),
        ("hd 256 ragged window", 2, 333, 333, 10, 1, 256, "window", 100,
         0.0, torch.bfloat16),
        ("hd 256 float32", 1, 300, 300, 4, 2, 256, "causal", 0, 0.0,
         torch.float32),
        ("hd 200 softcap", 1, 130, 130, 6, 2, 200, "causal", 0, 30.0,
         torch.bfloat16),
        ("ragged window", 2, 333, 333, 8, 2, 128, "window", 100, 0.0,
         torch.bfloat16),
        ("ragged chunk", 2, 333, 333, 8, 2, 128, "chunk", 128, 0.0,
         torch.bfloat16),
        ("bidir", 2, 256, 256, 8, 8, 64, "bidir", 0, 0.0, torch.bfloat16),
        ("cross", 2, 77, 300, 8, 2, 128, "cross", 0, 0.0, torch.bfloat16),
        ("softcap", 2, 256, 256, 8, 2, 128, "causal", 0, 30.0,
         torch.bfloat16),
        ("float32", 1, 200, 200, 4, 1, 64, "causal", 0, 0.0, torch.float32),
    ]
    for label, B, Sq, Sk, H, K, hd, kind, window, softcap, dt in cases:
        q, k, v = rnd((B, Sq, H, hd), dt), rnd((B, Sk, K, hd), dt), \
            rnd((B, Sk, K, hd), dt)
        kw = dict(kind=kind, window=window, softcap=softcap)
        errs["flash_attention"].append(compare(
            torch, f"flash_attention {label} (B {B}, Sq {Sq}, Sk {Sk}, "
                   f"H {H}/K {K}, hd {hd}, {kind}, {str(dt)[6:]})", ("out",),
            (ops.flash_attention(q, k, v, **kw).float(),),
            (ref.flash_attention_ref(q, k, v, **kw).float(),), tol(dt)))
    W = SERVE_PROMPT + SERVE_NEW + 1
    cases = [  # (label, B, W, K, G, hd, valid slots, softcap, dtype)
        ("serve step", 16, W, 8, 4, 128, W - 3, 0.0, torch.bfloat16),
        ("path E step", 16, W, 1, 10, 256, W - 3, 0.0, torch.bfloat16),
        ("G 16 hd 256", 2, 700, 2, 16, 256, None, 0.0, torch.bfloat16),
        ("G 13 hd 128 softcap", 2, 300, 1, 13, 128, None, 30.0,
         torch.bfloat16),
        ("G 12 hd 64", 3, 100, 2, 12, 64, None, 0.0, torch.bfloat16),
        ("G 10 hd 256 float32", 2, 200, 1, 10, 256, None, 0.0,
         torch.float32),
        ("random mask, softcap", 3, 1000, 2, 8, 128, None, 30.0,
         torch.bfloat16),
        ("float32", 2, 300, 4, 4, 64, None, 0.0, torch.float32),
    ]
    for label, B, W_, K, G, hd, n_valid, softcap, dt in cases:
        q = rnd((B, 1, K * G, hd), dt)
        kc, vc = rnd((B, W_, K, hd), dt), rnd((B, W_, K, hd), dt)
        if n_valid is None:
            valid = torch.rand((B, W_), generator=gen, device=dev) < 0.6
            valid[:, 0] = True
        else:
            valid = (torch.arange(W_, device=dev) < n_valid)[None] \
                .expand(B, W_).contiguous()
        errs["flash_decode"].append(compare(
            torch, f"flash_decode {label} (B {B}, W {W_}, K {K}, G {G}, "
                   f"hd {hd}, {str(dt)[6:]})", ("out",),
            (ops.flash_decode(q, kc, vc, valid, softcap=softcap).float(),),
            (ref.flash_decode_ref(q, kc, vc, valid,
                                  softcap=softcap).float(),), tol(dt)))
    torch.cuda.synchronize()
    return {name: max(e) for name, e in errs.items()}


def check_exact_sums(torch, ops, dev) -> None:
    """The bf16 attention kernels' score sums (``ops.attention_score_sums``,
    the forward's tensor-core sums and exact-sum fallback for one head)
    against a plain float32 product, on 4,096 x 4,096 random scores at hd
    64 and 128: the sequential sums equal cuBLAS's bit for bit, the
    tensor-core sums lie within the fallback's tolerance (16 x 2^-24 |q|
    |k|) of them, and after the fallback every score rounds to bf16 as
    cuBLAS's does.  Prints how many tensor-core sums alone round
    otherwise, how many the fallback takes again, and the largest
    |t - seq| in units of 2^-24 sum_d |q_d k_d|."""
    gen = torch.Generator(device=dev).manual_seed(5)
    S = 4096
    for hd in (64, 128):
        q = torch.randn((S, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((S, hd), generator=gen, device=dev).bfloat16()
        t, fixed, seq = ops.attention_score_sums(q, k)
        plain = q.float() @ k.float().T
        qn, kn = q.float().norm(dim=1), k.float().norm(dim=1)
        tol = 16.0 * 2.0 ** -24 * qn[:, None] * kn[None, :]
        units = (t - seq).abs() / (2.0 ** -24 * (q.float().abs()
                                                 @ k.float().abs().T))
        raw = int((t.bfloat16() != plain.bfloat16()).sum())
        retaken = int((fixed != t).sum())
        left = int((fixed.bfloat16() != plain.bfloat16()).sum())
        check(torch.equal(seq, plain) and left == 0
              and bool(((t - seq).abs() <= tol).all()),
              f"exact sums, hd {hd}, {S * S:,} scores: sequential sums equal "
              f"cuBLAS's; tensor-core sums round otherwise at {raw} "
              f"({raw / S / S:.2e}), {retaken} ({retaken / S / S:.2e}) taken "
              f"again, {left} left; max |t - seq| "
              f"{float(units.max()):.2f} x 2^-24 sum|q k| (tolerance 16 x "
              f"2^-24 |q| |k|)")
        del q, k, t, fixed, seq, plain, tol, units
    torch.cuda.empty_cache()


def serve_path(torch, ops, config, label: str, rounds: int
               ) -> tuple[dict, dict]:
    """The annealed serve loop at ``config``'s full width and depth for
    ``rounds`` rounds; checks every round's tokens and each kernel's
    launches per prefill (one ``flash_attention``, ``rglru_scan`` or
    ``wkv6`` per layer of its kind) and per decode step (one
    ``flash_decode`` per attention layer), and that nothing else launched.
    Returns (the loop's result, the launches of the whole run)."""
    from repro_torch.serving.anneal import anneal_serving

    kinds = [lk.kind for lk in config.layers]
    per_prefill = {"flash_attention": kinds.count("dense"),
                   "rglru_scan": kinds.count("rglru"),
                   "wkv6": kinds.count("rwkv")}
    per_step = {"flash_decode": kinds.count("dense")}

    def show(rec):
        print(f"  round {rec['round']} batch {rec['batch']:2d} mean sojourn "
              f"{rec['mean_sojourn_s']:.4f} s ({rec['batches']} batches, "
              f"{rec['decode_steps']} decode steps, {rec['wall_s']:.3f} s) "
              f"launches {rec['launches']}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = anneal_serving(config, device="cuda", seed=0,
                         prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
                         requests=SERVE_REQUESTS, rounds=rounds,
                         on_round=show)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"path {label}: {config.name} ({config.param_count() / 1e9:.2f} B "
          f"parameters, {config.n_layers} layers), init {out['init_s']:.2f} "
          f"s, {rounds} rounds in {wall:.1f} s, best batch "
          f"{out['best_batch']} (mean sojourn {out['best_sojourn_s']:.4f} "
          f"s), launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    recs = out["rounds"]
    check(all(r["tokens_ok"] for r in recs),
          f"path {label}: every request got its {SERVE_NEW} tokens in every "
          f"round")
    for r in recs:
        want = {k: 0 for k in launches}
        want.update({k: n * r["batches"] for k, n in per_prefill.items()})
        want["flash_decode"] = per_step["flash_decode"] * r["decode_steps"]
        check(r["launches"] == want,
              f"path {label} round {r['round']}: launches {per_prefill} per "
              f"prefill and {per_step} per decode step, nothing else")
    return out, launches


def whole_model_check(torch, config, n_layers: int = 2) -> float:
    """An ``n_layers``-layer model at ``config``'s full width: prefill
    (prompt 128, batch 2) and 4 decode steps through the kernels on the
    card, then the same weights through the plain path on the host, the
    decode steps teacher-forced with the card's tokens.

    In bf16, two correct implementations differ wherever a float32 sum
    lands near a bf16 rounding boundary in one and not the other, and a
    flipped attention score (scores here have a standard deviation near
    11, so the softmax is sharp) moves a whole hidden state: the card's
    logits differ from the host's by a few hundredths at this width (see
    PERF.md).  So the weights are also cast to float32 and run on both
    sides, where no rounding hides a fault: the two implementations must
    agree at the float32 tolerance.  The recurrent models still round
    some state to bf16 where the reference does (recurrentgemma's conv
    state after the prefill, rwkv's token-shift states every step), and
    float32 noise at such a rounding moves a state element by a whole bf16
    step, which moves the next logits past the float32 tolerance (4.196e-05
    at recurrentgemma-2b's first decode step with these weights).  So in
    float32 a second host run starts each decode step from the card's
    cache as it was before that step, and every cache is compared too:
    float32 state at the float32 tolerance (rwkv's wkv state at the
    ``wkv6`` kernel's, atol 5e-4 / rtol 1e-3: the card sums it in another
    order), bf16 state within the float32 tolerance plus one bf16 step
    (what rounding two such float32 values can leave).  In bf16 the two sides run on their own, and the card's gap to
    the host must be no larger than the host's own gap between its bf16
    and (free-running) float32 runs, or
    else every logit must lie within that gap or one bf16 step of the
    host's (:func:`within_bf16_gap`); that rule only bounds rounding
    noise, and the float32 run is the check that tells a right kernel from
    a wrong one.  Returns the float32 run's max abs logit error.
    """
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import generator
    from repro_torch.models.transformer import init_model
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step

    cfg = dataclasses.replace(config, n_layers=n_layers)
    B, S, steps = 2, 128, 4
    shape = ShapeConfig("check", S + steps + 1, B, "decode")
    with torch.no_grad():
        model = init_model(generator(7, device="cuda"), cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    feed = []

    def snapshot(cache, dev="cpu"):
        return [{k: t.detach().to(dev, copy=True) for k, t in c.items()}
                for c in cache]

    def run(dev, follow=None):
        """(logits of the prefill and each step, the cache after each);
        with ``follow``, step i starts from ``follow[i]``."""
        t0 = time.perf_counter()
        logits, cache = build_prefill_step(cfg, shape, dev)(
            model, {"tokens": tokens})
        out, caches = [logits.float().cpu()], [snapshot(cache)]
        decode = build_decode_step(cfg, shape, dev)
        for i in range(steps):
            if len(feed) == i:
                feed.append(torch.argmax(logits, -1)[:, None].cpu())
            if follow is not None:
                cache = snapshot(follow[i], dev)
            logits, cache = decode(model, cache, feed[i], S + i)
            out.append(logits.float().cpu())
            caches.append(snapshot(cache))
        print(f"  {n_layers}-layer {cfg.name}, "
              f"{next(model.parameters()).dtype} on {dev}: "
              f"{time.perf_counter() - t0:.2f} s")
        return out, caches

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    types = {n: p.dtype for n, p in model.named_parameters()}
    runs = {("cuda", "bf16"): run("cuda")[0]}
    with torch.no_grad():
        model = model.float()
    runs["cuda", "f32"], card_caches = run("cuda")
    with torch.no_grad():
        model = model.to("cpu")
    runs["cpu", "f32"] = run("cpu")[0]
    forced, host_caches = run("cpu", follow=card_caches)
    with torch.no_grad():                  # back to the weights' own types
        for n, p in model.named_parameters():
            p.data = p.data.to(types[n])
    runs["cpu", "bf16"] = run("cpu")[0]
    err32 = gap(runs["cuda", "f32"], forced)
    for i, (g, w) in enumerate(zip(runs["cuda", "f32"], forced)):
        stage = "prefill" if i == 0 else f"decode step {i}"
        check(torch.allclose(g, w, **F32_TOL),
              f"{n_layers}-layer {cfg.d_model}-wide {cfg.name} in float32, "
              f"{stage}: card logits vs host plain path, max abs err "
              f"{float((g - w).abs().max()):.3e} within {F32_TOL}")
        ok, err, flips, n16 = True, 0.0, 0, 0
        for gc, wc in zip(card_caches[i], host_caches[i]):
            for name, t in gc.items():
                want = wc[name]
                diff = (t.float() - want.float()).abs()
                if want.dtype == torch.float32:
                    # the wkv state is the wkv6 kernel's output, which sums
                    # in another order than the host's chunked form
                    ok &= torch.allclose(t, want, **(
                        WKV_TOL if name == "S" else F32_TOL))
                    err = max(err, float(diff.max()))
                else:
                    # float32 values that agree within the tolerance round
                    # to bf16 values at most one bf16 step further apart
                    bound16 = (F32_TOL["atol"] + F32_TOL["rtol"]
                               * want.float().abs() + bf16_ulp(torch, want))
                    ok &= bool((diff <= bound16).all())
                    flips += int((diff > 0).sum())
                    n16 += diff.numel()
        check(ok, f"{n_layers}-layer {cfg.name} in float32, cache after "
                  f"{stage}: float32 state within {F32_TOL} (the wkv state "
                  f"within {WKV_TOL}; max abs err {err:.3e}), bf16 state "
                  f"within {F32_TOL} plus one bf16 step ({flips} of "
                  f"{n16:,} elements apart)")
    err16 = gap(runs["cuda", "bf16"], runs["cpu", "bf16"])
    rounding = gap(runs["cpu", "bf16"], runs["cpu", "f32"])
    outside = sum(int((~torch.isclose(g, w, **BF16_TOL)).sum()) for g, w in
                  zip(runs["cuda", "bf16"], runs["cpu", "bf16"]))
    total = sum(g.numel() for g in runs["cuda", "bf16"])
    stepwise = all(within_bf16_gap(torch, g, w, w32)[0] for g, w, w32 in zip(
        runs["cuda", "bf16"], runs["cpu", "bf16"], runs["cpu", "f32"]))
    check(err16 <= rounding or stepwise,
          f"{n_layers}-layer {cfg.name} in bf16: card vs host max abs logit "
          f"err {err16:.3e} ({outside} of {total:,} logits outside "
          f"{BF16_TOL}) is within the host's own bf16-vs-float32 gap "
          f"{rounding:.3e} (elementwise within it or one bf16 step: "
          f"{stepwise})")
    return err32


def time_attention(torch, ops, ref, dev) -> list[dict]:
    """Kernel, plain version and PyTorch's SDPA (``library_ms``) on the
    same inputs, with their bounds: the serve paths' shapes (qwen3-8b's,
    path C, and recurrentgemma-2b's at hd 256, path E, whose window of
    2,048 covers its 512-token prompt, so SDPA runs it causal),
    PREFILL_32K / DECODE_32K with the batch cut to 1 and 32, and the
    forward at path D's training microbatch (repro-100m's heads)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    rows = []
    for label, B, S, H, K, hd, kind, window, iters in (
            ("serve prefill", 16, SERVE_PROMPT, 32, 8, 128, "causal", 0, 20),
            ("PREFILL_32K, batch 1", 1, 32768, 32, 8, 128, "causal", 0, 2),
            ("path E prefill", 16, SERVE_PROMPT, 10, 1, 256, "window", 2048,
             20),
            ("path D microbatch", TRAIN_BATCH // TRAIN_MICROBATCHES,
             TRAIN_SEQ, 12, 12, 64, "causal", 0, 50)):
        q, k, v = rnd((B, S, H, hd)), rnd((B, S, K, hd)), rnd((B, S, K, hd))
        kw = dict(kind=kind, window=window)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        nops = 4 * hd * (S * (S + 1) // 2) * B * H
        rows.append(dict(
            name="flash_attention", label=label,
            shape=f"B {B}, S {S}, H {H}, K {K}, hd {hd}, {kind}, bf16",
            ms=time_cold_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                            iters, warm=1),
            plain_ms=time_cold_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, **kw), max(2, iters // 4), warm=1),
            library_ms=time_cold_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True), iters, warm=1),
            **bound(nbytes, nops, BF16_OPS_PER_S)))
        del q, k, v
    W = SERVE_PROMPT + SERVE_NEW + 1
    for label, B, W_, n_valid, H, K, hd, iters in (
            ("serve decode step", 16, W, SERVE_PROMPT + SERVE_NEW - 1, 32, 8,
             128, 50),
            ("DECODE_32K, batch 32", 32, 32768, 32768, 32, 8, 128, 5),
            ("path E decode step", 16, W, SERVE_PROMPT + SERVE_NEW - 1, 10,
             1, 256, 50)):
        q = rnd((B, 1, H, hd))
        kc, vc = rnd((B, W_, K, hd)), rnd((B, W_, K, hd))
        valid = (torch.arange(W_, device=dev) < n_valid)[None] \
            .expand(B, W_).contiguous()
        nbytes = 2 * (2 * B * n_valid * K * hd + 2 * q.numel()) + B * W_
        nops = 4 * B * H * n_valid * hd
        mask = valid[:, None, None, :]
        n_split, split_len = ops.decode_split(B, W_, K, H // K, hd, 2)
        rows.append(dict(
            name="flash_decode", label=label,
            shape=f"B {B}, W {W_} ({n_valid} valid), H {H}, K {K}, hd {hd}, "
                  f"bf16; {n_split} splits of {split_len} slots, "
                  f"{B * K * n_split} blocks",
            ms=time_cold_ms(torch, lambda: ops.flash_decode(q, kc, vc, valid),
                            iters),
            plain_ms=time_cold_ms(torch, lambda: ref.flash_decode_ref(
                q, kc, vc, valid), max(2, iters // 5), warm=1),
            library_ms=time_cold_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True), iters),
            **bound(nbytes, nops, BF16_OPS_PER_S)))
        del q, kc, vc
    torch.cuda.empty_cache()
    for r in rows:
        print_row(r)
    return rows


def time_recurrent(torch, ops, ref, dev, xq_b, xm_b) -> list[dict]:
    """``rglru_scan`` at path E's prefill, ``wkv6`` at path F's and
    ``pairwise_sqdist`` at path B's grid chunk, each with a cold L2:
    kernel, plain version, library (``torch.cdist`` squared for the
    distances; none for the recurrences) and bound."""
    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    rows = []
    B, S, R = 16, SERVE_PROMPT, 2560
    a, b = torch.exp(-rnd((B, S, R), 0.5).abs()), rnd((B, S, R), 0.5)
    n = a.numel()
    rows.append(dict(
        name="rglru_scan", label="path E prefill",
        shape=f"B {B}, S {S}, R {R}, float32",
        ms=time_cold_ms(torch, lambda: ops.rglru_scan(a, b), 50),
        plain_ms=time_cold_ms(torch, lambda: ref.rglru_scan_ref(a, b), 3,
                              warm=1),
        library_ms=None, **bound(12 * n, 2 * n, FP32_OPS_PER_S)))
    del a, b
    B, S, H, hd, chunk = 16, SERVE_PROMPT, 64, 64, 32
    r, k, v = (rnd((B, S, H, hd), 0.5).bfloat16() for _ in range(3))
    logw = -torch.exp(rnd((B, S, H, hd), 0.5) - 2.0)
    u = rnd((H, hd), 0.3)
    n = r.numel()
    rows.append(dict(
        name="wkv6", label="path F prefill",
        shape=f"B {B}, S {S}, H {H}, hd {hd}, chunk {chunk}, r/k/v bf16",
        ms=time_cold_ms(torch, lambda: ops.wkv6(r, k, v, logw, u, chunk), 20,
                        warm=1),
        plain_ms=time_cold_ms(torch, lambda: ref.wkv6_chunked_ref(
            r, k, v, logw, u, chunk), 5, warm=1),
        library_ms=None,
        **bound(3 * 2 * n + 4 * n + 4 * H * hd + 4 * n + 4 * B * H * hd * hd,
                4 * B * H * S * hd * hd, FP32_OPS_PER_S)))
    del r, k, v, logw
    (Q, F), M = xq_b.shape, xm_b.shape[0]
    d2 = torch.empty((Q, M), device=dev)
    rows.append(dict(
        name="pairwise_sqdist", label="path B grid chunk",
        shape=f"Q {Q}, M {M}, F {F}, float32",
        ms=time_cold_ms(torch, lambda: ops.pairwise_sqdist(xq_b, xm_b), 100),
        plain_ms=time_cold_ms(torch, lambda: ref.pairwise_sqdist_ref(
            xq_b, xm_b), 20),
        library_ms=time_cold_ms(torch, lambda: torch.cdist(
            xq_b, xm_b).square_(), 100),
        # the floor of a write-bound kernel: the card's own cold write of
        # the same (Q, M) float32 result; and both warm, where the result
        # stays in the L2 and only the kernel's own work is timed
        write_ms=time_cold_ms(torch, lambda: d2.fill_(0.0), 100),
        warm_ms=time_ms(torch, lambda: ops.pairwise_sqdist(xq_b, xm_b), 200),
        write_warm_ms=time_ms(torch, lambda: d2.fill_(0.0), 200),
        **bound(4 * (Q * F + M * F + Q * M), Q * M * (2 * F + 4)
                + (Q + M) * 2 * F, FP32_OPS_PER_S)))
    del d2
    torch.cuda.empty_cache()
    for row in rows:
        print_row(row)
    return rows


def print_row(r: dict) -> None:
    """One timed row, with the kernel's achieved bytes/s (the bound's bytes
    over its time) and the bound's share of its time."""
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    print(f"{r['name']} {r['label']} ({r['shape']}): kernel {r['ms']:.4f} "
          f"ms, plain {r['plain_ms']:.4f} ms, library {lib}, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['nbytes'] / 1e6:.1f} "
          f"MB, {r['nops'] / 1e9:.2f} GFLOP; {r['bound_ms'] / r['ms']:.4f} "
          f"of the kernel's time; achieved "
          f"{r['nbytes'] / r['ms'] / 1e9:.3f} TB/s)")
    if "write_ms" in r:
        print(f"{r['name']} {r['label']}: the card's cold write of its "
              f"result (fill_) {r['write_ms']:.4f} ms, kernel "
              f"{r['ms'] / r['write_ms']:.4f}x of it; warm: fill_ "
              f"{r['write_warm_ms']:.4f} ms, kernel {r['warm_ms']:.4f} ms "
              f"({r['warm_ms'] / r['write_warm_ms']:.4f}x)")


def record_rows(rows: list[dict], name: str) -> list[dict]:
    """Every timed shape of one kernel, for its entry in the kernel line."""
    return [{"label": r["label"], "shape": r["shape"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "tb_per_s": r["nbytes"] / r["ms"] / 1e9,
             **{k: r[k] for k in ("write_ms", "warm_ms", "write_warm_ms",
                                  "chain_ms", "latency_bound_ms",
                                  "dep_load_ns", "table_bytes") if k in r}}
            for r in rows if r["name"] == name]


def bf16_ulp(torch, x):
    """One bf16 unit in the last place at each element of ``x``."""
    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp(min=2.0 ** -126))) - 7)


def within_bf16_gap(torch, got, want, want32) -> tuple[bool, float]:
    """The bf16 rule for a result summed in float32 and rounded once: each
    element of ``got`` lies within the plain bf16 result ``want``'s own
    largest gap to the plain float32 result ``want32``, or within one bf16
    unit in the last place of ``want`` (two right roundings of float32
    sums taken in another order can land on neighbouring bf16 values, and
    at large magnitudes that step exceeds the gap).  Returns (ok, gap)."""
    gap = float((want.float() - want32.float()).abs().max())
    diff = (got.float() - want.float()).abs()
    return bool((diff <= torch.clamp(bf16_ulp(torch, want), min=gap))
                .all()), gap


def check_training_kernels(torch, ops, ref, dev) -> dict[str, float]:
    """The training path's kernels against their plain versions on the
    card: ``quantize_int8`` bit-equal on random shapes (rows of up to
    32,768, up to 32,768 rows, float32 and bf16); the forward's row
    statistics; the backward at path D's shape, at qwen3-8b's training
    head layout, and on random shapes with every mask kind, float32 at
    atol/rtol 1e-3 and bf16 no farther from the plain bf16 gradient than
    that is from the plain float32 one, or than one bf16 step
    (:func:`within_bf16_gap`).  Returns the max abs errors."""
    gen = torch.Generator(device=dev).manual_seed(3)
    errs = {"quantize_int8": [], "flash_attention_bwd": []}
    for M, N in ((32768, 768), (768, 32768), (3072, 768), (768, 3072),
                 (1, 768), (7, 5000), (12, 33)):
        for dt in (torch.float32, torch.bfloat16):
            x = (3 * torch.randn((M, N), generator=gen, device=dev)).to(dt)
            q, s = ops.quantize_int8(x)
            qr, sr = ref.quantize_int8_ref(x)
            n_diff = int((q != qr).sum()) + int((s != sr).sum())
            errs["quantize_int8"].append(
                float((q.int() - qr.int()).abs().max()))
            check(n_diff == 0, f"quantize_int8 ({M}x{N}, {str(dt)[6:]}) "
                               f"bit-equal to its plain version")
    cases = [  # (label, B, S, H, K, hd, kind, window, softcap)
        ("path D", 4, 256, 12, 12, 64, "causal", 0, 0.0),
        ("qwen3-8b training heads", 1, 4096, 32, 8, 128, "causal", 0, 0.0),
        ("ragged window", 2, 333, 8, 2, 128, "window", 100, 0.0),
        ("ragged chunk", 2, 333, 8, 2, 128, "chunk", 128, 0.0),
        ("bidir", 2, 200, 8, 8, 64, "bidir", 0, 0.0),
        ("softcap", 1, 256, 8, 2, 128, "causal", 0, 30.0),
        ("MQA", 2, 150, 4, 1, 96, "causal", 0, 0.0),
    ]
    for label, B, S, H, K, hd, kind, window, softcap in cases:
        base = [torch.randn(sh, generator=gen, device=dev)
                for sh in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                           (B, S, H, hd))]
        kw = dict(kind=kind, window=window, softcap=softcap)
        plain = {}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, dout = (t.to(dt) for t in base)
            _, (m, l) = ops.flash_attention(q, k, v, return_stats=True, **kw)
            mr, lr = ref.flash_attention_stats_ref(q, k, **kw)
            tag = (f"(B {B}, S {S}, H {H}/K {K}, hd {hd}, {kind}, "
                   f"{str(dt)[6:]})")
            tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
            check(torch.allclose(m, mr, **tol)
                  and torch.allclose(l, lr, rtol=1e-5, atol=0),
                  f"flash_attention stats {label} {tag}: row max within "
                  f"{tol}, sum of exponentials within rtol 1e-5 (max "
                  f"errs {float((m - mr).abs().max()):.2e}, "
                  f"{float(((l - lr) / lr).abs().max()):.2e})")
            got = ops.flash_attention_bwd(q, k, v, dout, (m, l), **kw)
            plain[dt] = ref.flash_attention_bwd_ref(q, k, v, dout, **kw)
            for name, g, p, p32 in zip(("dq", "dk", "dv"), got, plain[dt],
                                       plain[torch.float32]):
                err = float((g.float() - p.float()).abs().max())
                errs["flash_attention_bwd"].append(err)
                if dt == torch.float32:
                    check(torch.allclose(g, p, atol=1e-3, rtol=1e-3),
                          f"flash_attention_bwd {label} {tag} {name}: max "
                          f"abs err {err:.3e} within atol/rtol 1e-3")
                else:
                    ok, gap = within_bf16_gap(torch, g, p, p32)
                    check(ok, f"flash_attention_bwd {label} {tag} {name}: "
                              f"max abs err {err:.3e}; every element within "
                              f"the plain version's bf16-vs-float32 gap "
                              f"{gap:.3e} or one bf16 step")
        del base, plain
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {name: max(e) for name, e in errs.items()}


def check_recurrent_kernels(torch, ops, ref, dev, xq_b, xm_b
                            ) -> dict[str, float]:
    """The recurrent kernels of paths E and F and ``pairwise_sqdist``
    against their plain versions on the card.  ``rglru_scan`` must be
    bit-equal, at path E's prefill shape and on ragged shapes.  ``wkv6``
    (output and final state; bf16 and float32 inputs; with and without an
    initial state; strided inputs) at path F's prefill shape and on random
    shapes, against the model's chunked form and the sequential oracle at
    the JAX tests' atol 5e-4 / rtol 1e-3.  ``pairwise_sqdist`` on path B's
    real probes and grid chunk (``xm_b``, ``xq_b``) and on the ragged
    shapes of tests/test_surrogate.py and unaligned ones (M % 4 != 0), at
    atol / rtol 1e-4; a set against itself gives an exactly zero diagonal.
    Returns the max abs errors."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    errs = {"rglru_scan": [], "wkv6": [], "pairwise_sqdist": []}
    for B, S, R in ((16, SERVE_PROMPT, 2560), (3, 37, 100), (1, 1000, 2567),
                    (5, 9, 33), (2, 1, 128)):
        a = torch.exp(-rnd((B, S, R), 0.5).abs())
        b = rnd((B, S, R), 0.5)
        h, want = ops.rglru_scan(a, b), ref.rglru_scan_ref(a, b)
        errs["rglru_scan"].append(float((h - want).abs().max()))
        check(torch.equal(h, want),
              f"rglru_scan ({B}x{S}x{R}) bit-equal to its plain version")
    cases = [  # (label, B, S, H, hd, chunk, dtype, initial state, strided)
        ("path F prefill", 16, SERVE_PROMPT, 64, 64, 32, torch.bfloat16,
         False, False),
        ("path F prefill", 16, SERVE_PROMPT, 64, 64, 32, torch.float32,
         True, False),
        ("hd 32 strided", 2, 96, 4, 32, 8, torch.float32, True, True),
        ("hd 128", 2, 128, 2, 128, 64, torch.bfloat16, True, False),
    ]
    for label, B, S, H, hd, chunk, dt, init, strided in cases:
        shape = (B, H, S, hd) if strided else (B, S, H, hd)

        def model_layout(t):
            return t.transpose(1, 2) if strided else t

        r, k, v = (model_layout(rnd(shape, 0.5).to(dt)) for _ in range(3))
        logw = model_layout(-torch.exp(rnd(shape, 0.5) - 2.0))
        u = rnd((H, hd), 0.3)
        s0 = rnd((B, H, hd, hd), 0.3) if init else None
        got = ops.wkv6(r, k, v, logw, u, chunk, initial_state=s0)
        tag = (f"(B {B}, S {S}, H {H}, hd {hd}, chunk {chunk}, "
               f"{str(dt)[6:]}{', initial state' if init else ''})")
        for name, want in (
                ("chunked", ref.wkv6_chunked_ref(r, k, v, logw, u, chunk,
                                                 initial_state=s0)),
                ("sequential", ref.wkv6_ref(r, k, v, logw, u,
                                            initial_state=s0))):
            errs["wkv6"].append(compare(
                torch, f"wkv6 {label} {tag} vs the {name} plain version",
                ("o", "state"), got, want, WKV_TOL))
    errs["pairwise_sqdist"].append(compare(
        torch, f"pairwise_sqdist path B ({xq_b.shape[0]} grid states x "
               f"{xm_b.shape[0]} probes x {xq_b.shape[1]} features)",
        ("d2",), (ops.pairwise_sqdist(xq_b, xm_b),),
        (ref.pairwise_sqdist_ref(xq_b, xm_b),), SQDIST_TOL))
    for Q, M, F in ((5, 3, 7), (300, 17, 130), (513, 256, 6),
                    (8193, 1025, 16), (63, 1023, 3)):
        xq, xm = rnd((Q, F)), rnd((M, F))
        errs["pairwise_sqdist"].append(compare(
            torch, f"pairwise_sqdist random ({Q}x{M}x{F})", ("d2",),
            (ops.pairwise_sqdist(xq, xm),),
            (ref.pairwise_sqdist_ref(xq, xm),), SQDIST_TOL))
    for Q, F in ((40, 9), (1025, 16), (300, 130)):
        x = rnd((Q, F))
        d2 = ops.pairwise_sqdist(x, x)
        check(bool((d2.diagonal() == 0).all() and (d2 >= 0).all()),
              f"pairwise_sqdist of a set with itself ({Q}x{F}): exactly "
              f"zero diagonal, no negative entry")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {name: max(e) for name, e in errs.items()}


def path_d(torch, ops, ref, profile: bool) -> tuple[dict, dict]:
    """The training path on repro-100m at full size: ``launch.train``
    (int8 compression, 2 microbatches, block remat, batch 8, seq 256) for
    TRAIN_STEPS steps with checkpoints, then the annealed twin
    ``launch.train_anneal``.  Checks that the loss drops, the kernels'
    launches per step, and the quantizer on the run's real gradients.
    Returns (timings, the launches of the train run)."""
    import numpy as np

    from repro_torch.checkpoint import committed_steps
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import TrainRun, run_training
    from repro_torch.launch.train_anneal import anneal_training
    from repro_torch.runtime.train import TrainStepOptions

    config = get_config("repro-100m")
    L, k = config.n_layers, TRAIN_MICROBATCHES
    ckpt = ROOT / "build" / "chip_smoke" / "ckpt"
    run = TrainRun(arch=config.name, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, ckpt_dir=str(ckpt), save_every=50,
                   device="cuda",
                   options=TrainStepOptions(
                       microbatches=k, remat="block", compression="int8"))
    per_step = []
    last = {}

    def on_metrics(step, metrics, dt):
        now = dict(ops.LAUNCHES)
        per_step.append({n: now[n] - last.get(n, 0) for n in now})
        last.update(now)

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = run_training(run, on_metrics=on_metrics, log_every=10 ** 9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    losses = np.asarray(out["losses"])
    times = np.asarray(out["step_times"])
    n_params = sum(1 for _ in out["state"].params.parameters())
    print(f"path D: {config.name} ({config.param_count():,} parameters, "
          f"{n_params} tensors, {L} layers), {TRAIN_STEPS} steps of batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} ({k} microbatches, block remat, "
          f"int8) in {wall:.1f} s; step median {np.median(times) * 1e3:.2f}"
          f" ms (first {times[0] * 1e3:.0f} ms); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first 10 mean {losses[:10].mean():.4f}, last "
          f"10 {losses[-10:].mean():.4f}); launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check(out["final_step"] == TRAIN_STEPS and out["restarts"] == 0,
          f"path D trained {TRAIN_STEPS} steps with no restart")
    check(losses[-1] < losses[0] and losses[-10:].mean()
          < losses[:10].mean() - 0.05,
          "path D: the loss dropped (last < first, and the last 10 steps' "
          "mean 0.05 under the first 10's)")
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(quantize_int8=n_params, flash_attention=L * k * 2,
                flash_attention_bwd=L * k)
    check(n_params == 111 and all(s == want for s in per_step),
          f"path D: every step launched {want}")
    check(committed_steps(str(ckpt))[-1] == TRAIN_STEPS,
          "path D checkpointed its last step")

    # the quantizer on this run's real gradients (one microbatch)
    built = run.build()[1]
    batch = SyntheticLM(DataConfig(vocab=config.vocab, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH)).batch_at(0)
    _, _, grads = built.grads(out["state"].params, {
        n: torch.from_numpy(v.astype(np.int64)).cuda()
        for n, v in batch.items()})
    same = all(all(torch.equal(a, b) for a, b in zip(
        ops.quantize_int8(g.float()), ref.quantize_int8_ref(g.float())))
        for g in grads.values())
    check(same, f"quantize_int8 bit-equal to its plain version on path D's "
                f"{len(grads)} real gradient tensors")

    # the annealed twin, shortened
    def show(rec):
        print(f"  round {rec['round']:2d} step {rec['step']:4d} loss "
              f"{rec['loss']:.4f} cfg={rec['config']} Y={rec['y']:.4f} s "
              f"(measured {rec['proposed']} at {rec['step_s'] * 1e3:.1f} "
              f"ms/step){' explored' if rec['explored'] else ''}", flush=True)

    ops.reset_launches()
    t0 = time.perf_counter()
    ann = anneal_training(config.name, steps=ANNEAL_ROUNDS * ANNEAL_EVERY,
                          batch=4, seq=TRAIN_SEQ, anneal_every=ANNEAL_EVERY,
                          ckpt_dir=str(ROOT / "build" / "chip_smoke"
                                       / "anneal_ckpt"),
                          device="cuda", on_round=show)
    torch.cuda.synchronize()
    ann_wall = time.perf_counter() - t0
    al = ann["losses"]
    print(f"path D anneal: {ann['steps']} steps in {ann_wall:.1f} s; loss "
          f"{al[0]:.4f} -> {al[-1]:.4f}; annealer's best step config: "
          f"{ann['best']} (Y={ann['best_y']:.4f} s/step); launches "
          f"{dict(ops.LAUNCHES)}")
    check(al[-1] < al[0], "path D anneal: the loss dropped")
    check(ops.LAUNCHES["flash_attention_bwd"] > 0
          and ops.LAUNCHES["quantize_int8"] == 0,
          "path D anneal ran the attention kernels (and no compression)")
    timing = {"step_ms": float(np.median(times)) * 1e3, "train_s": wall,
              "anneal_s": ann_wall}
    if profile:
        profile_train(torch, built, out["state"], batch, timing["step_ms"])
    del out, built, grads
    torch.cuda.empty_cache()
    return timing, launches


def profile_train(torch, built, state, batch, untraced_ms: float) -> None:
    """Trace 3 more path-D steps with torch.profiler; prints the device's
    busy time per step and its idle share against the untraced median."""
    class Steps:
        def round(self):
            built.step(state, batch)
            float(state.opt.count)

    built.step(state, batch)
    profile_rounds(torch, Steps(), 3, "path D step", untraced_ms)


def train_step_check(torch, config) -> None:
    """A 2-layer model at ``config``'s full width: one microbatch's loss
    and gradients, and one whole train step (AdamW, no compression),
    through the kernels on the card and with the same weights through the
    plain path on the host.  With float32 weights the loss agrees to rtol
    1e-5, the gradients to atol 1e-4 / rtol 1e-3 and the new parameters
    to atol 1e-5 / rtol 1e-4; with the model's own bf16 weights the
    gradients' largest card-host gap is within the host's own largest
    bf16-vs-float32 gap (the rule of :func:`whole_model_check`; that rule
    only bounds rounding noise, and the float32 run tells a right kernel
    from a wrong one)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.device import generator
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.optimizer import adamw_init
    from repro_torch.runtime.train import TrainState, TrainStepOptions, \
        build_train_step

    cfg = dataclasses.replace(config, n_layers=2)
    B, S = 4, 128
    shape = ShapeConfig("check", S, B, "train")
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B)).batch_at(3)
    def run(dev, dtype):
        t0 = time.perf_counter()
        with torch.no_grad():
            m = init_model(generator(7, device="cuda"), cfg)
            m = (m.float() if dtype == "f32" else m).to(dev)
        built = build_train_step(cfg, shape, TrainStepOptions(remat="block"),
                                 dev)
        loss, _, grads = built.grads(m, {
            n: torch.from_numpy(v.astype(np.int64)).to(dev)
            for n, v in batch.items()})
        params = {n: p.detach() for n, p in m.named_parameters()}
        state = TrainState(m, adamw_init(params, built.options.adamw), None)
        state, _ = built.step(state, batch)
        out = (loss.float().cpu(), {n: g.float().cpu()
                                    for n, g in grads.items()},
               {n: p.detach().float().cpu()
                for n, p in state.params.named_parameters()})
        print(f"  2-layer train step, {dtype} on {dev}: "
              f"{time.perf_counter() - t0:.2f} s, loss {float(out[0]):.6f}")
        return out

    runs = {(dev, dt): run(dev, dt) for dev in ("cuda", "cpu")
            for dt in ("f32", "bf16")}

    def gap(a, b):
        return {n: float((a[n] - b[n]).abs().max()) for n in a}

    c32, h32 = runs["cuda", "f32"], runs["cpu", "f32"]
    check(torch.allclose(c32[0], h32[0], rtol=1e-5, atol=0),
          f"2-layer {cfg.d_model}-wide train step in float32: card loss "
          f"{float(c32[0]):.7f} vs host {float(h32[0]):.7f} within rtol "
          f"1e-5")
    err32 = max(gap(c32[1], h32[1]).values())
    check(all(torch.allclose(c32[1][n], h32[1][n], atol=1e-4, rtol=1e-3)
              for n in c32[1]),
          f"2-layer train step in float32: card gradients vs host plain "
          f"path, max abs err {err32:.3e} within atol 1e-4 / rtol 1e-3")
    perr = max(gap(c32[2], h32[2]).values())
    check(all(torch.allclose(c32[2][n], h32[2][n], atol=1e-5, rtol=1e-4)
              for n in c32[2]),
          f"2-layer train step in float32: new parameters, max abs err "
          f"{perr:.3e} within atol 1e-5 / rtol 1e-4")
    c16, h16 = runs["cuda", "bf16"], runs["cpu", "bf16"]
    card = gap(c16[1], h16[1])
    host = gap(h16[1], h32[1])
    for n in sorted(card, key=lambda n: -card[n] / max(host[n], 1e-30))[:3]:
        print(f"    {n}: card-host {card[n]:.3e}, host bf16-vs-float32 "
              f"{host[n]:.3e}, within one bf16 step elementwise "
              f"{within_bf16_gap(torch, c16[1][n], h16[1][n], h32[1][n])[0]}")
    n_within = sum(card[n] <= host[n] for n in card)
    check(max(card.values()) <= max(host.values()),
          f"2-layer train step in bf16: card vs host max abs gradient err "
          f"{max(card.values()):.3e} within the host's own bf16-vs-float32 "
          f"gap {max(host.values()):.3e} ({n_within} of {len(card)} tensors "
          f"within their own); loss {float(c16[0]):.5f} vs "
          f"{float(h16[0]):.5f}")


def qwen_train_step(torch, ops, config) -> None:
    """One train step of a 2-layer model at ``config``'s full width on the
    card alone (the host cannot afford the comparison): the training path
    at hd 128 with GQA and qk-norm, no compression.  Checks a finite loss,
    finite new parameters and the attention kernels' launches."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.runtime.train import TrainStepOptions, build_train_step

    cfg = dataclasses.replace(config, n_layers=2)
    B, S = 1, 4096
    built = build_train_step(cfg, ShapeConfig("check", S, B, "train"),
                             TrainStepOptions(), "cuda")
    state = built.init(0)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B)).batch_at(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, metrics = built.step(state, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n = sum(1 for _ in state.params.parameters())
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.params.parameters())
    print(f"  2-layer {cfg.d_model}-wide {config.name} train step (B {B}, S "
          f"{S}, {cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}): "
          f"loss {loss:.4f} in {step_s:.2f} s, launches {launches}, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB")
    fwd = 2 * (1 if built.config.remat == "none" else 2)
    check(np.isfinite(loss) and finite and launches["flash_attention"] == fwd
          and launches["flash_attention_bwd"] == 2,
          f"{config.name} 2-layer train step on the card ({built.config.remat}"
          f" remat): finite loss and {n} parameter tensors, {fwd} forward and "
          f"2 backward attention launches")
    del built, state
    torch.cuda.empty_cache()


def time_training_kernels(torch, ops, ref, dev) -> list[dict]:
    """``quantize_int8`` at repro-100m's largest gradient, and the
    backward at path D's shape and at qwen3-8b's training head layout:
    kernel, plain version, library (SDPA's backward through autograd for
    the attention; none for the quantizer) and bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    x = torch.randn((32768, 768), generator=gen, device=dev)
    M, N = x.shape
    rows.append(dict(
        name="quantize_int8", label="embed gradient",
        shape=f"{M} x {N}, float32",
        ms=time_cold_ms(torch, lambda: ops.quantize_int8(x), 200),
        plain_ms=time_cold_ms(torch, lambda: ref.quantize_int8_ref(x), 20),
        library_ms=None, **bound(4 * M * N + M * N + 4 * M, 0,
                                 FP32_OPS_PER_S)))
    del x
    for label, B, S, H, K, hd, iters in (
            ("path D microbatch", 4, TRAIN_SEQ, 12, 12, 64, 50),
            ("qwen3-8b training heads", 1, 4096, 32, 8, 128, 3)):
        q, dout = (torch.randn((B, S, H, hd), generator=gen,
                               device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn((B, S, K, hd), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        _, stats = ops.flash_attention(q, k, v, return_stats=True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        dt = dout.transpose(1, 2)
        pairs = S * (S + 1) // 2
        nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                      + dout.numel()) + 8 * B * H * S
        rows.append(dict(
            name="flash_attention_bwd", label=label,
            shape=f"B {B}, S {S}, H {H}, K {K}, hd {hd}, causal, bf16",
            ms=time_cold_ms(torch, lambda: ops.flash_attention_bwd(
                q, k, v, dout, stats), iters, warm=1),
            plain_ms=time_cold_ms(torch, lambda: ref.flash_attention_bwd_ref(
                q, k, v, dout), max(2, iters // 5), warm=1),
            library_ms=time_cold_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), dt, retain_graph=True), iters, warm=1),
            **bound(nbytes, 5 * 2 * hd * pairs * B * H, BF16_OPS_PER_S)))
        del q, k, v, dout, qt, kt, vt, out, dt, stats
    torch.cuda.empty_cache()
    for r in rows:
        print_row(r)
    return rows


def profile_table_build(torch, ctrl) -> None:
    """Trace one path-B table build (the day mix's table dropped from the
    controller's cache and built again: the probes, then 206
    ``fused_interp`` chunks) after one untraced build; prints the build's
    wall time, the device's busy time and idle share, and
    ``fused_interp``'s share of the device time."""
    class Build:
        def round(self):
            ctrl._tables.clear()
            ctrl._table_for(MIX_DAY)

    build = Build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build.round()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"path B table build: {wall_ms:.1f} ms wall (untraced)")
    profile_rounds(torch, build, 1, "path B table build", wall_ms,
                   share_of="fused_interp")


def path_a_rows(torch, small, dev):
    """``sizing_latency``'s inputs at path A: the whole coarse grid's rows
    (196,608 x 8) under the day mix."""
    rates = torch.tensor(small.dag.rates_array(MIX_DAY), dtype=torch.float32,
                         device=dev)
    return small.kernel_inputs(small.grid_candidates(dev), rates)


def path_b_chunk(torch, large, dev):
    """``fused_interp``'s inputs at path B's chunk: 1,024 probes of the
    rich menu, measured under the day mix, against the first 8,192 grid
    states, as ``SurrogateModel.predict`` hands them over."""
    from repro_torch.core import sizing as sz
    from repro_torch.core.surrogate import (
        MeasurementStore,
        SpaceEncoding,
        SurrogateSource,
    )

    enc = SpaceEncoding.from_space(large.space)
    probes = SurrogateSource(n_probe=1024, seed=3)._probe_states(
        large.space, None)
    store = MeasurementStore(len(large.space.shape))
    for s in probes:
        store.add(s, float(large.host_objective(
            large.space.decode([int(i) for i in s]), MIX_DAY)["y"]), 0.0)
    obs, ys, _ = store.arrays()
    check(len(obs) == 1024, f"path B store holds {len(obs)} probes")
    xq = torch.as_tensor(enc.features(sz.full_grid(large.space)[:8192]),
                         device=dev)
    return (xq, torch.as_tensor(enc.features(obs), device=dev),
            torch.as_tensor(ys, dtype=torch.float32, device=dev),
            torch.ones(len(obs), dtype=torch.float32, device=dev))


# -- path G: the paper's procurement loop -------------------------------------

#: path G's workload: the quickstart's controller (examples/quickstart.py)
#: on the paper's EC2 space, planned with ``plan()``'s defaults (256
#: chains x 200 steps), then 300 jobs; ``fleet_chains`` at 1,000 tenants
#: (bucket 1,024) x 32 steps, ``FleetController``'s ``steps_per_round``
G_SUBMITS = 300
G_TENANTS, G_FLEET_STEPS = 1000, 32


@contextlib.contextmanager
def capture_walk(ops, store: dict, label: str, largest: bool = False):
    """While open, every ``ops.anneal_walk`` call also leaves its inputs
    in ``store[label]`` (the last call's; with ``largest``, the call of
    the most chains), so the kernel can be checked and timed later on the
    very tensors a path gave it."""
    real = ops.anneal_walk

    def spy(*args, **kw):
        if not largest or label not in store \
                or args[3].shape[0] > store[label][0][3].shape[0]:
            store[label] = (args, kw)
        return real(*args, **kw)

    ops.anneal_walk = spy
    try:
        yield
    finally:
        ops.anneal_walk = real


def walk_shape(args) -> str:
    inits, table, taus, axis = args[:4]
    C, S = axis.shape
    return (f"C {C}, S {S}, {inits.shape[1]} axes, table "
            f"{tuple(table.shape)}")


def walk_inputs(torch, dev, C, S, shape, categorical, table=None, *,
                dynamic=False, per_chain=False, extra=False, valid=False,
                noise_std=0.0, seed=0):
    """``ops.anneal_walk``'s inputs for C chains of S steps on ``shape``:
    ``table`` (flat, its time or chain axes first) or a random one in [0,
    3); temperatures in [0.1, 1.1); random starting states, held valid by
    the mask (about 4 in 5 states) when ``valid``; the draws made as
    ``anneal_fleet`` makes them."""
    from repro_torch.core.annealing import _draw
    from repro_torch.core.state import EncodedSpace

    g = torch.Generator(device=dev).manual_seed(seed)
    size = 1
    for n in shape:
        size *= n
    lead = ((C,) if per_chain else ()) + ((S,) if dynamic else ())
    if table is None:
        table = 3.0 * torch.rand(lead + (size,), generator=g, device=dev)
    taus = 0.1 + torch.rand((C, S), generator=g, device=dev)
    inits = torch.stack([torch.randint(0, n, (C,), generator=g, device=dev)
                         for n in shape], -1).to(torch.int32)
    d = _draw(g, EncodedSpace(tuple(shape), tuple(categorical)), C, S,
              noise_std > 0, dev)
    kw = dict(shape=tuple(shape), categorical=tuple(categorical),
              dynamic=dynamic, per_chain=per_chain, noise_std=noise_std,
              noise=d.get("noise"), noise0=d.get("noise0"))
    if extra:
        kw["extra"] = torch.rand((C, size), generator=g, device=dev)
    if valid:
        mask = torch.rand(size, generator=g, device=dev) < 0.8
        strides = torch.ones(len(shape), dtype=torch.int64, device=dev)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        mask[(inits.long() * strides).sum(-1)] = True
        kw["valid"] = mask
    return (inits, table, taus, d["axis"], d["up"], d["pick"],
            d["uniform"]), kw


def walk_cases(torch, ops, dev) -> dict:
    """``ops.anneal_walk``'s inputs at the five shapes its timings use,
    as the paths give them: path A's and path B's rounds (one round of
    each controller), Figs. 4's and 5's sweeps (the figures' own runs) and
    ``fleet_chains``' bucket (1,000 tenants of random per-tenant tables
    and extra rows on the paper's 4 x 30 space, padded to 1,024)."""
    import numpy as np

    from repro_torch.core import fleet_chains
    from repro_torch.core import sizing as sz
    from repro_torch.core.surrogate import SurrogateSource
    from repro_torch.device import generator
    from repro_torch.figures import paper_figures
    from repro_torch.workloads import microservice as ms

    small, large = make_specs(sz, ms)
    cases = {}
    with capture_walk(ops, cases, "path A round"):
        sz.SizingController(small, MIX_DAY, steps_per_round=64,
                            n_chains=16, seed=0, device="cuda").round()
    with capture_walk(ops, cases, "path B round"):
        sz.SizingController(
            large, MIX_DAY, objective_source=SurrogateSource(
                n_probe=1024, seed=3, device="cuda"),
            steps_per_round=64, n_chains=16, seed=3, device="cuda").round()
    os.environ.setdefault("REPRO_BENCH_OUT",
                          str(ROOT / "build" / "chip_smoke_figures"))
    with capture_walk(ops, cases, "Fig. 4 sweep"):
        paper_figures.fig4_temperature("cuda")
    with capture_walk(ops, cases, "Fig. 5 sweep"):
        paper_figures.fig5_change("cuda")
    rng = np.random.default_rng(0)
    T, S, shape = G_TENANTS, G_FLEET_STEPS, (4, 30)
    tables = rng.uniform(100.0, 200.0, (T, 120)).astype(np.float32)
    extra = rng.uniform(0.0, 5.0, (T, 120)).astype(np.float32)
    taus = np.broadcast_to(rng.uniform(0.5, 2.0, (T, 1)), (T, S)) \
        .astype(np.float32)
    inits = np.stack([rng.integers(0, n, T) for n in shape],
                     -1).astype(np.int32)
    with capture_walk(ops, cases, "fleet_chains bucket"):
        fleet_chains(generator(0, device=dev), tables, None, taus, inits,
                     extra, shape=shape, categorical=(True, False),
                     device="cuda")
    torch.cuda.synchronize()
    return cases


def walk_same(torch, got, want) -> bool:
    """Two walks' (states, ys, accepts) bit-equal: equal element by
    element, a NaN objective NaN in both."""
    return all(g.dtype == w.dtype and g.shape == w.shape and bool(
        ((g == w) | (g.isnan() & w.isnan()) if g.is_floating_point()
         else g == w).all()) for g, w in zip(got, want))


def check_walk(torch, ops, ref, label, args, kw) -> float:
    """``anneal_walk`` against its plain version on the same inputs:
    states, ys and accepts bit-equal (equal element by element, a NaN
    objective NaN in both).  Returns the largest |ys| difference among
    finite entries (0 when equal)."""
    got = ops.anneal_walk(*args, **kw)
    want = ref.anneal_walk_ref(*args, **kw)
    torch.cuda.synchronize()
    same = walk_same(torch, got, want)
    fin = torch.isfinite(got[1]) & torch.isfinite(want[1])
    err = float((got[1] - want[1])[fin].abs().max()) if bool(fin.any()) \
        else 0.0
    check(same, f"anneal_walk {label} ({walk_shape(args)}): states, ys and "
                f"accepts bit-equal to the plain version (accept rate "
                f"{float(got[2].float().mean()):.3f})")
    return err


def check_walk_kernel(torch, ops, ref, dev, captured) -> float:
    """Phase G(a): the walk kernel against its plain version on path A's
    and path B's real inputs (as their last rounds gave them), Fig. 4's
    and Fig. 5's tables, a noisy chain, per-chain tables with extra rows
    and a valid mask, 16 axes, and C = 1, 33 and 1,024."""
    import numpy as np

    from repro_torch.core.landscape import bimodal_landscape, changed_landscape

    errs = [check_walk(torch, ops, ref, label, *captured[label])
            for label in ("path A round", "path B round")]
    y1 = torch.as_tensor(bimodal_landscape(), dtype=torch.float32,
                         device=dev)
    y2 = torch.as_tensor(changed_landscape(), dtype=torch.float32,
                         device=dev)
    args, kw = walk_inputs(torch, dev, 320, 4000, (48,), (False,), y1)
    errs.append(check_walk(torch, ops, ref, "Fig. 4 table", args, kw))
    fig5 = torch.stack([y1 if i < 2000 else y2 for i in range(6000)])
    args, kw = walk_inputs(torch, dev, 1, 6000, (48,), (False,), fig5,
                           dynamic=True)
    errs.append(check_walk(torch, ops, ref, "Fig. 5 time-indexed table",
                           args, kw))
    forms = [("noisy chain", 33, 500, (5, 4, 3), (False, True, False),
              dict(noise_std=0.4)),
             ("per-chain tables, extra rows, valid mask", 1024, 32, (4, 30),
              (True, False), dict(per_chain=True, extra=True, valid=True)),
             ("16 axes, valid mask", 64, 200, (3, 2) * 8, (False, True) * 8,
              dict(valid=True))]
    forms += [(f"C = {C}", C, 50, (6, 5), (False, True),
               dict(valid=True, seed=C)) for C in (1, 33, 1024)]
    for label, C, S, shape, cat, opt in forms:
        args, kw = walk_inputs(torch, dev, C, S, shape, cat, **opt)
        errs.append(check_walk(torch, ops, ref, label, args, kw))
    assert np.isfinite(errs).all()
    return max(errs)


def path_g(torch, ops, dev, captured) -> tuple[dict, dict]:
    """Path G: the paper's procurement loop.  (b) both figure modules on
    the card, every check passing (``fig4_engine_speedup`` >= 10x); (c)
    ``ProcurementController`` on the paper's EC2 space with the
    quickstart's blend: ``plan()`` through the exhaustive table and
    through ``SurrogateSource``, each planned y within 1.02x of its
    table's valid minimum, one ``anneal_walk`` launch a plan, then 300
    jobs; (d) ``fleet_chains`` at 1,000 tenants (bucket 1,024) x 32 steps
    with per-tenant tables and extra rows, rows 0..999 bit-equal to the
    unpadded walk.  Returns (the launches of (b)-(d), the timings)."""
    import numpy as np

    from repro_torch.core import (
        BLEND_BEFORE,
        EC2_CATALOG_ADJUSTED,
        Objective,
        ProcurementController,
        SimulatedEvaluator,
        SurrogateSource,
        fleet_chains,
        make_ec2_space,
    )
    from repro_torch.device import generator
    from repro_torch.figures import blended_workloads, paper_figures

    os.environ.setdefault("REPRO_BENCH_OUT",
                          str(ROOT / "build" / "chip_smoke_figures"))
    timing = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()

    # (b) the figure modules
    results = []
    for bench in paper_figures.BENCHES + blended_workloads.BENCHES:
        with (capture_walk(ops, captured, "Fig. 4 sweep")
              if bench is paper_figures.fig4_temperature
              else contextlib.nullcontext()):
            results.append(bench("cuda"))
    timing["figures_s"] = time.perf_counter() - t0
    speed = next(r for r in results
                 if r["bench"] == "fig4_engine_speedup")["numbers"]
    print(f"path G fig4_engine_speedup on {speed['device']}: "
          f"{speed['chains']} chains x {speed['steps_per_chain']} steps; "
          f"python Annealer {speed['python_annealer_s']:.4f} s, fleet cold "
          f"{speed['fleet_cold_s']:.4f} s, warm {speed['fleet_warm_s']:.4f} "
          f"s; speedup {speed['speedup_warm']:.1f}x warm, "
          f"{speed['speedup_cold']:.1f}x cold")
    for r in results:
        check(r["ok"], f"path G {r['bench']} ({r['paper_ref']}): "
                       f"{sum(c['ok'] for c in r['checks'])}/"
                       f"{len(r['checks'])} checks in {r['wall_s']:.2f} s")

    # (c) the controller: two plans, then the online loop
    space = make_ec2_space(EC2_CATALOG_ADJUSTED)
    enc = space.encoded()

    def controller(source=None):
        return ProcurementController(
            space=space, catalog=EC2_CATALOG_ADJUSTED,
            evaluator=SimulatedEvaluator(EC2_CATALOG_ADJUSTED,
                                         noise_std=0.02),
            objective=Objective(lambda_cost=1.0), blend=dict(BLEND_BEFORE),
            evaluate_blend=True, schedule=1.0, seed=0,
            objective_source=source, device="cuda")

    before = dict(ops.LAUNCHES)
    plans = {}
    for label in ("exhaustive", "surrogate"):
        source = (SurrogateSource(n_probe=32, seed=1) if label == "surrogate"
                  else None)
        ctrl = controller(source)
        seen = {}
        if source is None:
            real_fn = ctrl._plan_objective

            def record(decoded, real_fn=real_fn, seen=seen):
                y = real_fn(decoded)
                seen[tuple(space.encode(decoded))] = y
                return y

            ctrl._plan_objective = record
        else:
            real_table = source.table

            def record_table(*a, real_table=real_table, seen=seen, **k):
                table = real_table(*a, **k)
                seen.update({tuple(int(i) for i in s): float(table[tuple(s)])
                             for s in zip(*np.nonzero(np.isfinite(table)))})
                return table

            source.table = record_table
        n0 = dict(ops.LAUNCHES)
        t1 = time.perf_counter()
        cfg, y = ctrl.plan()
        torch.cuda.synchronize()
        timing[f"plan_{label}_s"] = time.perf_counter() - t1
        walks = ops.LAUNCHES["anneal_walk"] - n0["anneal_walk"]
        interps = ops.LAUNCHES["fused_interp"] - n0["fused_interp"]
        y_min = min(seen.values())
        print(f"path G plan ({label}): {len(seen)} table states, planned "
              f"({cfg.instance_type}, {cfg.n_workers} cores) y {y:.4f}, "
              f"table's valid minimum {y_min:.4f}; anneal_walk {walks}, "
              f"fused_interp {interps} launches; "
              f"{timing[f'plan_{label}_s']:.3f} s")
        check(walks == 1, f"path G plan ({label}): one anneal_walk launch "
                          f"for the offline plan (got {walks})")
        check(label == "exhaustive" or interps >= 1,
              f"path G plan ({label}): the table was interpolated on the "
              f"card ({interps} fused_interp launches)")
        check(np.isfinite(y) and y <= 1.02 * y_min,
              f"path G plan ({label}): y {y:.4f} within 1.02x of the "
              f"table's valid minimum {y_min:.4f}")
        check(ctrl.annealer.y is None and space.decode(
            ctrl.annealer.state)["n_workers"] == cfg.n_workers,
            f"path G plan ({label}): the online chain warm-starts at the "
            f"plan, its objective unmeasured")
        plans[label] = (ctrl, y_min, seen)
    ctrl, y_min, _ = plans["exhaustive"]
    t1 = time.perf_counter()
    ds = ctrl.run(G_SUBMITS)
    timing["submits_s"] = time.perf_counter() - t1
    _, best_y = ctrl.best_config()
    walks = ops.LAUNCHES["anneal_walk"] - before["anneal_walk"]
    print(f"path G: {G_SUBMITS} jobs in {timing['submits_s']:.3f} s, best "
          f"y {best_y:.4f}, exploration rate "
          f"{ctrl.exploration_rate():.3f}, spend ${ctrl.spend():.2f}; "
          f"anneal_walk {walks} launches in (c)")
    check(len(ds) == G_SUBMITS and all(np.isfinite(d.y) for d in ds),
          f"path G: {G_SUBMITS} decisions, every y finite")
    check(walks == 2, f"path G (c): one anneal_walk launch per offline_plan "
                      f"(2 plans, got {walks})")
    check(best_y <= 1.05 * y_min,
          f"path G: the best measured y {best_y:.4f} within 1.05x of the "
          f"planning table's minimum {y_min:.4f}")

    # (d) fleet_chains at a fleet's size, per-tenant tables and penalties
    rng = np.random.default_rng(0)
    table = np.zeros(enc.size())          # the exhaustive plan's table
    for s, y in plans["exhaustive"][2].items():
        table[np.ravel_multi_index(s, enc.shape)] = y
    T, S = G_TENANTS, G_FLEET_STEPS
    tables = (table[None, :] * rng.uniform(0.8, 1.25, (T, 1))
              + rng.normal(0.0, 1.0, (T, enc.size()))).astype(np.float32)
    extra = rng.uniform(0.0, 5.0, (T, enc.size())).astype(np.float32)
    taus = np.broadcast_to(rng.uniform(0.5, 2.0, (T, 1)), (T, S)) \
        .astype(np.float32)
    inits = np.stack([rng.integers(0, n, T) for n in enc.shape],
                     -1).astype(np.int32)
    kw = dict(shape=enc.shape, categorical=enc.categorical, device="cuda")
    t1 = time.perf_counter()
    with capture_walk(ops, captured, "fleet_chains bucket"):
        padded = fleet_chains(generator(0, device=dev), tables, None, taus,
                              inits, extra, **kw)
    torch.cuda.synchronize()
    timing["fleet_s"] = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    flat = fleet_chains(generator(0, device=dev), tables, None, taus, inits,
                        extra, bucket=False, **kw)
    torch.cuda.synchronize()
    P = captured["fleet_chains bucket"][0][3].shape[0]
    print(f"path G fleet_chains: {T} tenants padded to {P} x {S} steps in "
          f"{timing['fleet_s'] * 1e3:.2f} ms (first call); accept rate "
          f"{float(padded[2].float().mean()):.3f}")
    check(P == 1024 and all(a.shape[0] == T and torch.equal(a, b)
                            for a, b in zip(padded, flat)),
          f"path G fleet_chains: rows 0..{T - 1} of the {P}-chain bucket "
          f"bit-equal to the unpadded walk")
    timing["total_s"] = time.perf_counter() - t0
    print(f"path G: launches {launches}; {timing['total_s']:.1f} s")
    return launches, timing


# -- path H: the multi-tenant fleet --------------------------------------------

#: path H's workloads, ``repro_torch.figures.trace_fleet``'s controller at
#: the reference's constants (``benchmarks/trace_fleet.py:46-52``): (a) its
#: smoke replay, 64 tenants over 600 s of trace seed 64 (the one
#: ``BENCH_trace.json`` holds), on the card and on the host; (b) its full
#: configuration, 1,024 tenants (trace and controller seed 1,024), and the
#: 64-tenant baseline, over the reference's 3,600 s, ``H_TURNS`` turns of
#: each in alternation, each begun after a full collection (a size's wall
#: time is its fastest turn's: a round is host work, and the host's clock
#: varies from turn to turn)
H_SMOKE = (64, 600.0)
H_TENANTS, H_HORIZON_S = 1024, 3600.0
H_TURNS = 5
H_PROFILE_TICKS = 8


@contextlib.contextmanager
def counted_rounds(torch, ops, fleet, log: list):
    """While open, each ``fleet.round()`` appends (chains annealed,
    ``anneal_walk`` launches, synchronizing CUDA calls) to ``log``.  The
    last are counted by torch's sync debug mode: each call where the host
    waits on the card, a read-back or a blocking copy."""
    import warnings

    real = fleet.round

    def counted():
        n0 = ops.LAUNCHES["anneal_walk"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = real()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)
        log.append((fleet.last_annealed, ops.LAUNCHES["anneal_walk"] - n0,
                    syncs))
        return out

    fleet.round = counted
    try:
        yield
    finally:
        del fleet.round


class Ticks:
    """A trace replay advanced one tick at a time (``round()``): the
    tick's events applied, then one fleet round, as
    ``TraceReplayController.replay`` does each tick."""

    def __init__(self, ctl):
        from repro_torch.workloads.trace import replay_ticks

        self.ctl = ctl
        self.ticks = replay_ticks(ctl.trace, ctl.control_period_s)

    def round(self):
        _, events = next(self.ticks)
        self.ctl._apply_events(events)
        return self.ctl.fleet.round()


def decision_log(ctl) -> list[tuple]:
    """A replay's FleetDecision log, every field as plain values."""
    import dataclasses

    return [dataclasses.astuple(d) for d in ctl.fleet.decisions]


def path_h(torch, ops, dev, captured, profile: bool) -> tuple[dict, dict]:
    """Path H: the multi-tenant fleet.  (a) ``trace_fleet``'s smoke replay
    (64 tenants, 600 s, ``BENCH_trace.json``'s trace) on the card: SLO
    attainment 1.0 and no violation round, as the reference's; the same
    replay on the host in this process, its FleetDecision log equal field
    for field.  (b) The full configuration, 1,024 tenants over
    ``H_HORIZON_S``, and the 64-tenant baseline over the same horizon,
    ``H_TURNS`` turns of each in alternation: the reference's four claims
    (no violation in the final quarter, SLO attainment >= 0.8, < 60% of
    tenant-rounds annealed, wall time <= half the 16x tenant ratio, each
    size's fastest turn), one ``anneal_walk`` launch in each round that
    annealed a chain (none in the others) and at most one synchronizing
    call (the read-back) a round.  Returns (launches, timings)."""
    import numpy as np

    from repro_torch.core import chain_bucket
    from repro_torch.figures import trace_fleet as tf

    timing = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    t_h = time.perf_counter()

    def replay(T, horizon, device, keep_log=False, capture=None):
        ctl = tf.controller(T, horizon, seed=T, keep_decision_log=keep_log,
                            device=device)
        # each replay starts from the same collector state: no garbage or
        # promotion count carried over from the last one
        gc.collect()
        log = []
        with (counted_rounds(torch, ops, ctl.fleet, log) if device == "cuda"
              else contextlib.nullcontext()), \
                (capture_walk(ops, captured, capture, largest=True)
                 if capture else contextlib.nullcontext()):
            t0 = time.perf_counter()
            summary = ctl.replay()
            total = time.perf_counter() - t0
        return ctl, summary, log, total

    def check_rounds(label, ctl, log):
        walks_ok = all(w == (a > 0) for a, w, _ in log)
        syncs = [k for _, _, k in log]
        check(len(log) == len(ctl.rounds) and walks_ok,
              f"path H {label}: one anneal_walk launch in each of the "
              f"{sum(a > 0 for a, _, _ in log)} rounds that annealed a "
              f"chain, none in the other {sum(a == 0 for a, _, _ in log)}")
        check(max(syncs) <= 1,
              f"path H {label}: at most one synchronizing call a round "
              f"(the read-back): {sum(syncs)} in {len(log)} rounds, at "
              f"most {max(syncs)}")

    # (a) the smoke replay, card against host
    T, horizon = H_SMOKE
    ctl, summary, log, total = replay(T, horizon, "cuda", keep_log=True)
    host, host_summary, _, host_total = replay(T, horizon, "cpu",
                                               keep_log=True)
    timing["smoke_s"], timing["smoke_host_s"] = total, host_total
    print(f"path H (a): {T} tenants over {horizon:.0f} s on the card: "
          f"{summary['rounds']} rounds, {summary['tenant_rounds']} "
          f"tenant-rounds, annealed fraction "
          f"{summary['annealed_fraction']:.4f}, peak "
          f"{summary['peak_tenants']} tenants, events "
          f"{summary['events_applied']}, wall {summary['wall_s']:.3f} s "
          f"in rounds, {total:.3f} s in all (host: "
          f"{host_summary['wall_s']:.3f} s in rounds)")
    check(summary["slo_attainment"] == 1.0
          and summary["violation_rounds"] == 0,
          f"path H (a): SLO attainment {summary['slo_attainment']} and "
          f"{summary['violation_rounds']} violation rounds, as the "
          f"reference's BENCH_trace.json (1.0, 0)")
    same = decision_log(ctl) == decision_log(host)
    check(same and {k: v for k, v in summary.items() if k != "wall_s"}
          == {k: v for k, v in host_summary.items() if k != "wall_s"},
          f"path H (a): the card's {len(ctl.fleet.decisions)} decisions "
          f"equal the host's field for field, and so does the summary")
    check_rounds("(a)", ctl, log)

    # (b) the full configuration and its baseline over the same horizon,
    # in alternating turns (64, 1,024, 64, ...): each size's wall time is
    # its fastest turn's, the host's clock being noisy at a few ms a round
    walls = {T: [] for T in (H_SMOKE[0], H_TENANTS)}
    for turn, T in enumerate(H_TURNS * (H_SMOKE[0], H_TENANTS)):
        ctl, summary, log, total = replay(
            T, H_HORIZON_S, "cuda",
            capture="path H round" if turn == 1 else None)
        walls[T].append(summary["wall_s"])
        tail = [r["violation"] for r in
                ctl.rounds[-max(len(ctl.rounds) // 4, 1):]]
        annealed = [a for a, _, _ in log if a]
        print(f"path H (b), turn {turn // 2 + 1} of {H_TURNS}: {T} "
              f"tenants over {H_HORIZON_S:.0f} s: "
              f"{summary['rounds']} rounds, {summary['tenant_rounds']} "
              f"tenant-rounds, peak {summary['peak_tenants']}, annealed "
              f"fraction {summary['annealed_fraction']:.4f} (chains a "
              f"round {min(annealed, default=0)}-{max(annealed, default=0)}"
              f", buckets {sorted({chain_bucket(a) for a in annealed})}), "
              f"SLO attainment {summary['slo_attainment']:.4f}, violation "
              f"rounds {summary['violation_rounds']}; wall "
              f"{summary['wall_s']:.3f} s in rounds "
              f"({1e3 * summary['wall_s'] / summary['rounds']:.2f} ms a "
              f"round), {total:.3f} s in all")
        timing[f"wall_{T}_s"] = min(walls[T])
        timing[f"total_{T}_s"] = total
        timing[f"rounds_{T}"] = summary["rounds"]
        if T != H_TENANTS:
            continue
        check(float(np.sum(tail)) == 0.0,
              f"path H (b): T={T}: zero aggregate violations in the final "
              f"25% of rounds")
        check(summary["slo_attainment"] >= 0.8,
              f"path H (b): T={T}: SLO attainment under churn >= 0.8 "
              f"({summary['slo_attainment']:.4f})")
        check(summary["annealed_fraction"] < 0.6,
              f"path H (b): T={T}: incremental rounds anneal < 60% of "
              f"tenant-rounds ({summary['annealed_fraction']:.4f})")
        check_rounds(f"(b) T={T}", ctl, log)
    lin = H_TENANTS / H_SMOKE[0]
    ratio = timing[f"wall_{H_TENANTS}_s"] / timing[f"wall_{H_SMOKE[0]}_s"]
    timing["ratio"] = ratio
    check(ratio <= lin / 2,
          f"path H (b): the {H_TENANTS}-tenant replay sub-linear against "
          f"{H_SMOKE[0]} tenants: wall ratio {ratio:.2f}x <= "
          f"{lin / 2:.0f}x (half the {lin:.0f}x tenant ratio; the fastest "
          f"of {H_TURNS} turns each, every turn's wall in rounds: "
          f"{H_TENANTS} tenants {walls[H_TENANTS]} s, {H_SMOKE[0]} "
          f"{walls[H_SMOKE[0]]} s; turn by turn "
          f"{[a / b for a, b in zip(walls[H_TENANTS], walls[H_SMOKE[0]])]})")
    launches = dict(ops.LAUNCHES)
    timing["total_s"] = time.perf_counter() - t_h
    args = captured["path H round"][0]
    print(f"path H: launches {launches}; the largest walk "
          f"{walk_shape(args)}; {timing['total_s']:.1f} s")

    if profile:
        # the first ticks of the 1,024-tenant replay (the founding
        # cohort's settle rounds, then incremental ones), untraced, then
        # traced on a fresh controller
        def ticks():
            return Ticks(tf.controller(H_TENANTS, H_HORIZON_S,
                                       seed=H_TENANTS,
                                       keep_decision_log=False,
                                       device="cuda"))

        run = ticks()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(H_PROFILE_TICKS):
            run.round()
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3 / H_PROFILE_TICKS
        profile_rounds(torch, ticks(), H_PROFILE_TICKS,
                       f"path H ({H_TENANTS} tenants, ticks "
                       f"0-{H_PROFILE_TICKS - 1})", untraced_ms,
                       share_of="anneal_walk")
        # where a round's host time goes: the fleet's own spans (the
        # telemetry span recorder, armed for one more replay of each size)
        from repro_torch.telemetry import spans

        for T in (H_SMOKE[0], H_TENANTS):
            ctl = tf.controller(T, H_HORIZON_S, seed=T,
                                keep_decision_log=False, device="cuda")
            spans.enable(spans.SpanRecorder(capacity=1 << 20))
            try:
                summary = ctl.replay()
            finally:
                rec = spans.disable()
            per = {}
            for name, _, _, dur, *_ in rec.spans():
                per[name] = per.get(name, 0.0) + dur / 1e3
            rounds = summary["rounds"]
            print(f"profile path H ({T} tenants, {rounds} rounds, spans): "
                  + ", ".join(f"{k} {v / rounds:.3f}"
                              for k, v in sorted(per.items()))
                  + f" ms a round; the round's own wall "
                  f"{1e3 * summary['wall_s'] / rounds:.3f} ms")
    return launches, timing


#: Bytes the card's memory moves at once (an L2 sector).
SECTOR = 32


def walk_reads(torch, args, kw, out) -> dict:
    """The bytes one walk needed of its table, extra rows and valid mask,
    found from its own inputs and outputs: each step's proposal is
    ``propose_nd`` of the state before it, the table (and the extra rows)
    are read at the starting states and the proposals, the mask at least
    at the accepted proposals.  Counted as distinct 32-byte sectors, the
    least the card's memory moves.  Checks that the kernel's objectives
    are the table's entries at those proposals (a noise-free walk), so
    the count follows the walk that ran."""
    from repro_torch.core.neighborhood import propose_nd, row_major_strides

    inits, table, _, axis, up, pick, _ = args
    states, ys, accepts = out
    C, S = axis.shape
    shape, size, dev = kw["shape"], table.shape[-1], axis.device
    x = torch.cat([inits[:, None], states[:, :-1]], 1).long()
    z = propose_nd(x.reshape(C * S, len(shape)), axis.reshape(-1),
                   up.reshape(-1), pick.reshape(-1),
                   torch.tensor(shape, device=dev),
                   torch.tensor(kw["categorical"], device=dev))
    strides = torch.tensor(row_major_strides(shape), device=dev)
    zi = (z * strides).sum(-1).reshape(C, S)
    x0 = (inits.long() * strides).sum(-1)
    c = torch.arange(C, device=dev)[:, None]
    t = torch.arange(S, device=dev)[None]
    tab_time = size if kw.get("dynamic") else 0
    tab_chain = (S * tab_time or size) if kw.get("per_chain") else 0

    def sectors(idx, itemsize):
        return SECTOR * int(torch.unique(
            idx.reshape(-1) * itemsize // SECTOR).numel())

    at_step = c * tab_chain + t * tab_time + zi
    reads = dict(table=sectors(torch.cat([c[:, 0] * tab_chain + x0,
                                          at_step.reshape(-1)]), 4),
                 extra=0, valid=0)
    want = table.reshape(-1)[at_step]
    if kw.get("extra") is not None:
        reads["extra"] = sectors(torch.cat([c[:, 0] * size + x0,
                                            (c * size + zi).reshape(-1)]), 4)
        want = want + kw["extra"].reshape(-1)[c * size + zi]
    if kw.get("valid") is not None:
        reads["valid"] = sectors(zi[accepts], 1)
    if not kw.get("noise_std", 0.0) > 0:
        check(bool(((ys == want) | (ys.isnan() & want.isnan())).all()),
              f"anneal_walk ({walk_shape(args)}): its objectives are the "
              f"table's entries at the proposals counted for its bound")
    return reads


def dependent_load_ns(torch, build, footprint: int,
                      n_timed: int = 1 << 16) -> float:
    """Nanoseconds of one global load whose address is the load before
    it, when the loads wander over ``footprint`` bytes: one thread chases
    a random single cycle through the footprint's 32-byte sectors
    (``kernels/probes/dependent_load.cu``); a chase of one pass plus
    ``n_timed`` loads less one of the pass alone (which warms the
    caches), over ``n_timed``.  Warm, so the least such a load takes at
    that footprint."""
    import ctypes

    fn = build.library("dependent_load").dependent_load_chase
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    words = SECTOR // 4
    m = max(footprint // SECTOR, 2)
    order = torch.randperm(m, generator=torch.Generator().manual_seed(0))
    nxt = torch.zeros(m * words, dtype=torch.int32)
    nxt[order * words] = (order.roll(-1) * words).to(torch.int32)
    nxt = nxt.cuda()
    out = torch.empty(1, dtype=torch.int32, device="cuda")

    def chase(steps):
        err = fn(nxt.data_ptr(), steps, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dependent_load_chase: cudaError_t {err}")

    t_pass = time_ms(torch, lambda: chase(m), 5)
    t_more = time_ms(torch, lambda: chase(m + n_timed), 5)
    return (t_more - t_pass) * 1e6 / n_timed


def walk_plan_of(ops, args, kw):
    """The plan ``ops.anneal_walk`` makes for these inputs on this card."""
    inits, table, _, axis = args[:4]
    C, S = axis.shape
    smem, sms = ops._card_limits(axis.device)
    return ops.walk_plan(
        C, S, inits.shape[1], table.shape[-1], per_chain=kw["per_chain"],
        dynamic=kw["dynamic"], extra=kw.get("extra") is not None,
        valid=kw.get("valid") is not None, noisy=kw["noise_std"] > 0,
        smem_limit=smem, sms=sms)


def time_walk(torch, ops, ref, build, captured) -> list[dict]:
    """``anneal_walk`` at path A's round, Fig. 4's sweep,
    ``fleet_chains``' bucket and path B's round, on the inputs those paths
    gave it, each with a cold L2: kernel, plain version, its bound (the
    bytes: draws, temperatures and starts read once, the table's, extra
    rows' and mask's sectors that the walk looked up (``walk_reads``),
    states, objectives and flags written once; about 20 float32
    operations a step), its latency bound (S dependent table loads, each
    at least the chase's time over the table bytes it read) and the time
    of its first chain alone (``chain_ms``: the S dependent steps the
    kernel cannot overlap), printed as nanoseconds a step beside the
    chase's dependent load, with the kernel's plan and its ptxas lines."""
    log = build.build_log.get("anneal_walk", (0.0, ""))[1]
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"anneal_walk ptxas: {line.strip()}")
    rows = []
    for label, iters, plain_iters in (("path A round", 200, 10),
                                      ("Fig. 4 sweep", 20, 2),
                                      ("fleet_chains bucket", 200, 10),
                                      ("path B round", 200, 10),
                                      ("path H round", 200, 10)):
        args, kw = captured[label]
        inits, _, _, axis = args[:4]
        C, S = axis.shape
        ndim = inits.shape[1]
        reads = walk_reads(torch, args, kw, ops.anneal_walk(*args, **kw))
        footprint = reads["table"] + reads["extra"]
        ns = dependent_load_ns(torch, build, footprint)
        nbytes = (4 * inits.numel() + footprint + reads["valid"]
                  + 25 * C * S + C * S * (4 * ndim + 5))
        if kw.get("noise_std", 0.0) > 0:
            nbytes += 4 * C * (S + 1)
        one = [a[:1] for a in args]
        if not kw.get("per_chain"):
            one[1] = args[1]
        kw1 = {k: (v[:1] if k in ("extra", "noise", "noise0")
                   and v is not None else v) for k, v in kw.items()}
        rows.append(dict(
            name="anneal_walk", label=label, shape=walk_shape(args),
            plan=walk_plan_of(ops, args, kw),
            ms=time_cold_ms(torch, lambda: ops.anneal_walk(*args, **kw),
                            iters),
            plain_ms=time_cold_ms(torch, lambda: ref.anneal_walk_ref(
                *args, **kw), plain_iters, warm=1),
            chain_ms=time_cold_ms(torch, lambda: ops.anneal_walk(
                *one, **kw1), iters),
            library_ms=None, latency_bound_ms=S * ns * 1e-6,
            dep_load_ns=ns, table_bytes=footprint, steps=S,
            **bound(nbytes, 20 * C * S, FP32_OPS_PER_S)))
    for row in rows:
        print_row(row)
        lat = row["latency_bound_ms"]
        held = max(lat, row["bound_ms"])
        by = "latency" if lat > row["bound_ms"] else row["bound_by"]
        print(f"anneal_walk {row['label']}: {row['plan']}; latency bound "
              f"{lat:.4f} ms ({row['dep_load_ns']:.2f} ns a dependent load "
              f"over {row['table_bytes']} B of table); the larger bound "
              f"{held:.4f} ms ({by}), {held / row['ms']:.4f} of the "
              f"kernel's time; one chain alone {row['chain_ms']:.4f} ms, "
              f"{row['chain_ms'] / row['ms']:.4f} of the walk's time, "
              f"{row['chain_ms'] * 1e6 / row['steps']:.1f} ns a step "
              f"against {row['dep_load_ns']:.2f} ns a dependent load")
    return rows


def bound(nbytes: float, nops: float, peak_ops: float) -> dict:
    """The least time for moving ``nbytes`` and doing ``nops`` on the
    card, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / peak_ops
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                nbytes=nbytes, nops=nops)


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
    build.build_all(tuple(build.SOURCES) + tuple(build.PROBES))
    build_s = time.perf_counter() - t0
    print(f"built {sorted(build.build_log)} in {build_s:.2f} s (parallel)")
    check(set(build.build_log) == set(build.SOURCES) | set(build.PROBES),
          "every kernel source and probe was built in this run")
    for name, (secs, log) in sorted(build.build_log.items()):
        print(f"  {name}: nvcc {secs:.2f} s")
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the instance, e.g. flash_attention_bf16_kernelILi128...
                mangled = line.split("'")[1].split("_cu_")[-1]
                print("    " + re.sub(r"^[0-9a-f]{8}\d+", "", mangled)[:60])
            elif "registers" in line or "spill" in line:
                print("    " + line.strip())

    from repro_torch.core import sizing as sz
    from repro_torch.core.surrogate import SurrogateSource
    from repro_torch.workloads import microservice as ms

    small, large = make_specs(sz, ms)
    records = {}

    # -- 3. each kernel against its plain version, on the card --------------
    f32 = torch.float32
    sl_args = path_a_rows(torch, small, dev)
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

    fi_real = path_b_chunk(torch, large, dev)
    xq_b, xm_b, y_b, _ = fi_real
    (Q, F), M = xq_b.shape, xm_b.shape[0]
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
    for name, err in check_attention_kernels(torch, ops, ref, dev).items():
        records[name] = {"max_abs_err": err}
    check_exact_sums(torch, ops, dev)
    for name, err in check_training_kernels(torch, ops, ref, dev).items():
        records[name] = {"max_abs_err": err}
    for name, err in check_recurrent_kernels(torch, ops, ref, dev, xq_b,
                                             xm_b).items():
        records[name] = {"max_abs_err": err}
    torch.cuda.synchronize()

    # -- 4. path A: coarse menu, drifting mix, whole-grid tables ------------
    n_a, change_at = 12, 4
    opt = {k: float(sz.sizing_table_device(small, m, device=dev).min())
           for k, m in (("day", MIX_DAY), ("evening", MIX_EVENING))}
    sched = ms.DriftingMix(MIX_DAY, MIX_EVENING, change_at=change_at)
    ctrl_a = sz.SizingController(small, sched, steps_per_round=64,
                                 n_chains=16, seed=0, device="cuda")
    captured = {}                 # inputs the paths gave anneal_walk
    torch.cuda.synchronize()
    ops.reset_launches()
    round_s_a = []
    ds_a = []
    walks_a = []
    for r in range(n_a):
        n0 = ops.LAUNCHES["anneal_walk"]
        t0 = time.perf_counter()
        with capture_walk(ops, captured, "path A round"):
            ds_a.append(ctrl_a.round())
        torch.cuda.synchronize()
        round_s_a.append(time.perf_counter() - t0)
        walks_a.append(ops.LAUNCHES["anneal_walk"] - n0)
    launches_a = dict(ops.LAUNCHES)
    print(f"path A: {small.space.size():,} states, {n_a} rounds, launches "
          f"{launches_a}, round wall s {[round(s, 4) for s in round_s_a]}, "
          f"anneal_walk launches per round {walks_a}")
    check(walks_a == [1] * n_a,
          "path A: one anneal_walk launch per round (its one anneal_fleet "
          "call)")
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
    walks_b = []
    for _ in range(n_b):
        n0 = ops.LAUNCHES["anneal_walk"]
        t0 = time.perf_counter()
        with capture_walk(ops, captured, "path B round"):
            ds_b.append(ctrl_b.round())
        torch.cuda.synchronize()
        round_s_b.append(time.perf_counter() - t0)
        walks_b.append(ops.LAUNCHES["anneal_walk"] - n0)
    launches_b = dict(ops.LAUNCHES)
    builds = len(ctrl_b._tables)
    per_build = -(-large.space.size() // 8192)
    print(f"path B: {large.space.size():,} states, {n_b} rounds, "
          f"{builds} table build(s), launches {launches_b}, round wall s "
          f"{[round(s, 4) for s in round_s_b]}, measures {src_b.counts()}, "
          f"anneal_walk launches per round {walks_b}")
    check(walks_b == [1] * n_b,
          "path B: one anneal_walk launch per round (its one anneal_fleet "
          "call)")
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
        profile_table_build(torch, ctrl_b)

    # -- 5b. path G: the paper's procurement loop ---------------------------
    t_g = time.perf_counter()
    records["anneal_walk"] = {"max_abs_err": check_walk_kernel(
        torch, ops, ref, dev, captured)}
    launches_g, timing_g = path_g(torch, ops, dev, captured)
    print(f"path G with its kernel checks: "
          f"{time.perf_counter() - t_g:.1f} s")

    # -- 5c. path H: the multi-tenant fleet ---------------------------------
    launches_h, timing_h = path_h(torch, ops, dev, captured, profile)

    # -- 6. paths C, E, F: the annealed serve loop at full size ------------
    from repro_torch.configs import get_config

    qwen = get_config("qwen3-8b")
    rg = get_config("recurrentgemma-2b")
    rwkv = get_config("rwkv6-7b")
    launches_serve = {}
    for label, config, rounds in (("C", qwen, SERVE_ROUNDS),
                                  ("E", rg, RECURRENT_ROUNDS),
                                  ("F", rwkv, RECURRENT_ROUNDS)):
        serve, launches_serve[label] = serve_path(torch, ops, config, label,
                                                  rounds)
        del serve
        torch.cuda.empty_cache()
        if profile:
            profile_serve(torch, config, 16)
    launches_c = launches_serve["C"]

    # -- 7. path D: training repro-100m at full size, then annealed -------
    train_timing, launches_d = path_d(torch, ops, ref, profile)

    # -- 8. the whole model on the card against the plain path on the host --
    records["model_check"] = {"max_abs_err": whole_model_check(torch, qwen)}
    torch.cuda.empty_cache()
    whole_model_check(torch, rg, n_layers=3)       # (R, R, A)
    torch.cuda.empty_cache()
    whole_model_check(torch, rwkv)
    torch.cuda.empty_cache()
    train_step_check(torch, get_config("repro-100m"))
    torch.cuda.empty_cache()
    qwen_train_step(torch, ops, qwen)

    # -- 9. times at the path shapes ----------------------------------------
    nb = sum(t.numel() * t.element_size() for t in sl_args) \
        + 2 * B * K * 4
    edges = int(sl_args[4].sum())
    # per row: c_max Erlang-B steps (4 ops) + ~12 for the sojourn, per
    # tier; K relaxation steps over the E edges and K nodes (2 ops each)
    nops = B * (K * (4 * c_max + 12) + K * (edges + 2 * K))
    sl_bound = max(nb / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
    records["sizing_latency"].update(
        ms=time_cold_ms(torch, lambda: ops.sizing_latency(
            *sl_args, c_max=c_max), 100),
        plain_ms=time_cold_ms(torch, lambda: ref.sizing_latency_ref(
            *sl_args, c_max=c_max), 10),
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
        ms=time_cold_ms(torch, lambda: ops.fused_interp(*fi_real), 100),
        plain_ms=time_cold_ms(torch, lambda: ref.fused_interp_ref(*fi_real),
                              10),
        bound_ms=fi_bound,
        bound_by="bytes" if nb / HBM_BYTES_PER_S >= nops / FP32_OPS_PER_S
        else "operations")
    # the kernel's own cut of the measurements on this card
    split = (ctypes.c_int * 2)()
    build.library("fused_interp").fused_interp_split(
        Q, M, F, torch.cuda.get_device_properties(0).multi_processor_count,
        split)
    n_split, split_len = split
    for name in ("sizing_latency", "fused_interp"):
        rec = records[name]
        print(f"{name}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
              f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
              f"{rec['bound_ms'] / rec['ms']:.4f} of the kernel's time), "
              f"library none" + (f"; {n_split} splits of {split_len} rows"
                                 if name == "fused_interp" else ""))
    # yardsticks of the cold timing: an empty launch (a one-element fill),
    # and two PyTorch elementwise kernels moving path A's bytes
    one = torch.empty(1, device=dev)
    outs = [torch.empty_like(sl_args[0]) for _ in range(2)]

    def stream():
        torch.add(sl_args[0], sl_args[1], out=outs[0])
        torch.add(sl_args[2], sl_args[3], out=outs[1])

    mb = sum(t.numel() * 4 for t in list(sl_args[:4]) + outs) / 1e6
    print(f"yardsticks: empty launch "
          f"{time_cold_ms(torch, lambda: one.fill_(1.0), 100):.4f} ms cold, "
          f"{time_ms(torch, lambda: one.fill_(1.0), 200):.4f} ms warm; two "
          f"torch.add over path A's {mb:.1f} MB "
          f"{time_cold_ms(torch, stream, 100):.4f} ms cold, "
          f"{time_ms(torch, stream, 200):.4f} ms warm")
    del outs
    attn_rows = time_attention(torch, ops, ref, dev)
    train_rows = time_training_kernels(torch, ops, ref, dev)
    rec_rows = time_recurrent(torch, ops, ref, dev, xq_b, xm_b)
    walk_rows = time_walk(torch, ops, ref, build, captured)
    timed = attn_rows + train_rows + rec_rows + walk_rows
    for name in ("flash_attention", "flash_decode", "quantize_int8",
                 "flash_attention_bwd", "rglru_scan", "wkv6",
                 "pairwise_sqdist", "anneal_walk"):
        # the path shape: path C's prefill and step, embed gradient, path
        # D, path E's and F's prefills, path B's grid chunk, path A's round
        row = next(r for r in timed if r["name"] == name)
        records[name].update({k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "latency_bound_ms") if k in row})
        records[name]["shapes"] = record_rows(timed, name)
    print(f"path A mean round {sum(round_s_a[1:]) / (n_a - 1):.4f} s "
          f"(rounds 1-{n_a - 1}), path B round 0 (table build) "
          f"{round_s_b[0]:.3f} s, later rounds "
          f"{sum(round_s_b[1:]) / max(n_b - 1, 1):.4f} s; path D step "
          f"{train_timing['step_ms']:.2f} ms (median), train "
          f"{train_timing['train_s']:.1f} s, anneal "
          f"{train_timing['anneal_s']:.1f} s; path G "
          f"{timing_g['total_s']:.1f} s (figures {timing_g['figures_s']:.1f}"
          f" s, plans {timing_g['plan_exhaustive_s']:.3f} and "
          f"{timing_g['plan_surrogate_s']:.3f} s, {G_SUBMITS} jobs "
          f"{timing_g['submits_s']:.3f} s); path H "
          f"{timing_h['total_s']:.1f} s ({H_TENANTS} tenants: "
          f"{timing_h[f'rounds_{H_TENANTS}']} rounds in "
          f"{timing_h[f'wall_{H_TENANTS}_s']:.3f} s, "
          f"{timing_h['ratio']:.2f}x the {H_SMOKE[0]}-tenant replay's "
          f"{timing_h[f'wall_{H_SMOKE[0]}_s']:.3f} s)")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    # -- 10. the record lines -------------------------------------------------
    meta = {
        "sizing_latency": ("src/repro_torch/kernels/csrc/sizing_latency.cu",
                           "src/repro/kernels/sizing_latency.py:124",
                           launches_a["sizing_latency"]),
        "fused_interp": ("src/repro_torch/kernels/csrc/fused_interp.cu",
                         "src/repro/kernels/surrogate_distance.py:162",
                         launches_b["fused_interp"]),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:132",
                            launches_c["flash_attention"]
                            + launches_d["flash_attention"]
                            + launches_serve["E"]["flash_attention"]),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/decode_attention.py:81",
                         launches_c["flash_decode"]
                         + launches_serve["E"]["flash_decode"]),
        "quantize_int8": ("src/repro_torch/kernels/csrc/quantize_int8.cu",
                          "src/repro/kernels/quantize.py:34",
                          launches_d["quantize_int8"]),
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/ops.py:54 (_fat_bwd, jnp)",
            launches_d["flash_attention_bwd"]),
        "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "src/repro/kernels/rglru_scan.py:62",
                       launches_serve["E"]["rglru_scan"]),
        "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
                 "src/repro/kernels/rwkv6_wkv.py:83",
                 launches_serve["F"]["wkv6"]),
        # on no path of the reference (its tests call it); checked above
        # at path B's shapes, never launched by a main path
        "pairwise_sqdist": ("src/repro_torch/kernels/csrc/pairwise_sqdist.cu",
                            "src/repro/kernels/surrogate_distance.py:72", 0),
        "anneal_walk": ("src/repro_torch/kernels/csrc/anneal_walk.cu",
                        "src/repro/core/annealing.py:447 (_chain_nd_core, "
                        "lax.scan; not a pallas_call)",
                        launches_a["anneal_walk"] + launches_b["anneal_walk"]
                        + launches_g["anneal_walk"]
                        + launches_h["anneal_walk"]),
    }
    kernels = []
    for name, (source, replaces, launches) in meta.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            **({"latency_bound_ms": rec["latency_bound_ms"]}
               if "latency_bound_ms" in rec else {}),
            "shapes": rec.get("shapes", [])})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
