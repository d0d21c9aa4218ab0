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
   path's prefill and decode shapes for the attention kernels), plus
   random ones (every mask kind, softcap, ragged lengths, float32), with
   the JAX tests' tolerances;
4. path A: the container-sizing controller on the 8-tier e-commerce DAG's
   coarse menu (65,536 states), 12 rounds with a day -> evening drift of
   the request mix; whole-grid tables go through ``sizing_latency``;
5. path B: the rich menu (1,679,616 states, past the 200k tabulation cap)
   through ``SurrogateSource(n_probe=1024)``, 3 rounds; every table build
   interpolates the grid through ``fused_interp`` (206 launches);
6. path C: the annealed serve loop (``repro_torch.serving.anneal``) on
   qwen3-8b at its full width and depth (36 layers, random bf16 weights
   from a seed): 6 rounds of 24 requests of 512 tokens, 16 new tokens
   each, batch menu (1, 2, 4, 8, 16); checks every request's tokens and
   that ``flash_attention`` ran 36 times per prefill and ``flash_decode``
   36 times per decode step;
7. a 2-layer model at qwen3-8b's full width, through the kernels on the
   card and with the same weights through the plain path on the host
   (prompt 128, batch 2, 4 teacher-forced decode steps): with the weights
   in float32 the logits agree at the bf16 tolerance, and in bf16 the
   card's gap to the host is within the host's own bf16-vs-float32 gap;
8. times each kernel and its plain version with CUDA events at the path
   shapes (the attention kernels also at PREFILL_32K and DECODE_32K with
   the batch cut), beside the least time the card could take (its bound)
   and, for attention, PyTorch's ``scaled_dot_product_attention`` on the
   same inputs (timed only; the port never calls it);
9. prints one JSON line of kernel records, then the card line, then the
   result line ``{"ok": true, "device": {...}}`` last.

With ``--profile`` it also traces a few more rounds of paths A and B with
``torch.profiler`` (after step 5), and one burst of path C's workload at
batch 16 (after step 6), and prints the device's busy time and idle share
of each.

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

# path C's workload: the defaults of ``python -m repro_torch.serving.anneal``
SERVE_PROMPT, SERVE_NEW, SERVE_REQUESTS, SERVE_ROUNDS = 512, 16, 24, 6

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
    """Trace one burst of path C's workload served at ``batch`` (a prefill
    and its decode steps per batch) with torch.profiler; prints the
    device's busy time and idle share of the burst."""
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
    profile_rounds(torch, burst, 1, f"path C burst at batch {batch}",
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


def path_c(torch, ops, config) -> tuple[dict, dict]:
    """The annealed serve loop at full width and depth; checks every
    round's tokens and the kernels' launches per prefill and decode step.
    Returns (the loop's result, the launches of the whole run)."""
    from repro_torch.serving.anneal import anneal_serving

    L = config.n_layers

    def show(rec):
        print(f"  round {rec['round']} batch {rec['batch']:2d} mean sojourn "
              f"{rec['mean_sojourn_s']:.4f} s ({rec['batches']} batches, "
              f"{rec['decode_steps']} decode steps, {rec['wall_s']:.3f} s) "
              f"launches {rec['launches']}", flush=True)

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = anneal_serving(config, device="cuda", seed=0,
                         prompt_len=SERVE_PROMPT, max_new=SERVE_NEW,
                         requests=SERVE_REQUESTS, rounds=SERVE_ROUNDS,
                         on_round=show)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"path C: {config.name} ({config.param_count() / 1e9:.2f} B "
          f"parameters, {L} layers), init {out['init_s']:.2f} s, "
          f"{SERVE_ROUNDS} rounds in {wall:.1f} s, best batch "
          f"{out['best_batch']} (mean sojourn {out['best_sojourn_s']:.4f} "
          f"s), launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    recs = out["rounds"]
    check(all(r["tokens_ok"] for r in recs),
          f"path C: every request got its {SERVE_NEW} tokens in every round")
    check(all(r["launches"]["flash_attention"] == L * r["batches"]
              for r in recs),
          f"path C: flash_attention launched {L} times per prefill")
    check(all(r["launches"]["flash_decode"] == L * r["decode_steps"]
              for r in recs),
          f"path C: flash_decode launched {L} times per decode step")
    check(launches["sizing_latency"] == launches["fused_interp"] == 0,
          "path C launched no sizing kernel")
    return out, launches


def whole_model_check(torch, config) -> float:
    """A 2-layer model at ``config``'s full width: prefill (prompt 128,
    batch 2) and 4 decode steps through the kernels on the card, then the
    same weights through the plain path on the host, the decode steps
    teacher-forced with the card's tokens.

    In bf16, two correct implementations differ wherever a float32 sum
    lands near a bf16 rounding boundary in one and not the other, and a
    flipped attention score (scores here have a standard deviation near
    11, so the softmax is sharp) moves a whole hidden state: the card's
    logits differ from the host's by a few hundredths at this width (see
    PERF.md).  So the weights are also cast to float32 and run on both
    sides, where no rounding hides a fault: the two implementations must
    agree at the float32 tolerance.  In bf16 the card's gap to the host
    must be no larger than the host's own gap between its bf16 and float32
    runs; that rule only bounds rounding noise, and the float32 run is the
    check that tells a right kernel from a wrong one.  Returns the float32
    run's max abs logit error.
    """
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import generator
    from repro_torch.models.transformer import init_model
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step

    cfg = dataclasses.replace(config, n_layers=2)
    B, S, steps = 2, 128, 4
    shape = ShapeConfig("check", S + steps + 1, B, "decode")
    with torch.no_grad():
        model = init_model(generator(7, device="cuda"), cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    feed = []

    def run(dev):
        t0 = time.perf_counter()
        logits, cache = build_prefill_step(cfg, shape, dev)(
            model, {"tokens": tokens})
        out = [logits.float().cpu()]
        decode = build_decode_step(cfg, shape, dev)
        for i in range(steps):
            if len(feed) == i:
                feed.append(torch.argmax(logits, -1)[:, None].cpu())
            logits, cache = decode(model, cache, feed[i], S + i)
            out.append(logits.float().cpu())
        print(f"  2-layer model, {next(model.parameters()).dtype} on {dev}: "
              f"{time.perf_counter() - t0:.2f} s")
        return out

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    types = {n: p.dtype for n, p in model.named_parameters()}
    runs = {("cuda", "bf16"): run("cuda")}
    with torch.no_grad():
        model = model.float()
    runs["cuda", "f32"] = run("cuda")
    with torch.no_grad():
        model = model.to("cpu")
    runs["cpu", "f32"] = run("cpu")
    with torch.no_grad():                  # back to the weights' own types
        for n, p in model.named_parameters():
            p.data = p.data.to(types[n])
    runs["cpu", "bf16"] = run("cpu")
    err32 = gap(runs["cuda", "f32"], runs["cpu", "f32"])
    for i, (g, w) in enumerate(zip(runs["cuda", "f32"], runs["cpu", "f32"])):
        check(torch.allclose(g, w, **F32_TOL),
              f"2-layer {cfg.d_model}-wide model in float32, "
              f"{'prefill' if i == 0 else f'decode step {i}'}: card logits "
              f"vs host plain path, max abs err "
              f"{float((g - w).abs().max()):.3e} within {F32_TOL}")
    err16 = gap(runs["cuda", "bf16"], runs["cpu", "bf16"])
    rounding = gap(runs["cpu", "bf16"], runs["cpu", "f32"])
    outside = sum(int((~torch.isclose(g, w, **BF16_TOL)).sum()) for g, w in
                  zip(runs["cuda", "bf16"], runs["cpu", "bf16"]))
    total = sum(g.numel() for g in runs["cuda", "bf16"])
    check(err16 <= rounding,
          f"2-layer model in bf16: card vs host max abs logit err "
          f"{err16:.3e} ({outside} of {total:,} logits outside {BF16_TOL}) "
          f"is within the host's own bf16-vs-float32 gap {rounding:.3e}")
    return err32


def time_attention(torch, ops, ref, dev) -> list[dict]:
    """Kernel, plain version and PyTorch's SDPA (``library_ms``) on the
    same inputs, with their bounds: the serve path's shapes, and
    PREFILL_32K / DECODE_32K with the batch cut to 1 and 32."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    rows = []
    H, K, hd = 32, 8, 128
    for label, B, S, iters in (("serve prefill", 16, SERVE_PROMPT, 20),
                               ("PREFILL_32K, batch 1", 1, 32768, 2)):
        q, k, v = rnd((B, S, H, hd)), rnd((B, S, K, hd)), rnd((B, S, K, hd))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        nops = 4 * hd * (S * (S + 1) // 2) * B * H
        rows.append(dict(
            name="flash_attention", label=label,
            shape=f"B {B}, S {S}, H {H}, K {K}, hd {hd}, causal, bf16",
            ms=time_cold_ms(torch, lambda: ops.flash_attention(q, k, v),
                            iters, warm=1),
            plain_ms=time_cold_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v), max(2, iters // 4), warm=1),
            library_ms=time_cold_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True), iters, warm=1),
            **bound(nbytes, nops, BF16_OPS_PER_S)))
        del q, k, v
    W = SERVE_PROMPT + SERVE_NEW + 1
    for label, B, W_, n_valid, iters in (
            ("serve decode step", 16, W, SERVE_PROMPT + SERVE_NEW - 1, 50),
            ("DECODE_32K, batch 32", 32, 32768, 32768, 5)):
        q = rnd((B, 1, H, hd))
        kc, vc = rnd((B, W_, K, hd)), rnd((B, W_, K, hd))
        valid = (torch.arange(W_, device=dev) < n_valid)[None] \
            .expand(B, W_).contiguous()
        nbytes = 2 * (2 * B * n_valid * K * hd + 2 * q.numel()) + B * W_
        nops = 4 * B * H * n_valid * hd
        mask = valid[:, None, None, :]
        rows.append(dict(
            name="flash_decode", label=label,
            shape=f"B {B}, W {W_} ({n_valid} valid), H {H}, K {K}, hd {hd}, "
                  f"bf16",
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
        print(f"{r['name']} {r['label']} ({r['shape']}): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['nbytes'] / 1e6:.1f} MB, "
              f"{r['nops'] / 1e9:.2f} GFLOP)")
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
    for name, err in check_attention_kernels(torch, ops, ref, dev).items():
        records[name] = {"max_abs_err": err}
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

    # -- 6. path C: the annealed serve loop, qwen3-8b at full size ----------
    from repro_torch.configs import get_config

    qwen = get_config("qwen3-8b")
    serve, launches_c = path_c(torch, ops, qwen)
    del serve
    torch.cuda.empty_cache()
    if profile:
        profile_serve(torch, qwen, 16)

    # -- 7. the whole model on the card against the plain path on the host --
    records["model_check"] = {"max_abs_err": whole_model_check(torch, qwen)}
    torch.cuda.empty_cache()

    # -- 8. times at the path shapes ----------------------------------------
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
    for name in ("sizing_latency", "fused_interp"):
        rec = records[name]
        print(f"{name}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
              f" ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"library none")
    attn_rows = time_attention(torch, ops, ref, dev)
    for name in ("flash_attention", "flash_decode"):
        row = next(r for r in attn_rows if r["name"] == name)  # serve shape
        records[name].update({k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"path A mean round {sum(round_s_a[1:]) / (n_a - 1):.4f} s "
          f"(rounds 1-{n_a - 1}), path B round 0 (table build) "
          f"{round_s_b[0]:.3f} s, later rounds "
          f"{sum(round_s_b[1:]) / max(n_b - 1, 1):.4f} s")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    # -- 9. the record lines --------------------------------------------------
    meta = {
        "sizing_latency": ("src/repro_torch/kernels/csrc/sizing_latency.cu",
                           "src/repro/kernels/sizing_latency.py:124",
                           launches_a["sizing_latency"]),
        "fused_interp": ("src/repro_torch/kernels/csrc/fused_interp.cu",
                         "src/repro/kernels/surrogate_distance.py:162",
                         launches_b["fused_interp"]),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:132",
                            launches_c["flash_attention"]),
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/decode_attention.py:81",
                         launches_c["flash_decode"]),
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
            "library_ms": rec.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
