#!/usr/bin/env python3
"""Time an earlier checkout's hand kernels against this checkout's.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/earlier
    python3 compare_kernels.py build/earlier/src/repro_torch/kernels/csrc \\
        [KERNEL ...]

KERNEL is any of ``sizing_latency``, ``fused_interp``, ``pairwise_sqdist``
and ``anneal_walk`` (default: ``sizing_latency fused_interp``).  It builds
each named kernel's ``.cu`` from the earlier ``csrc`` with this checkout's
flags, binds it through this checkout's C signature (``ops._SIGNATURES``:
the earlier source must export the same interface), and calls both builds
through the same wrappers in ``ops``: ``sizing_latency`` at
``chip_smoke.py``'s path-A rows, ``fused_interp`` and ``pairwise_sqdist``
at its path-B chunk, ``anneal_walk`` at the shapes below.
The outputs must agree: ``sizing_latency`` bit for bit between the builds,
``fused_interp`` within ``INTERP_TOL`` between the builds, each build of
``pairwise_sqdist`` within ``SQDIST_TOL`` of its plain version, and each
build of ``anneal_walk`` bit for bit with its plain version.  Then each
build is timed with a cold L2 (``chip_smoke.time_cold_ms``), in turns:
earlier, this, this, earlier; ``pairwise_sqdist`` also beside the card's
own cold write of its (Q, M) result (``fill_``, timed between the turns).
``anneal_walk`` is timed at five path shapes (``chip_smoke.walk_cases``:
path A's and path B's rounds, Figs. 4's and 5's sweeps, the bucket) and
four large fleets (``WALK_WIDE``), also with its lookups unstaged and with
the other window (the plan overridden), each checked bit-equal and timed
in turns with the planned kernel; then inside path A's and path B's
rounds (traced, the L2 as a round leaves it, no flush), the earlier build
and this one in turns.  Prints the card, the earlier build's
ptxas lines and, per kernel, both means and their ratio; exits non-zero if
a check fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

KERNELS = ("sizing_latency", "fused_interp", "pairwise_sqdist",
           "anneal_walk")
DEFAULT = ("sizing_latency", "fused_interp")


def build_earlier(build, csrc: Path, out: Path,
                  names: tuple[str, ...]) -> dict[str, ctypes.CDLL]:
    """Each of ``names`` from ``csrc``, one nvcc a source, all at once."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        flags = list(build._COMMON) + list(build.SOURCES[name])
        procs[name] = subprocess.Popen(
            [build.nvcc(), *flags, "-o", str(out / f"{name}.so"),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"earlier {name}.cu built")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    earlier {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def bind(ops, name: str, lib: ctypes.CDLL):
    """Kernel ``name``'s launch function in ``lib``, typed as this
    checkout's."""
    sym, argtypes = ops._SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


#: the large fleets: (label, the case tiled, copies of its chains)
WALK_WIDE = (("Fig. 4 sweep x50", "Fig. 4 sweep", 50),
             ("Fig. 4 sweep x200", "Fig. 4 sweep", 200),
             ("fleet_chains bucket x16", "fleet_chains bucket", 16),
             ("fleet_chains bucket x64", "fleet_chains bucket", 64))


def tile_walk(args, kw, k: int):
    """A walk's inputs with its chains repeated ``k`` times."""
    def rep(x):
        return x.repeat((k,) + (1,) * (x.dim() - 1))

    inits, table, taus, axis, up, pick, uniform = args
    kw = dict(kw)
    for key in ("extra", "noise", "noise0"):
        if kw.get(key) is not None:
            kw[key] = rep(kw[key])
    return (rep(inits), rep(table) if kw["per_chain"] else table, rep(taus),
            rep(axis), rep(up), rep(pick), rep(uniform)), kw


def walk_in_round(torch, ctrl, n: int) -> float:
    """The walk kernel's device time a round over ``n`` traced rounds of
    ``ctrl``: the L2 as a round leaves it (the table reused, the draws
    just written), not flushed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ctrl.round()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "anneal_walk_kernel" in e.key) / 1e3 / n


def compare_walk(torch, ops, ref, dev, earlier_lib) -> None:
    """``anneal_walk``: the earlier build, this one, and this one with its
    lookups unstaged and with the other window (32 and 64 steps swapped),
    at the five shapes of ``walk_cases`` and at fleets of 16,000-65,536
    chains (``WALK_WIDE``), cold; then the earlier build and this one
    inside path A's and path B's rounds (``walk_in_round``)."""
    from repro_torch.core import sizing as sz
    from repro_torch.core.surrogate import SurrogateSource
    from repro_torch.workloads import microservice as ms

    cases = cs.walk_cases(torch, ops, dev)
    for label, base, k in WALK_WIDE:
        cases[label] = tile_walk(*cases[base], k)
    mine = (ops._fns["anneal_walk"], ops._walk_set_plan())

    def typed_plan(lib):
        fn = getattr(lib, "anneal_walk_set_plan", None)
        if fn is None:                  # an earlier build takes no plan
            return lambda *a: 0
        fn.argtypes = mine[1].argtypes
        fn.restype = ctypes.c_int
        return fn

    builds = {"earlier": (bind(ops, "anneal_walk", earlier_lib),
                          typed_plan(earlier_lib)),
              "this": mine}
    real_plan = ops.walk_plan

    def variant(**change):
        def plan(C, S, ndim, size, **kw):
            p = real_plan(C, S, ndim, size, **kw)
            window = 96 - p.window if change.get("window") else p.window
            staged = p.staged and change.get("staged", True)
            flags = {k: kw[k] for k in ("per_chain", "dynamic", "extra",
                                        "valid", "noisy")}
            return ops.WalkPlan(window, staged, ops.walk_smem(
                window, staged, ndim, size, **flags))
        return plan

    # (label, build, plan)
    others = [("earlier", "earlier", real_plan),
              ("unstaged", "this", variant(staged=False)),
              ("the other window", "this", variant(window=True))]

    @contextlib.contextmanager
    def using(build, plan):
        ops._fns["anneal_walk"], ops._fns["anneal_walk_set_plan"] = \
            builds[build]
        ops.walk_plan = plan
        try:
            yield
        finally:
            ops._fns["anneal_walk"], ops._fns["anneal_walk_set_plan"] = mine
            ops.walk_plan = real_plan

    def run(build, plan, args, kw):
        with using(build, plan):
            return ops.anneal_walk(*args, **kw)

    def plan_of(plan, args, kw):
        with using("this", plan):
            return cs.walk_plan_of(ops, args, kw)

    def report(label, how, name, turns):
        other, this = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        print(f"anneal_walk {label} ({how}, in turns): {name} {other:.4f} "
              f"ms ({turns[0]:.4f}, {turns[3]:.4f}), this {this:.4f} ms "
              f"({turns[1]:.4f}, {turns[2]:.4f}), {other / this:.2f}x")

    limit = ops._card_limits(dev)[0]
    for label, (args, kw) in cases.items():
        C, S = args[3].shape
        mine_plan = plan_of(real_plan, args, kw)
        print(f"anneal_walk {label} ({cs.walk_shape(args)}): {mine_plan}")
        want = ref.anneal_walk_ref(*args, **kw)
        # a variant whose plan is this one's, or does not fit, is not run
        runs = [(name, build, plan) for name, build, plan in others
                if build == "earlier"
                or plan_of(plan, args, kw) != mine_plan
                and plan_of(plan, args, kw).smem <= limit]
        for name, build, plan in runs + [("this", "this", real_plan)]:
            cs.check(cs.walk_same(torch, run(build, plan, args, kw), want),
                     f"anneal_walk {label}: {name} bit-equal to the plain "
                     f"version")
        del want
        iters = 20 if S * C > 1 << 20 else 200
        # each variant in turns with this build's plan: variant, this,
        # this, variant
        for name, build, plan in runs:
            report(label, "cold", name, [cs.time_cold_ms(
                torch, lambda b=b, p=p: run(b, p, args, kw), iters)
                for b, p in ((build, plan), ("this", real_plan),
                             ("this", real_plan), (build, plan))])
    cases.clear()
    torch.cuda.empty_cache()

    small, large = cs.make_specs(sz, ms)
    ctrls = {"path A round": sz.SizingController(
                 small, cs.MIX_DAY, steps_per_round=64, n_chains=16, seed=0,
                 device="cuda"),
             "path B round": sz.SizingController(
                 large, cs.MIX_DAY, objective_source=SurrogateSource(
                     n_probe=1024, seed=3, device="cuda"),
                 steps_per_round=64, n_chains=16, seed=3, device="cuda")}
    n = 20
    for label, ctrl in ctrls.items():
        for _ in range(2):              # the table built, then reused
            ctrl.round()

        def in_round(build):
            with using(build, real_plan):
                return walk_in_round(torch, ctrl, n)

        report(label, f"in the round, {n} traced rounds a turn", "earlier",
               [in_round(b) for b in ("earlier", "this", "this", "earlier")])


def main(argv: list[str]) -> int:
    names = tuple(argv[1:]) or DEFAULT
    if not argv or any(n not in KERNELS for n in names) \
            or len(set(names)) != len(names):
        print(__doc__, file=sys.stderr)
        return 2
    csrc = Path(argv[0]).resolve()
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    print(cs.card_line())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import sizing as sz
    from repro_torch.kernels import build, ops, ref
    from repro_torch.workloads import microservice as ms

    small, large = cs.make_specs(sz, ms)
    sl_args = cs.path_a_rows(torch, small, dev)
    fi_args = cs.path_b_chunk(torch, large, dev)
    xq, xm = fi_args[:2]
    calls = {
        "sizing_latency": lambda: ops.sizing_latency(*sl_args,
                                                     c_max=small.c_max),
        "fused_interp": lambda: ops.fused_interp(*fi_args),
        "pairwise_sqdist": lambda: (ops.pairwise_sqdist(xq, xm),),
    }
    mine = {name: ops._kernel(name) for name in names}
    libs = build_earlier(build, csrc, cs.ROOT / "build" / "compare_kernels",
                         names)
    earlier = {name: bind(ops, name, libs[name])
               for name in names if name != "anneal_walk"}

    def run(name, which):
        ops._fns[name] = which[name]
        try:
            return calls[name]()
        finally:
            ops._fns[name] = mine[name]

    for name in names:
        if name == "anneal_walk":
            compare_walk(torch, ops, ref, dev, libs["anneal_walk"])
            continue
        old, new = run(name, earlier), run(name, mine)
        if name == "sizing_latency":
            same = all(torch.equal(a, b) for a, b in zip(old, new))
            cs.check(same, "earlier sizing_latency bit-equal to this one")
        elif name == "fused_interp":
            same = all(torch.allclose(a, b, **cs.INTERP_TOL)
                       for a, b in zip(old, new))
            cs.check(same, "earlier fused_interp within INTERP_TOL of this")
        else:
            want = ref.pairwise_sqdist_ref(xq, xm)
            for which, (d2,) in (("earlier", old), ("this", new)):
                cs.check(torch.allclose(d2, want, **cs.SQDIST_TOL),
                         f"{which} pairwise_sqdist within SQDIST_TOL of its "
                         f"plain version")
        t = [cs.time_cold_ms(torch, lambda w=w: run(name, w), 100)
             for w in (earlier, mine, mine, earlier)]
        before, after = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"{name} (cold, in turns): earlier {before:.4f} ms "
              f"({t[0]:.4f}, {t[3]:.4f}), this {after:.4f} ms ({t[1]:.4f}, "
              f"{t[2]:.4f}), {before / after:.2f}x")
        if name == "pairwise_sqdist":
            d2 = new[0]
            fill = cs.time_cold_ms(torch, lambda: d2.fill_(0.0), 100)
            print(f"pairwise_sqdist: the card's cold write of its "
                  f"{d2.numel() * 4 / 1e6:.1f} MB result (fill_) "
                  f"{fill:.4f} ms; earlier {before / fill:.2f}x, this "
                  f"{after / fill:.2f}x of it")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
