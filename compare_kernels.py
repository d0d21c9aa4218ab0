#!/usr/bin/env python3
"""Time an earlier checkout's hand kernels against this checkout's.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/earlier
    python3 compare_kernels.py build/earlier/src/repro_torch/kernels/csrc \\
        [KERNEL ...]

KERNEL is any of ``sizing_latency``, ``fused_interp`` and
``pairwise_sqdist`` (default: ``sizing_latency fused_interp``).  It builds
each named kernel's ``.cu`` from the earlier ``csrc`` with this checkout's
flags, binds it through this checkout's C signature (``ops._SIGNATURES``:
the earlier source must export the same interface), and calls both builds
through the same wrappers in ``ops``: ``sizing_latency`` at
``chip_smoke.py``'s path-A rows, the other two at its path-B chunk.  The
outputs must agree: ``sizing_latency`` bit for bit between the builds,
``fused_interp`` within ``INTERP_TOL`` between the builds, and each build
of ``pairwise_sqdist`` within ``SQDIST_TOL`` of its plain version.  Then
each build is timed with a cold L2 (``chip_smoke.time_cold_ms``), in
turns: earlier, this, this, earlier; ``pairwise_sqdist`` also beside the
card's own cold write of its (Q, M) result (``fill_``, timed between the
turns).  Prints the card, the earlier build's ptxas lines and, per kernel,
both means and their ratio; exits non-zero if a check fails.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

KERNELS = ("sizing_latency", "fused_interp", "pairwise_sqdist")
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
    earlier = {}
    for name, lib in build_earlier(
            build, csrc, cs.ROOT / "build" / "compare_kernels",
            names).items():
        sym, argtypes = ops._SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        earlier[name] = fn

    def run(name, which):
        ops._fns[name] = which[name]
        try:
            return calls[name]()
        finally:
            ops._fns[name] = mine[name]

    for name in names:
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
