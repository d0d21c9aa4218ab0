#!/usr/bin/env python3
"""Time an earlier checkout's sizing-loop kernels against this checkout's.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/earlier
    python3 compare_kernels.py build/earlier/src/repro_torch/kernels/csrc

It builds ``sizing_latency.cu`` and ``fused_interp.cu`` from the earlier
``csrc`` with this checkout's flags, binds each through this checkout's C
signature (``ops._SIGNATURES``: the earlier source must export the same
interface), and calls both builds through the same wrappers in ``ops``, at
``chip_smoke.py``'s path-A rows and path-B chunk.  The outputs must agree:
``sizing_latency`` bit for bit, ``fused_interp`` within ``INTERP_TOL``.
Then each build is timed with a cold L2 (``chip_smoke.time_cold_ms``), in
turns: earlier, this, this, earlier.  Prints the card, the earlier build's
ptxas lines and, per kernel, both means and their ratio; exits non-zero if
a check fails.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

NAMES = ("sizing_latency", "fused_interp")


def build_earlier(build, csrc: Path, out: Path) -> dict[str, ctypes.CDLL]:
    """Each of NAMES from ``csrc``, one nvcc a source, all at once."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NAMES:
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
    if len(argv) != 1:
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
    from repro_torch.kernels import build, ops
    from repro_torch.workloads import microservice as ms

    small, large = cs.make_specs(sz, ms)
    sl_args = cs.path_a_rows(torch, small, dev)
    fi_args = cs.path_b_chunk(torch, large, dev)
    calls = {
        "sizing_latency": lambda: ops.sizing_latency(*sl_args,
                                                     c_max=small.c_max),
        "fused_interp": lambda: ops.fused_interp(*fi_args),
    }
    mine = {name: ops._kernel(name) for name in NAMES}
    earlier = {}
    for name, lib in build_earlier(
            build, csrc, cs.ROOT / "build" / "compare_kernels").items():
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

    for name in NAMES:
        old, new = run(name, earlier), run(name, mine)
        if name == "sizing_latency":
            same = all(torch.equal(a, b) for a, b in zip(old, new))
            cs.check(same, "earlier sizing_latency bit-equal to this one")
        else:
            same = all(torch.allclose(a, b, **cs.INTERP_TOL)
                       for a, b in zip(old, new))
            cs.check(same, "earlier fused_interp within INTERP_TOL of this")
        t = [cs.time_cold_ms(torch, lambda w=w: run(name, w), 100)
             for w in (earlier, mine, mine, earlier)]
        before, after = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"{name} (cold, in turns): earlier {before:.4f} ms "
              f"({t[0]:.4f}, {t[3]:.4f}), this {after:.4f} ms ({t[1]:.4f}, "
              f"{t[2]:.4f}), {before / after:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
