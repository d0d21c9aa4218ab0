"""Build the hand kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` (and each probe of the card in ``probes/``)
has a plain C interface and builds on its own into a shared library
under ``build/kernels/`` at the repository root (``REPRO_TORCH_BUILD_DIR``
overrides), named by a hash of the source, every local header it
includes (``#include "..."``, followed through headers) and the flags,
so an edited source or header is rebuilt and an unchanged one is loaded
as it is.  Nothing is built when the package is imported: the first call
that needs a kernel builds it, and :func:`build_all` builds every source
at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_PROBES = Path(__file__).resolve().parent / "probes"

_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Per-source extra flags.  No source uses --use_fast_math: parity with the
#: plain versions needs IEEE division, expf and sqrtf.  sizing_latency,
#: rglru_scan and anneal_walk also turn off multiply-add contraction (see
#: the notes in their sources): all three are bit-equal to their plain
#: versions.
SOURCES: dict[str, tuple[str, ...]] = {
    "sizing_latency": ("-fmad=false",),
    "fused_interp": (),
    "flash_attention": (),
    "flash_decode": (),
    "flash_attention_bwd": (),
    "quantize_int8": (),
    "rglru_scan": ("-fmad=false",),
    "wkv6": (),
    "pairwise_sqdist": (),
    "anneal_walk": ("-fmad=false",),
}

#: Sources in ``probes/`` that measure the card and compute nothing of a
#: path (``chip_smoke.py`` times the dependent-load chase for the walk's
#: latency bound).  Built as the kernels are, but only when named.
PROBES: dict[str, tuple[str, ...]] = {
    "dependent_load": (),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ``name -> (seconds, ptxas report)`` for every library built by this
#: process (a library found already built is not listed).
build_log: dict[str, tuple[float, str]] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source on first use")


_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """The source of kernel ``name`` and every header beside it that it
    includes, directly or through another header, in the order found."""
    found: list[Path] = []
    todo = [_source(name)]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            header = path.parent / inc
            if header.is_file():
                todo.append(header)
    return found


def _source(name: str) -> Path:
    return (_CSRC if name in SOURCES else _PROBES) / f"{name}.cu"


def _target(name: str) -> tuple[Path, list[str]]:
    flags = list(_COMMON) + list(SOURCES[name] if name in SOURCES
                                 else PROBES[name])
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so", flags


def build_all(names: tuple[str, ...] | None = None) -> dict[str, Path]:
    """Build the named sources (default: every kernel's; a probe only when
    named) that are not built yet, one ``nvcc`` process per source,
    started together; raise with the compiler's output if any fails.
    Returns ``name -> library path``."""
    names = tuple(SOURCES) if names is None else names
    out: dict[str, Path] = {}
    running = []
    compiler = None
    for name in names:
        so, flags = _target(name)
        out[name] = so
        if so.exists():
            continue
        compiler = compiler or nvcc()
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(_source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, so, tmp, proc, time.perf_counter()))
    errors = []
    for name, so, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, so)
        build_log[name] = (time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            _libs[name] = lib
        return lib
