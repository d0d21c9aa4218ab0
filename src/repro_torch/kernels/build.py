"""Build the hand kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` has a plain C interface and builds on its own
into a shared library under ``build/kernels/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides), named by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.  Nothing is built when the package is imported: the first call
that needs a kernel builds it, and :func:`build_all` builds every source
at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"

_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Per-source extra flags.  No source uses --use_fast_math: parity with the
#: plain versions needs IEEE division, expf and sqrtf.  sizing_latency and
#: rglru_scan also turn off multiply-add contraction (see the notes in
#: their sources): both are bit-equal to their plain versions.
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


def _target(name: str) -> tuple[Path, list[str]]:
    src = _CSRC / f"{name}.cu"
    flags = list(_COMMON) + list(SOURCES[name])
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so", flags


def build_all(names: tuple[str, ...] | None = None) -> dict[str, Path]:
    """Build the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, started together; raise with the
    compiler's output if any fails.  Returns ``name -> library path``."""
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
        cmd = [compiler, *flags, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
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
