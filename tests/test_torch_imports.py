"""The PyTorch port stands alone: it imports neither JAX nor the JAX
reference package (``repro``), and nothing decides at import time whether
there is a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = r'''
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(k for k, v in sys.modules.items() if v is not None and (
    k in ("jax", "repro") or k.startswith(("jax.", "jaxlib", "repro."))))
print(len(names), leaked, ",".join(names))
'''


def test_every_port_module_imports_without_jax_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=120)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.strip().split(" ", 1)
    leaked, names = rest.rsplit(" ", 1)
    names = names.split(",")
    assert int(n) >= 55                        # every module was imported
    for mod in ("configs.qwen3_8b", "models.decode", "runtime.serve",
                "serving.anneal", "workloads.simulator", "data.pipeline",
                "runtime.loss", "runtime.train", "runtime.fault_tolerance",
                "optim.optimizer", "optim.compression",
                "checkpoint.checkpointer", "launch.train",
                "launch.train_anneal", "models.rglru", "models.rwkv6",
                "core.fleet", "core.trace_replay", "workloads.trace",
                "figures.trace_fleet", "figures.fleet_arbitration",
                "figures.pipeline_overlap"):
        assert f"repro_torch.{mod}" in names
    assert leaked == "[]"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "compare_kernels.py",
                            ROOT / "fleet_host_costs.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_cuda_request_without_card_raises():
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
