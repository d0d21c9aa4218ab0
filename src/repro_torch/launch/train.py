"""End-to-end training driver, on one device.

The counterpart of the reference package's ``launch/train.py``: config ->
synthetic data pipeline -> train step -> checkpoint manager -> fault
supervisor.  The model (random weights from seed 0, made on the device)
trains on the card through the hand kernels (flash attention forward and
backward, int8 quantization under ``--compression int8``), or on the CPU
through their plain versions with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \\
        --steps 300 [--ckpt-dir DIR] [--fail-at 50 120]

The reference also builds its step on a mesh (``--model-tp``) and feeds
zero stubs to the encoder-decoder and vision families; one card has no
mesh, and only the dense family is ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time

import numpy as np

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..configs.base import ShapeConfig
from ..data import DataConfig, SyntheticLM
from ..optim.optimizer import AdamWConfig
from ..runtime.fault_tolerance import FailureInjector, StepFailure, \
    Supervisor
from ..runtime.train import TrainStepOptions, build_train_step

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainRun:
    """Everything assembled for one training run (rebuildable)."""

    arch: str
    steps: int
    batch: int
    seq: int
    ckpt_dir: str | None
    options: TrainStepOptions
    save_every: int = 50
    device: str = "cuda"

    def build(self):
        config = get_config(self.arch)
        shape = ShapeConfig("host", seq_len=self.seq,
                            global_batch=self.batch, kind="train")
        built = build_train_step(config, shape, self.options, self.device)
        return config, built


def run_training(run: TrainRun, *, injector: FailureInjector | None = None,
                 log_every: int = 10, on_metrics=None):
    """Train ``run.steps`` steps (resuming from ``run.ckpt_dir``'s latest
    checkpoint if there is one).  Returns ``{"state", "final_step",
    "losses", "step_times", "restarts", "events"}``; ``on_metrics(step,
    metrics, seconds)`` sees every step.  A step's time is the host's
    clock around the step and the read of its loss, which waits for the
    device."""
    config, built = run.build()
    data = SyntheticLM(DataConfig(vocab=config.vocab, seq_len=run.seq,
                                  global_batch=run.batch))
    manager = (CheckpointManager(run.ckpt_dir, keep=3)
               if run.ckpt_dir else None)

    def fresh():
        return built.init(0), 0

    state, start = fresh()

    def restore():
        """The latest checkpoint loaded into ``state`` (in place), or a
        fresh state when there is none."""
        nonlocal state
        if manager is None or manager.latest_step() is None:
            state, step = fresh()
            return state, step
        tree, extra = manager.restore(state.tree())
        state.load_tree(tree)
        return state, int(extra.get("step", manager.latest_step()))

    if manager is not None and manager.latest_step() is not None:
        state, start = restore()
    losses: list[float] = []
    times: list[float] = []

    def step_fn(state, step):
        if injector is not None:
            injector.check(step)
        batch = data.batch_at(step)
        t0 = time.perf_counter()
        state, metrics = built.step(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if not np.isfinite(loss):
            raise StepFailure(f"non-finite loss at step {step}")
        losses.append(loss)
        times.append(dt)
        if on_metrics is not None:
            on_metrics(step, metrics, dt)
        if step % log_every == 0:
            log.info("step %5d loss %.4f (%.0f ms)", step, loss, dt * 1e3)
        if manager is not None and (step + 1) % run.save_every == 0:
            manager.save(state.tree(), step + 1, extra={"step": step + 1},
                         blocking=False)
        return state

    sup = Supervisor(restore=restore)
    state, final = sup.run(state, start, run.steps - start, step_fn)
    if manager is not None:
        manager.save(state.tree(), final, extra={"step": final})
    return {"state": state, "final_step": final, "losses": losses,
            "step_times": times, "restarts": sup.restarts,
            "events": sup.events}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--compression", default="none")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    run = TrainRun(
        arch=args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        device=args.device,
        options=TrainStepOptions(
            microbatches=args.microbatches, remat=args.remat,
            compression=args.compression,
            adamw=AdamWConfig(lr=args.lr)))
    injector = (FailureInjector(fail_steps=tuple(args.fail_at))
                if args.fail_at else None)
    out = run_training(run, injector=injector)
    print(f"final step {out['final_step']}  "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}  "
          f"restarts {out['restarts']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
