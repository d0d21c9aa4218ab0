"""Train an LM while the paper's annealer tunes the step configuration.

The counterpart of the reference package's ``examples/train_anneal.py``
as a package entry point: train the ~100M LM (``repro-100m``, random
weights from seed 0, made on the device) on the synthetic pipeline WHILE
the online annealing controller tunes the step configuration
(``microbatches`` x ``remat``) from measured step times, the sec. 4.4
experiment pointed at the port's own stack.  Each round runs
``--anneal-every`` real training steps under the proposed configuration
and scores it by its median step time plus ``LAMBDA`` times its price
on the procured service menu (``TPU_CATALOG``, one v5e chip: domain data
the controller chooses from, not this card's price).  The state is
checkpointed after every round.

    PYTHONPATH=src python -m repro_torch.launch.train_anneal \\
        [--steps 300] [--arch repro-100m] [--anneal-every 20] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..configs.base import ShapeConfig
from ..core.annealing import Annealer
from ..core.neighborhood import StepNeighborhood
from ..core.pricing import TPU_CATALOG
from ..core.state import ConfigSpace, Dimension
from ..data import DataConfig, SyntheticLM
from ..runtime.train import TrainStepOptions, build_train_step

LAMBDA = 10.0

#: Where checkpoints go unless ``--ckpt-dir`` says otherwise: the
#: repository's git-ignored ``build/`` directory.
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_anneal_ckpt")


def anneal_training(arch: str = "repro-100m", *, steps: int = 300,
                    batch: int = 4, seq: int = 256, anneal_every: int = 20,
                    tau: float = 0.15,
                    ckpt_dir: str | None = DEFAULT_CKPT_DIR,
                    device: str = "cuda",
                    on_round: Callable[[dict[str, Any]], None] | None = None,
                    ) -> dict[str, Any]:
    """Anneal (microbatches, remat) for ``steps // anneal_every`` rounds of
    ``anneal_every`` training steps each.  Returns ``{"rounds": [...],
    "losses", "steps", "best", "best_y"}``; each round's record holds the
    incumbent configuration and objective after it (``config``, ``y``),
    the configuration it measured (``proposed``) and that one's median
    step time (``step_s``), the exploration flag, the step count and the
    last loss."""
    config = get_config(arch)
    shape = ShapeConfig("e2e", seq_len=seq, global_batch=batch,
                        kind="train")
    data = SyntheticLM(DataConfig(vocab=config.vocab, seq_len=seq,
                                  global_batch=batch))
    manager = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None

    # --- annealable step-config space (TPU adaptation of sec. 4.4) ---
    space = ConfigSpace((
        Dimension("microbatches", (1, 2, 4)),
        Dimension("remat", ("none", "block")),
    ))
    built_cache: dict[tuple, Any] = {}

    def build(decoded):
        key = (decoded["microbatches"], decoded["remat"])
        if key not in built_cache:
            built_cache[key] = build_train_step(
                config, shape,
                TrainStepOptions(microbatches=key[0], remat=key[1]), device)
        return built_cache[key]

    # mutable training state shared with the evaluator
    run: dict[str, Any] = {"state": None, "step": 0, "losses": [], "t": 0.0}

    def run_steps(decoded, k: int) -> float:
        """Run k real training steps under `decoded`; return median secs."""
        built = build(decoded)
        if run["state"] is None:
            run["state"] = built.init(0)
        times = []
        for _ in range(k):
            batch = data.batch_at(run["step"])
            t0 = time.perf_counter()
            run["state"], metrics = built.step(run["state"], batch)
            loss = float(metrics["loss"])
            times.append(time.perf_counter() - t0)
            run["losses"].append(loss)
            run["step"] += 1
        run["t"] = float(np.median(times))
        return run["t"]

    def evaluate(decoded, n) -> float:
        t = run_steps(decoded, anneal_every)
        c = TPU_CATALOG.cost("v5e", 1, t)
        return t + LAMBDA * c

    ann = Annealer(space, StepNeighborhood(space), evaluate,
                   schedule=tau, seed=0,
                   init=space.encode({"microbatches": 4, "remat": "block"}))
    records = []
    for r in range(max(steps // anneal_every, 1)):
        rec = ann.step()
        record = {"round": r, "step": run["step"],
                  "loss": run["losses"][-1],
                  "config": space.decode(rec.state), "y": rec.y_current,
                  "proposed": space.decode(rec.proposed),
                  "step_s": run["t"], "explored": rec.explored}
        records.append(record)
        if on_round is not None:
            on_round(record)
        if manager is not None:
            manager.save(run["state"].tree(), run["step"],
                         extra={"step": run["step"]}, blocking=False)
    if manager is not None:
        manager.wait()
    best_cfg, best_y = ann.best()
    return {"rounds": records, "losses": run["losses"], "steps": run["step"],
            "best": space.decode(best_cfg), "best_y": best_y}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--anneal-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--tau", type=float, default=0.15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def show(rec):
        print(f"round {rec['round']:3d} step {rec['step']:4d} "
              f"loss {rec['loss']:.3f} cfg={rec['config']} "
              f"Y={rec['y']:.3f}s {'explored' if rec['explored'] else ''}",
              flush=True)

    out = anneal_training(args.arch, steps=args.steps, batch=args.batch,
                          seq=args.seq, anneal_every=args.anneal_every,
                          tau=args.tau, ckpt_dir=args.ckpt_dir,
                          device=args.device, on_round=show)
    losses = out["losses"]
    print(f"\ntrained {out['steps']} steps; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"annealer's best step config: {out['best']} "
          f"(Y={out['best_y']:.3f}s/step)")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not drop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
