"""Serving with sojourn-time annealing (paper sec. 4.2.2), on one device.

The counterpart of the reference package's ``examples/serve_anneal.py`` as
a package entry point.  A batched serve engine answers bursts of requests
with a real model (random weights, made on the device from ``--seed``; no
weights are downloaded), and the online annealer tunes the engine's
``max_batch`` against the measured mean sojourn time: small batches
queue requests behind many serial batches, large ones pad and lengthen
every batch; annealing finds the knee.

    python -m repro_torch.serving.anneal [--arch qwen3-8b] [--device cuda]

``--arch qwen3-8b-reduced --device cpu`` runs the same loop on the CPU at
the reduced test width.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..core.annealing import Annealer
from ..core.neighborhood import StepNeighborhood
from ..core.state import ConfigSpace, Dimension
from ..device import generator, resolve_device
from ..kernels import ops
from ..models.transformer import init_model
from ..runtime.serve import build_decode_step, build_prefill_step
from ..workloads import JobStream
from .engine import Request, ServeEngine

BATCH_MENU = (1, 2, 4, 8, 16)


def anneal_serving(config: ModelConfig, *, device: str = "cuda",
                   seed: int = 0, prompt_len: int = 512, max_new: int = 16,
                   requests: int = 24, rounds: int = 6,
                   menu: tuple[int, ...] = BATCH_MENU,
                   on_round: Callable[[dict[str, Any]], None] | None = None,
                   ) -> dict[str, Any]:
    """Anneal ``max_batch`` over ``menu`` for ``rounds`` rounds; each round
    serves a burst of ``requests`` prompts of ``prompt_len`` random tokens,
    ``max_new`` new tokens each, and measures their mean sojourn.

    Returns ``{"rounds": [...], "best_batch", "best_sojourn_s",
    "init_s"}``.  Each round's record holds its batch size, mean sojourn,
    whether the move was exploratory, the number of batches and decode
    steps it ran, the kernel launches it made (``ops.LAUNCHES`` deltas),
    its wall time and whether every request got ``max_new`` tokens.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = init_model(generator(seed, device=dev), config)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    engines: dict[int, ServeEngine] = {}

    def engine_for(batch: int) -> ServeEngine:
        if batch not in engines:
            shape = ShapeConfig("serve", seq_len=prompt_len + max_new + 1,
                                global_batch=batch, kind="decode")
            # prompts are padded to the engine's fixed prefill width
            engines[batch] = ServeEngine(
                params, build_prefill_step(config, shape, dev),
                build_decode_step(config, shape, dev), max_batch=batch,
                prompt_len=prompt_len)
        return engines[batch]

    last: dict[str, Any] = {}

    def evaluate(decoded, n) -> float:
        """Mean sojourn over one arrival burst at this batch size."""
        eng = engine_for(decoded["max_batch"])
        eng.queue.clear()
        eng.results.clear()
        # burst arrival: all requests land "now" on the engine's clock;
        # sojourn then measures queueing + service as the batch size
        # trades throughput against per-batch latency
        stream = JobStream({"chat": 1.0}, seed=n)
        for i in range(requests):
            next(stream)
            eng.submit(Request(
                rid=i, prompt=rng.integers(0, config.vocab, prompt_len,
                                           dtype=np.int32),
                max_new=max_new))
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        eng.drain()
        n_batches = -(-requests // eng.max_batch)
        last.update(
            wall_s=time.perf_counter() - t, batches=n_batches,
            decode_steps=n_batches * (max_new - 1),
            launches={k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES},
            tokens_ok=len(eng.results) == requests and all(
                len(r.tokens) == max_new for r in eng.results))
        return eng.mean_sojourn_s()

    space = ConfigSpace((Dimension("max_batch", tuple(menu)),))
    ann = Annealer(space, StepNeighborhood(space), evaluate,
                   schedule=0.05, seed=0, init=(0,))
    records = []
    for r in range(rounds):
        rec = ann.step()
        record = {"round": r,
                  "batch": space.decode(rec.proposed)["max_batch"],
                  "mean_sojourn_s": rec.y_proposed,
                  "explored": rec.explored, **last}
        records.append(record)
        if on_round is not None:
            on_round(record)
    best, y = ann.best()
    return {"rounds": records, "best_batch": space.decode(best)["max_batch"],
            "best_sojourn_s": y, "init_s": init_s}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=24,
                    help="requests per round (one burst)")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    config = get_config(args.arch)

    def show(rec):
        print(f"round {rec['round']:2d} batch={rec['batch']:3d} mean sojourn "
              f"{rec['mean_sojourn_s']:.3f}s ({rec['batches']} batches, "
              f"{rec['wall_s']:.2f}s){' explored' if rec['explored'] else ''}",
              flush=True)

    out = anneal_serving(config, device=args.device, seed=args.seed,
                         prompt_len=args.prompt_len, max_new=args.max_new,
                         requests=args.requests, rounds=args.rounds,
                         on_round=show)
    print(f"\nbest batch size: {out['best_batch']} (mean sojourn "
          f"{out['best_sojourn_s']:.3f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
