"""Batched serving engine with a request queue and sojourn-time accounting.

The counterpart of the reference package's ``serving/engine.py``.

Paper sec. 4.2.2: "for workloads that consist of jobs that are executed in
parallel (i.e., when jobs compete for resources) and a job queue may be
present, the minimizing objective can be adjusted ... by measuring the
sojourn time of jobs instead of execution times."  This engine provides
exactly that measurement for the serve-side annealing loop: requests
arrive (in a burst or scripted), are queued, batched up to ``max_batch``,
prefilled, then decoded; each finished request reports sojourn = finish -
arrival.

The engine is synchronous and deterministic around the model's prefill
and decode steps, so tests can assert its queueing behaviour.  The tokens
a batch generates stay on the step's device until the batch ends, then
come to the host in one read; the finish time is taken after that read, so
it covers the device's work.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    arrival_s: float = 0.0


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray
    arrival_s: float
    start_s: float
    finish_s: float

    @property
    def sojourn_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        return self.start_s - self.arrival_s


class ServeEngine:
    """Fixed-batch prefill+decode engine over the model's serve steps.

    ``prefill(params, batch) -> (logits, cache)`` and
    ``decode(params, cache, tokens, pos) -> (logits, cache)`` are the step
    functions from :mod:`repro_torch.runtime.serve` (or plain closures in
    tests); logits are (B, V) tensors.  All requests in a batch share a
    padded prompt length.
    """

    def __init__(self, params, prefill: Callable, decode: Callable,
                 max_batch: int, prompt_len: int,
                 clock: Callable | None = None):
        self.params = params
        self.prefill = prefill
        self.decode = decode
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.queue: deque[Request] = deque()
        self.results: list[RequestResult] = []
        self._clock = clock or time.perf_counter

    def submit(self, req: Request) -> None:
        req.arrival_s = req.arrival_s or self._clock()
        self.queue.append(req)

    def _pad_prompts(self, reqs: list[Request]) -> np.ndarray:
        B = self.max_batch
        out = np.zeros((B, self.prompt_len), np.int32)
        for i, r in enumerate(reqs):
            p = r.prompt[-self.prompt_len:]
            out[i, self.prompt_len - len(p):] = p
        return out

    def step(self) -> list[RequestResult]:
        """Serve one batch from the queue; returns its results."""
        if not self.queue:
            return []
        reqs = [self.queue.popleft()
                for _ in range(min(self.max_batch, len(self.queue)))]
        start = self._clock()
        tokens = torch.from_numpy(self._pad_prompts(reqs))
        logits, cache = self.prefill(self.params, {"tokens": tokens})
        max_new = max(r.max_new for r in reqs)
        outs = [torch.argmax(logits, -1)[:, None]]
        for i in range(max_new - 1):
            pos = self.prompt_len + i
            logits, cache = self.decode(self.params, cache, outs[-1], pos)
            outs.append(torch.argmax(logits, -1)[:, None])
        generated = torch.cat(outs, dim=1).cpu().numpy()
        finish = self._clock()
        batch_results = []
        for i, r in enumerate(reqs):
            res = RequestResult(
                rid=r.rid, tokens=generated[i, : r.max_new],
                arrival_s=r.arrival_s, start_s=start, finish_s=finish)
            batch_results.append(res)
            self.results.append(res)
        return batch_results

    def drain(self) -> list[RequestResult]:
        while self.queue:
            self.step()
        return self.results

    # -- metrics for the annealing objective (paper sec. 4.2.2) --
    def mean_sojourn_s(self) -> float:
        if not self.results:
            return 0.0
        return float(np.mean([r.sojourn_s for r in self.results]))

    def p99_sojourn_s(self) -> float:
        if not self.results:
            return 0.0
        return float(np.percentile([r.sojourn_s for r in self.results], 99))
