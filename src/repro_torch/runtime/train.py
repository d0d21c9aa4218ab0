"""Train-step builder: model forward + loss + AdamW, on one device.

The counterpart of the reference package's ``runtime/train.py``.
``build_train_step`` assembles the step for one (arch x shape) cell with
the annealable knobs (microbatches, remat, compression) taken from
:class:`TrainStepOptions`, whose fields and defaults are the reference's.
The reference shards parameters, ZeRO-1 optimizer state and activations
over a mesh; one card has no mesh, so ``layout`` is accepted and has no
effect, and the multi-card layout waits for ``runtime/partitioning``
(ROADMAP queue A, item 8).

The step, in the reference's order:
  1. for each of ``microbatches`` slices of the batch, the loss and its
     gradients (autograd through :func:`~repro_torch.models.transformer.
     model_fwd`: cuBLAS products and the hand flash-attention kernels,
     forward and backward), accumulated as ``(acc.f32 + g.f32 / k)`` in
     the accumulator type;
  2. with ``compression="int8"``, the error-feedback roundtrip through the
     ``quantize_int8`` kernel (one launch per parameter tensor);
  3. the cosine learning rate of the step count, and AdamW.

The parameters are updated in place in the :class:`TrainState`'s model (the
reference returns new arrays and donates the old ones); the moments and
the residual are replaced by the update's new tensors.  Nothing is read
back to the host: the metrics are 0-dim tensors on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import generator, resolve_device
from ..models import transformer
from ..models.transformer import Model, check_ported, stack_plan
from ..optim.compression import apply_error_feedback, compress_tree, \
    dequantize_int8
from ..optim.optimizer import AdamWConfig, OptState, adamw_init, \
    adamw_update, cosine_schedule, tree_map
from .loss import softmax_xent
from .serve import _check_params, _tokens


@dataclasses.dataclass(frozen=True)
class TrainStepOptions:
    """The annealable knobs (mirrors core.state.ClusterConfig)."""

    microbatches: int = 1
    remat: str | None = None          # None -> config default
    compression: str = "none"         # "none" | "int8"
    layout: str | None = None         # no effect on one device
    accum_dtype: str | None = None    # None -> config.grad_accum_dtype
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    lr_warmup: int = 100
    lr_total: int = 10_000


@dataclasses.dataclass
class TrainState:
    """The model (its parameters updated in place by the step), the AdamW
    moments keyed by parameter name with the int32 step count, and the
    error-feedback residual (float32, keyed the same) under int8
    compression."""

    params: Model
    opt: OptState
    residual: dict[str, torch.Tensor] | None

    def tree(self) -> dict[str, Any]:
        """The state as nested dicts of tensors (the checkpointed tree)."""
        return {"params": {n: p.detach()
                           for n, p in self.params.named_parameters()},
                "opt": {"m": self.opt.m, "v": self.opt.v,
                        "count": self.opt.count},
                "residual": self.residual}

    def load_tree(self, tree: dict[str, Any]) -> None:
        """Copy the values of a :meth:`tree`-shaped ``tree`` into this
        state, in place."""
        with torch.no_grad():
            for n, p in self.params.named_parameters():
                p.copy_(tree["params"][n])
            for mine, theirs in ((self.opt.m, tree["opt"]["m"]),
                                 (self.opt.v, tree["opt"]["v"])):
                for n, t in mine.items():
                    t.copy_(theirs[n])
            self.opt.count.copy_(tree["opt"]["count"])
            if self.residual is not None:
                for n, t in self.residual.items():
                    t.copy_(tree["residual"][n])


@dataclasses.dataclass
class BuiltTrainStep:
    """Everything the launcher needs for one train cell."""

    #: ``step(state, batch) -> (state, metrics)``; batch holds "tokens"
    #: and "labels" (B, S), numpy or tensors.
    step: Callable[[TrainState, dict], tuple[TrainState, dict]]
    #: ``init(seed) -> TrainState``: random weights made on the device
    init: Callable[[int], TrainState]
    #: ``grads(model, batch) -> (loss, metrics, grads)``: one microbatch's
    #: loss and its gradients by parameter name (the step's first stage)
    grads: Callable[[Model, dict], tuple[torch.Tensor, dict, dict]]
    config: ModelConfig
    options: TrainStepOptions
    device: torch.device


def reference_ranks(model: Model) -> dict[str, int]:
    """The rank of each parameter's leaf in the reference's tree: a
    parameter of one of the scanned layers (the first ``reps`` repetitions
    of the pattern) is stacked there on a leading axis, so its rank is its
    own plus one.  AdamW decays the leaves of rank >= 2, so the layers'
    (D,) norm scales are decayed as in the reference and only the final
    norm's is not."""
    plan = stack_plan(model.config)
    n_scanned = plan.reps * len(plan.pattern)
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        scanned = parts[0] == "layers" and int(parts[1]) < n_scanned
        out[name] = p.dim() + int(scanned)
    return out


def build_train_step(
    config: ModelConfig,
    shape: ShapeConfig,
    options: TrainStepOptions | None = None,
    device: str | torch.device = "cuda",
) -> BuiltTrainStep:
    if options is None:
        options = TrainStepOptions(
            microbatches=config.microbatches.get(shape.name, 1),
            adamw=AdamWConfig(state_dtype=config.opt_state_dtype))
    if options.remat is not None:
        config = dataclasses.replace(config, remat=options.remat)
    if options.compression not in ("none", "int8"):
        raise ValueError(f"unknown compression {options.compression!r}")
    check_ported(config, training=True)
    dev = resolve_device(device)
    accum_name = options.accum_dtype or config.grad_accum_dtype
    accum_dtype = (torch.bfloat16 if accum_name == "bfloat16"
                   else torch.float32)
    lr_fn = cosine_schedule(options.adamw.lr, options.lr_warmup,
                            options.lr_total)
    z_loss = max(config.z_loss, 1e-4)

    def loss_fn(model: Model, mb: dict):
        hidden, aux = transformer.model_fwd(model, mb, config)
        logits = transformer.logits_fn(model, hidden)
        loss, metrics = softmax_xent(logits, mb["labels"], z_loss=z_loss)
        return loss + aux, {**metrics, "aux": aux}

    def grads(model: Model, mb: dict):
        names, params = zip(*model.named_parameters())
        with torch.enable_grad():
            for p in params:
                p.requires_grad_(True)
            loss, metrics = loss_fn(model, mb)
            g = torch.autograd.grad(loss, params)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(names, g)))

    def train_step(state: TrainState, batch: dict):
        model = state.params
        _check_params(model, dev)
        batch = {k: _tokens(batch[k], dev) for k in ("tokens", "labels")}
        k = options.microbatches
        if k <= 1:
            loss, metrics, g = grads(model, batch)
            acc = tree_map(lambda t: t.to(accum_dtype), g)
        else:
            B = batch["tokens"].shape[0]
            if B % k:
                raise ValueError(f"batch {B} does not split into {k} "
                                 f"microbatches")
            acc = {n: torch.zeros(p.shape, dtype=accum_dtype, device=dev)
                   for n, p in model.named_parameters()}
            losses, ms = [], []
            for i in range(k):
                mb = {n: t[i * (B // k):(i + 1) * (B // k)]
                      for n, t in batch.items()}
                l, m, g = grads(model, mb)
                acc = tree_map(lambda a, gi: (a.float() + gi.float() / k)
                               .to(accum_dtype), acc, g)
                losses.append(l)
                ms.append(m)
            loss = torch.stack(losses).mean()
            metrics = {key: torch.stack([m[key] for m in ms]).mean()
                       for key in ms[0]}

        residual = state.residual
        if options.compression == "int8":
            fed = apply_error_feedback(acc, residual)
            qtree, residual = compress_tree(fed)
            acc = tree_map(lambda qs: dequantize_int8(qs[0], qs[1]), qtree)

        lr = lr_fn(state.opt.count)
        params = {n: p.detach() for n, p in model.named_parameters()}
        new_params, new_opt = adamw_update(acc, state.opt, params,
                                           options.adamw, lr=lr,
                                           ranks=reference_ranks(model))
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(new_params[n])
        state.opt, state.residual = new_opt, residual
        metrics = {**metrics, "loss": loss, "lr": lr,
                   "step": new_opt.count.float()}
        return state, metrics

    def init(seed: int = 0) -> TrainState:
        with torch.no_grad():
            model = transformer.init_model(generator(seed, device=dev),
                                           config)
        model.requires_grad_(True)
        params = {n: p.detach() for n, p in model.named_parameters()}
        residual = (tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=dev), params)
            if options.compression == "int8" else None)
        return TrainState(model, adamw_init(params, options.adamw), residual)

    return BuiltTrainStep(step=train_step, init=init, grads=grads,
                          config=config, options=options, device=dev)
