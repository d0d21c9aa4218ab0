"""LM losses on one device.

The counterpart of the reference package's ``runtime/loss.py``.  The
reference constrains the (B, S, V) logits to a vocab-sharded layout and
lets XLA partition every reduction over V; one device holds the whole
vocabulary, so the same math runs on the full tensor.  The reference
picks the label's logit with a one-hot contraction (it partitions over a
sharded V); here a gather picks it, which gives the same float32 value
(the contraction adds only zeros to it) without a (B, S, V) one-hot.

z-loss (Chowdhery et al., PaLM) regularizes the softmax normalizer; MoE
archs add the router load-balance auxiliary from the model forward.
"""

from __future__ import annotations

import torch


def softmax_xent(
    logits: torch.Tensor,                 # (B, S, V)
    labels: torch.Tensor,                 # (B, S) int
    mask: torch.Tensor | None = None,     # (B, S) 0/1 valid-token mask
    z_loss: float = 0.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean per-token negative log likelihood (+ optional z-loss)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    shifted = lf - m
    sum_exp = torch.exp(shifted).sum(dim=-1)
    log_z = torch.log(sum_exp) + m[..., 0]                # (B, S)
    label_logit = lf.gather(-1, labels.long()[..., None])[..., 0]  # (B, S)
    nll = log_z - label_logit

    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    metrics = {
        "nll": loss,
        "z": (torch.square(log_z) * mask).sum() / denom,
    }
    if z_loss > 0.0:
        loss = loss + z_loss * metrics["z"]
    return loss, metrics


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    hit = (pred == labels).float()
    if mask is None:
        return hit.mean()
    mask = mask.float()
    return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)
