"""Functional ops, the PyTorch counterpart of ``apex_tpu/nn/functional.py``
(so far the loss of the GPT training path)."""
from __future__ import annotations

import torch

from ..kernels.dispatch import MASKED_LOGIT_THR


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    if reduction == "none":
        return v
    raise ValueError(f"reduction must be 'none', 'mean' or 'sum', got "
                     f"{reduction!r}")


def cross_entropy(logits, target, weight=None, reduction="mean",
                  label_smoothing=0.0):
    """Softmax cross entropy with integer class targets, the JAX package's
    semantics: ``logits (N, C, ...)``, ``target (N, ...)``, an fp32
    log-softmax over dim 1 whatever the logits' dtype.

    As there, an out-of-range target (negative or >= C) gives a loss of 0
    instead of raising (the optax convention), and its ``weight`` is read
    at the index the JAX package's gather takes (negative indices wrap,
    the rest clamp).  Label smoothing leaves out the columns at or below
    -1e29 (the masked-vocabulary convention): they get no smoothing mass and
    the divisor counts only the valid columns."""
    n_cls = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    valid_t = (target >= 0) & (target < n_cls)
    picked = logp.gather(1, target.clamp(0, n_cls - 1).unsqueeze(1))
    nll = -torch.where(valid_t, picked.squeeze(1), 0.0)
    if label_smoothing > 0.0:
        valid = (logits > MASKED_LOGIT_THR).to(logp.dtype)
        nv = valid.sum(dim=1).clamp(min=1.0)
        smooth = -(valid * logp).sum(dim=1)
        nll = nll * (1.0 - label_smoothing) + (label_smoothing / nv) * smooth
    if weight is not None:
        idx = torch.where(target < 0, target + n_cls, target).clamp(
            0, n_cls - 1)
        w = weight[idx]
        nll = nll * w
        if reduction == "mean":
            return nll.sum() / w.sum()
    return _reduce(nll, reduction)
