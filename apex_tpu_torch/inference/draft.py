"""Draft models for speculative decoding: construction and distillation,
the PyTorch counterpart of ``apex_tpu/inference/draft.py``.

* :func:`make_self_draft`: an independent copy of the target in eval mode
  (acceptance 100% by construction, the measurement fixture).
* :func:`train_draft`: hard-label distillation of a draft toward the
  target's greedy argmax, through one :func:`make_distill_step`.

:class:`DistillStep` builds one ``FusedAdam`` and one ``make_train_step``
over the draft, so on the card its steps replay as the executor's CUDA
graphs (the multi-tensor Adam kernel for the update; the draft's norm
and flash kernels forward and backward; the loss is the port's
``nn.functional.cross_entropy``, plain PyTorch, as the JAX package's is
``jnp``).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

__all__ = ["DistillStep", "make_self_draft", "make_distill_step",
           "train_draft"]


def make_self_draft(target):
    """An independent deep copy of ``target`` in eval mode, sharing
    nothing with it (its compiled decode runs are not copied)."""
    memo = {id(v): {} for k, v in target.__dict__.items()
            if k.endswith("_cache") and isinstance(v, dict)}
    draft = copy.deepcopy(target, memo)
    draft.eval()
    return draft


class DistillStep:
    """Persistent hard-label distillation step (see
    :func:`make_distill_step`); ``self.step`` is the underlying
    :class:`~apex_tpu_torch.training.step.TrainStep`."""

    def __init__(self, draft, target, *, lr=1e-3):
        from ..nn import functional as F
        from ..optimizers.fused_adam import FusedAdam
        from ..training.step import make_train_step

        target.eval()
        draft.train()
        self.draft = draft
        self.target = target
        self.optimizer = FusedAdam(list(draft.parameters()), lr=lr)
        self.step = make_train_step(
            draft, self.optimizer,
            lambda o, t: F.cross_entropy(o.reshape((-1, o.shape[-1])),
                                         t.reshape((-1,))))
        self.calls = 0

    def __call__(self, xs) -> float:
        """Label ``xs`` (B, S int ids) with the target's argmax and take one
        fused step on the draft; returns the loss (a host read)."""
        from .decode import model_device
        dev = model_device(self.draft)
        xs = torch.as_tensor(np.asarray(xs), dtype=torch.long, device=dev)
        with torch.no_grad():
            labels = torch.argmax(self.target(xs.to(
                model_device(self.target))), dim=-1).to(dev)
        loss = float(self.step(xs, labels))
        self.calls += 1
        return loss


def make_distill_step(draft, target, *, lr=1e-3) -> DistillStep:
    """One ``FusedAdam`` and one fused train step over ``draft``, labels
    from ``target``'s argmax; call it with ``(B, S)`` id batches."""
    return DistillStep(draft, target, lr=lr)


def train_draft(draft, target, tokens, *, steps=50, batch_size=8,
                seq_len=32, lr=1e-3, seed=0):
    """Distill ``draft`` toward ``target``'s greedy labels over a flat 1-D
    token stream: each step draws ``batch_size`` windows of ``seq_len``
    from ``numpy.random.default_rng(seed)`` (the JAX package's draws) and
    takes one step of one :func:`make_distill_step`.  Returns the losses."""
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    if tokens.size < seq_len + 1:
        raise ValueError(
            f"train_draft needs at least seq_len+1={seq_len + 1} "
            f"tokens, got {tokens.size}")
    dstep = make_distill_step(draft, target, lr=lr)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(int(steps)):
        starts = rng.integers(0, tokens.size - seq_len, size=batch_size)
        xs = np.stack([tokens[s:s + seq_len] for s in starts])
        losses.append(dstep(xs))
    draft.eval()
    return losses
