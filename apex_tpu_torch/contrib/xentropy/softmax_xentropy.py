"""Label-smoothed softmax cross-entropy, the PyTorch counterpart of
``apex_tpu/contrib/xentropy/softmax_xentropy.py``.

``softmax_cross_entropy_loss(logits, labels, smoothing, padding_idx,
half_to_float)`` returns per-row losses (no reduction): fp32 with
``half_to_float``, else in the logits' dtype.  The forward saves the logits,
one ``lse`` and one live-column count per row, and the labels, never the
softmax; the backward rebuilds the probabilities from ``lse``.  Rows whose
label is ``padding_idx`` get loss 0 and gradient 0; columns at or below
-1e29 are left out of the smoothing term and its divisor.

Both passes are the xentropy kernels
(:mod:`apex_tpu_torch.kernels.xentropy`) on the card, whatever the shape:
the JAX package's on-chip switch (``APEX_TPU_XENT_KERNEL``) and row
blocking (``_block_rows``) were TPU verdicts and decide nothing here.  On
CPU tensors the kernels' plain versions run.  Out-of-range labels follow the
Pallas kernel arm: a target logit of 0.
"""
from __future__ import annotations

import torch

from ...amp.policy import no_casts
from ...kernels import xentropy as _k


def _flat(logits, labels):
    c = logits.shape[-1]
    if tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"labels shape {tuple(labels.shape)} must equal "
                         f"logits' leading shape "
                         f"{tuple(logits.shape[:-1])}")
    return logits.reshape(-1, c), labels.reshape(-1)


class _SoftmaxXentropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx, half_to_float):
        x2d, lab = _flat(logits, labels)
        losses, lse, n_live = _k.xent_forward(x2d, lab, smoothing,
                                              padding_idx)
        ctx.save_for_backward(logits, lse, labels, n_live)
        ctx.smoothing, ctx.padding_idx = smoothing, padding_idx
        out = losses if half_to_float else losses.to(logits.dtype)
        return out.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels, n_live = ctx.saved_tensors
        x2d, lab = _flat(logits, labels)
        gm = torch.where(lab == ctx.padding_idx, 0.0,
                         g.reshape(-1).float())
        dx = _k.xent_backward(x2d, lab, lse, gm, ctx.smoothing, n_live)
        return dx.reshape(logits.shape), None, None, None, None


@no_casts
def softmax_cross_entropy_loss(logits, labels, smoothing=0.0, padding_idx=0,
                               half_to_float=False):
    """Per-row label-smoothed cross entropy of ``logits (..., C)`` against
    integer ``labels (...)``."""
    return _SoftmaxXentropy.apply(logits, labels, float(smoothing),
                                  int(padding_idx), bool(half_to_float))


class SoftmaxCrossEntropyLoss:
    """The reference's callable surface: ``SoftmaxCrossEntropyLoss.apply(
    logits, labels, smoothing, padding_idx, half_to_float)``."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx, half_to_float)
