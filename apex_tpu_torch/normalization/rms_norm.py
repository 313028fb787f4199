"""FusedRMSNorm, the PyTorch counterpart of
``apex_tpu/normalization/rms_norm.py``: the RMS variant of FusedLayerNorm
that the Llama family uses (no mean, no bias).

The functional forms run the RMSNorm forward kernel
(:func:`apex_tpu_torch.kernels.rms_norm.rms_forward`) inside a
``torch.autograd.Function`` whose backward runs the backward kernel
(:func:`~apex_tpu_torch.kernels.rms_norm.rms_backward`) on the saved input
and fp32 ``rstd``, as the JAX package's ``custom_vjp`` does: ``dx`` in x's
dtype, ``dw`` summed in fp32 and rounded to the weight's dtype by the
column-sum kernel.  The default
eps is 1e-6 everywhere (the Llama convention).
"""
from __future__ import annotations

import torch
from torch import nn

from ..amp.policy import no_casts
from ..kernels import rms_norm as _k
from ..kernels.dispatch import resolve_device
from .fused_layer_norm import _flatten


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, eps):
        y, rstd = _k.rms_forward(x2d, weight, eps)
        ctx.save_for_backward(x2d, rstd, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        x2d, rstd, weight = ctx.saved_tensors
        if weight is None:
            (dx,) = _k.rms_backward(g, x2d, rstd, None)
            return dx, None, None
        # the column-sum kernel writes dw in the weight's dtype (the fp32
        # sum rounded once): no cast launch after it
        dx, dw = _k._backward(g, x2d, rstd, weight, weight.dtype)
        return dx, dw, None


def _rms_norm(x2d, weight, eps):
    # with grad off (generation) nothing is saved for a backward: the
    # kernel is called directly, without the autograd Function's host cost
    if torch.is_grad_enabled():
        return _RMSNorm.apply(x2d, weight, eps)
    return _k.rms_forward(x2d, weight, eps)[0]


@no_casts
def fused_rms_norm_affine(input, weight, normalized_shape, eps=1e-6):
    x2d, n = _flatten(input, normalized_shape)
    return _rms_norm(x2d, weight.reshape(n), eps).reshape(input.shape)


@no_casts
def fused_rms_norm(input, normalized_shape, eps=1e-6):
    x2d, _ = _flatten(input, normalized_shape)
    return _rms_norm(x2d, None, eps).reshape(input.shape)


class FusedRMSNorm(nn.Module):
    """RMSNorm over the trailing ``normalized_shape`` dims through the fused
    kernel; fp32 statistics for half inputs, a weight of ones (fp32 unless
    ``dtype`` says otherwise) and no bias.  One op to amp O1, as in the
    JAX package: its body runs with casts off."""

    _amp_no_casts = True

    def __init__(self, normalized_shape, eps=1e-6, elementwise_affine=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, device=resolve_device(device),
                dtype=dtype))
        else:
            self.register_parameter("weight", None)

    def forward(self, x):
        if self.elementwise_affine:
            return fused_rms_norm_affine(x, self.weight,
                                         self.normalized_shape, self.eps)
        return fused_rms_norm(x, self.normalized_shape, self.eps)

    def extra_repr(self):
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}")
