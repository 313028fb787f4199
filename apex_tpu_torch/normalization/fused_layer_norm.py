"""FusedLayerNorm, the PyTorch counterpart of
``apex_tpu/normalization/fused_layer_norm.py``.

The functional forms run the LayerNorm forward kernel
(:func:`apex_tpu_torch.kernels.layer_norm.ln_forward`) inside a
``torch.autograd.Function`` whose backward runs the backward kernel
(:func:`~apex_tpu_torch.kernels.layer_norm.ln_backward`) on the saved input
and statistics, as the JAX package's ``custom_vjp`` does: ``dx`` in x's
dtype, ``dgamma``/``dbeta`` summed in fp32 and rounded to the weight's
dtype by the column-sum kernel.
Note the two default eps values, as in the JAX package: 1e-6 for the
functions, 1e-5 for the module.
"""
from __future__ import annotations

import torch
from torch import nn

from ..amp.policy import no_casts
from ..kernels import layer_norm as _k
from ..kernels.dispatch import resolve_device


def _flatten(x, normalized_shape):
    ns = tuple(normalized_shape)
    if tuple(x.shape[x.dim() - len(ns):]) != ns:
        raise ValueError(
            f"Expected input with trailing dims {ns}, got shape "
            f"{tuple(x.shape)} (normalized_shape must match the input's "
            f"last dimensions)")
    n = 1
    for d in ns:
        n *= d
    return x.reshape(-1, n).contiguous(), n


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, bias, eps):
        y, mean, rstd = _k.ln_forward(x2d, weight, bias, eps)
        ctx.save_for_backward(x2d, mean, rstd, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        x2d, mean, rstd, weight = ctx.saved_tensors
        if weight is None:
            (dx,) = _k.ln_backward(g, x2d, mean, rstd, None)
            return dx, None, None, None
        # the column-sum kernel writes dgamma and dbeta in the weight's
        # dtype (fp32 sums rounded once): no cast launch after it
        dx, dw, db = _k._backward(g, x2d, mean, rstd, weight, weight.dtype)
        return dx, dw, db, None


def _layer_norm(x2d, weight, bias, eps):
    # with grad off (generation) nothing is saved for a backward: the
    # kernel is called directly, without the autograd Function's host cost
    if torch.is_grad_enabled():
        return _LayerNorm.apply(x2d, weight, bias, eps)
    return _k.ln_forward(x2d, weight, bias, eps)[0]


@no_casts
def fused_layer_norm_affine(input, weight, bias, normalized_shape, eps=1e-6):
    x2d, n = _flatten(input, normalized_shape)
    y = _layer_norm(x2d, weight.reshape(n), bias.reshape(n), eps)
    return y.reshape(input.shape)


@no_casts
def fused_layer_norm(input, normalized_shape, eps=1e-6):
    x2d, _ = _flatten(input, normalized_shape)
    return _layer_norm(x2d, None, None, eps).reshape(input.shape)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims through the
    fused kernel; fp32 statistics for half inputs.  One op to amp O1, as
    in the JAX package: its body runs with casts off."""

    _amp_no_casts = True

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            kw = dict(device=resolve_device(device), dtype=dtype)
            self.weight = nn.Parameter(torch.ones(self.normalized_shape, **kw))
            self.bias = nn.Parameter(torch.zeros(self.normalized_shape, **kw))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        if self.elementwise_affine:
            return fused_layer_norm_affine(x, self.weight, self.bias,
                                           self.normalized_shape, self.eps)
        return fused_layer_norm(x, self.normalized_shape, self.eps)

    def extra_repr(self):
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}")
