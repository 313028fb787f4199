"""Functional ops, the PyTorch counterpart of ``apex_tpu/nn/functional.py``
(so far the loss of the training paths, the 2-d convolution and pools,
and the batch norm that ``parallel.SyncBatchNorm`` and
``contrib.groupbn`` run across ranks).  Under amp O1 each is one op, as
there: its arguments are cast by the policy, its body is not.

``channels_last=True`` (``channel_axis=-1`` for the batch norm) takes and
returns (B, H, W, C) tensors, the JAX package's NHWC layout.  A contiguous
(B, H, W, C) tensor permuted to (B, C, H, W) is a view with
``torch.channels_last`` strides, which torch's convolutions (cuDNN's NHWC
kernels on the card), pools and batch norm run on directly; the result
permuted back is (B, H, W, C) again.  So the layout costs no copy at
either end."""
from __future__ import annotations

import torch
import torch.distributed as dist

from .._unported import PARALLEL, accept_defaults
from ..amp.policy import policied
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


@policied("cross_entropy")
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


def _nchw(fn, x, channels_last):
    """``fn`` of the (B, C, H, W) view of ``x``: for (B, H, W, C) input
    (``channels_last``) the permuted view, whose result is permuted back."""
    if not channels_last:
        return fn(x)
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _pairs(v, n=2):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _padding(padding):
    """The JAX package's padding (an int, an int a dim, or a (lo, hi) pair a
    dim) as torch's symmetric padding and the asymmetric rest, an
    ``F.pad`` list (None where every pair is symmetric)."""
    if isinstance(padding, str):
        return padding.lower(), None
    pads = [(p, p) if isinstance(p, int) else tuple(p)
            for p in _pairs(padding)]
    if all(lo == hi for lo, hi in pads):
        return tuple(lo for lo, _ in pads), None
    return 0, [v for lo, hi in reversed(pads) for v in (lo, hi)]


@policied("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           channels_last=False):
    """2-d convolution with a torch OIHW ``weight``, over (B, C, H, W) input
    or, with ``channels_last``, (B, H, W, C) input giving (B, H, W, C)
    output; the weight stays OIHW (any memory format) either way, so a
    checkpoint is layout-independent.  ``padding`` as the JAX package's:
    an int, an int a dim, or a (lo, hi) pair a dim."""
    pad, extra = _padding(padding)

    def conv(v):
        if extra is not None:
            v = torch.nn.functional.pad(v, extra)
        return torch.nn.functional.conv2d(v, weight, bias, stride, pad,
                                          dilation, groups)
    return _nchw(conv, x, channels_last)


def max_pool2d(x, kernel_size, stride=None, padding=0, channels_last=False):
    """Max pooling over (B, C, H, W), or (B, H, W, C) with
    ``channels_last``; padding counts as -inf, ``stride`` defaults to
    ``kernel_size``."""
    return _nchw(lambda v: torch.nn.functional.max_pool2d(
        v, kernel_size, stride or kernel_size, padding), x, channels_last)


def avg_pool2d(x, kernel_size, stride=None, padding=0, channels_last=False):
    """Average pooling over (B, C, H, W), or (B, H, W, C) with
    ``channels_last``: fp32 window sums over the whole window, padding
    included, in ``x``'s dtype, as the JAX package's."""
    return _nchw(lambda v: torch.nn.functional.avg_pool2d(
        v.float(), kernel_size, stride or kernel_size, padding).to(x.dtype),
        x, channels_last)


def adaptive_avg_pool2d(x, output_size=(1, 1), channels_last=False):
    """Adaptive average pooling (torch's windows: bin i covers
    [floor(i * in / out), ceil((i + 1) * in / out))) over (B, C, H, W), or
    (B, H, W, C) with ``channels_last``, in fp32, in ``x``'s dtype; a None
    in ``output_size`` keeps that size."""
    return _nchw(lambda v: torch.nn.functional.adaptive_avg_pool2d(
        v.float(), output_size).to(x.dtype), x, channels_last)


class _AllGather(torch.autograd.Function):
    """``all_gather`` that carries a gradient: forward stacks every rank's
    ``x`` (group size first); backward sums the stacked gradient over the
    ranks and keeps this rank's slice (``torch.distributed.all_gather``
    alone is not differentiable, and gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = [torch.empty_like(x)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x, group=group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[dist.get_rank(ctx.group)], None


@policied("batch_norm")
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.1, eps=1e-5, axis_name=None,
               axis_index_groups=None, return_stats=False, channel_axis=1,
               process_group=None):
    """torch-semantics batch norm over ``channel_axis`` (1: (N, C, ...);
    -1: channels-last, (N, H, W, C) as ``contrib.groupbn`` and
    ``SyncBatchNorm(channel_last=True)`` feed it), in plain PyTorch, the
    port of the JAX package's ``F.batch_norm``.

    In training the local statistics are a shifted two-pass ``(mean, m2)``
    in fp32.  Given a ``torch.distributed`` ``process_group`` of more than
    one rank (``torch.distributed.group.WORLD`` for all; the SyncBatchNorm
    path), every rank's ``(mean, m2, count)`` is all-gathered, with a
    gradient, and merged as a Welford merge; the JAX package gathers over a
    mesh axis in the same way, where every shard has the same count.  Here
    a rank may hold fewer rows than another (a last partial batch), so the
    merge weighs each rank by its count (carried in fp32: exact up to 2^24
    values a channel on a rank).  The normalisation uses the biased
    variance, the running variance the unbiased one (``count / max(count -
    1, 1)``).  Returns ``(y, new_running_mean, new_running_var)`` with
    ``y`` in ``x.dtype``; with ``return_stats`` also the (group) batch mean
    and ``1 / sqrt(var + eps)`` it normalised with (the running statistics'
    in eval mode), which groupbn keeps as ``minibatch_mean`` and
    ``minibatch_riv``.  The JAX package's mesh arguments (``axis_name``,
    ``axis_index_groups``) are taken at None only."""
    accept_defaults("batch_norm: a mesh axis", PARALLEL,
                    axis_name=(axis_name, None),
                    axis_index_groups=(axis_index_groups, None))
    ch = channel_axis % x.dim()
    reduce_axes = tuple(a for a in range(x.dim()) if a != ch)
    shape = tuple(x.shape[a] if a == ch else 1 for a in range(x.dim()))
    xf = x.float()
    if training:
        local_count = x.numel() // x.shape[ch]
        mean = xf.mean(dim=reduce_axes)
        m2 = (xf - mean.reshape(shape)).square().sum(dim=reduce_axes)
        count = float(local_count)
        group = 1 if process_group is None \
            else dist.get_world_size(process_group)
        if group > 1:
            every = _AllGather.apply(
                torch.stack([mean, m2, torch.full_like(mean, count)]),
                process_group)
            means, m2s, counts = every[:, 0], every[:, 1], every[:, 2]
            count = counts.sum(dim=0)
            mean = (counts * means).sum(dim=0) / count
            m2 = m2s.sum(dim=0) + (counts * (means - mean).square()).sum(
                dim=0)
            var = m2 / count
            unbiased = var * (count / (count - 1.0).clamp_min(1.0))
        else:
            var = m2 / count
            unbiased = var * (count / max(count - 1.0, 1.0))
        new_rm = None if running_mean is None else \
            (1 - momentum) * running_mean + momentum * mean.detach()
        new_rv = None if running_var is None else \
            (1 - momentum) * running_var + momentum * unbiased.detach()
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    inv = torch.rsqrt(var.float() + eps)
    y = (xf - mean.reshape(shape)) * inv.reshape(shape)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    if return_stats:
        return y.to(x.dtype), new_rm, new_rv, mean, inv
    return y.to(x.dtype), new_rm, new_rv
