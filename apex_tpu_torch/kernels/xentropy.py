"""Label-smoothed softmax cross-entropy, forward and backward: the CUDA
kernels ``csrc/xentropy.cu`` and their plain PyTorch versions.

Port of ``apex_tpu/kernels/xentropy.py::xent_forward``: one sweep over each
row of ``logits2d (rows, C)`` gives ``(losses, lse)`` in fp32, with
``loss = lse - (1 - s) * x[y] - s * sum(live x) / max(n_live, 1)``, live
columns those above ``MASKED_LOGIT_THR`` and loss 0 on rows whose label is
``padding_idx``.  And of ``xent_backward``: ``dlogits`` in the logits' dtype
from the saved ``lse`` and the incoming per-row gradient (``gmask``, already
zero on padding rows).  Both follow the Pallas kernel arm, not the jnp arm:
a label >= C, or a negative one other than ``padding_idx``, adds a target
logit of 0.

The forward also counts each row's live columns (C when ``smoothing`` is 0)
and returns that count as a third output, which the backward takes as
``n_live`` instead of counting again.  A CUDA
tensor launches the kernel; a CPU tensor takes the plain version
(:func:`xent_forward_reference`, :func:`xent_backward_reference`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .dispatch import (LAUNCHES, MASKED_LOGIT_THR, check_dtype, decide,
                       dtype_code, kernel_probe, register_kernel, rows_fp,
                       use_kernel)

LAUNCHES.setdefault("xent_forward", 0)
LAUNCHES.setdefault("xent_backward", 0)

register_kernel(
    "xentropy",
    xla_fallback="apex_tpu_torch.kernels.xentropy.xent_forward_reference",
    threshold_probe=kernel_probe,
    doc="B7: label-smoothed softmax cross-entropy forward")
register_kernel(
    "xentropy_bwd",
    xla_fallback="apex_tpu_torch.kernels.xentropy.xent_backward_reference",
    threshold_probe=kernel_probe,
    doc="B8: its backward, dlogits")


def _target(xf, labels):
    """``x[row, label]`` in fp32, 0 where the label is outside 0..C-1."""
    c = xf.shape[1]
    ok = (labels >= 0) & (labels < c)
    idx = torch.where(ok, labels, 0).unsqueeze(1)
    return torch.where(ok, xf.gather(1, idx)[:, 0], 0.0)


def xent_forward_reference(logits2d, labels, smoothing, padding_idx):
    """The plain version: ``(losses, lse, n_live)``, all fp32 of shape
    (rows,)."""
    xf = logits2d.float()
    m = xf.max(dim=1, keepdim=True).values
    lse = (m + torch.log(torch.exp(xf - m).sum(dim=1, keepdim=True)))[:, 0]
    loss = lse - (1.0 - smoothing) * _target(xf, labels)
    if smoothing:
        live = xf > MASKED_LOGIT_THR
        n_live = live.sum(dim=1).float()
        live_sum = torch.where(live, xf, 0.0).sum(dim=1)
        loss = loss - smoothing * live_sum / torch.clamp(n_live, min=1.0)
    else:
        n_live = torch.full_like(lse, float(xf.shape[1]))
    loss = torch.where(labels == padding_idx, 0.0, loss)
    return loss, lse, n_live


def xent_backward_reference(logits2d, labels, lse, gmask, smoothing,
                            n_live):
    """The plain version of the backward: ``dlogits`` in the logits'
    dtype, in the JAX kernel's expression order."""
    xf = logits2d.float()
    c = xf.shape[1]
    gm = gmask.float()[:, None]
    probs = torch.exp(xf - lse.float()[:, None])
    if smoothing:
        smooth = torch.where(xf > MASKED_LOGIT_THR,
                             smoothing / n_live.float()[:, None], 0.0)
        d = gm * (probs - smooth)
    else:
        d = gm * probs
    # the one-hot term, on the label columns only (elsewhere d - 0 is d)
    labels = labels.long()
    rows = torch.nonzero((labels >= 0) & (labels < c))[:, 0]
    cols = labels[rows]
    d[rows, cols] = d[rows, cols] - (1.0 - smoothing) * gm[rows, 0]
    return d.to(logits2d.dtype)


def _validate(logits2d, labels, what):
    if logits2d.dim() != 2:
        raise ValueError(f"{what} takes logits2d (rows, C), got shape "
                         f"{tuple(logits2d.shape)}")
    check_dtype(logits2d, f"{what} logits2d")
    rows, c = logits2d.shape
    if not 0 < c < 2 ** 31 or rows >= 2 ** 31:
        raise ValueError(f"{what}: shape {(rows, c)} outside the kernel's "
                         f"range")
    if tuple(labels.shape) != (rows,) or labels.is_floating_point():
        raise ValueError(f"{what}: labels must be integers of shape "
                         f"{(rows,)}, got {labels.dtype} "
                         f"{tuple(labels.shape)}")


def _rowvec(t, rows, what, name):
    if tuple(t.shape) != (rows,):
        raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                         f"{(rows,)}")
    return t.to(torch.float32).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("xentropy")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.apex_xent_fwd.argtypes = [p] * 5 + [i, i, f, f, ctypes.c_longlong,
                                            i, p]
    lib.apex_xent_fwd.restype = i
    lib.apex_xent_bwd.argtypes = [p] * 6 + [i, i, f, f, i, p]
    lib.apex_xent_bwd.restype = i
    return lib


def _launch_fwd(logits2d, labels, smoothing, padding_idx):
    rows, c = logits2d.shape
    dev = logits2d.device
    decide("xentropy", rows_fp(rows, c, logits2d.dtype), dev)
    loss = torch.empty(rows, dtype=torch.float32, device=dev)
    lse = torch.empty_like(loss)
    n_live = torch.empty_like(loss)
    if rows == 0:
        return loss, lse, n_live
    x = logits2d.contiguous()
    lab = labels.to(torch.int64).contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.apex_xent_fwd(
            x.data_ptr(), lab.data_ptr(), loss.data_ptr(), lse.data_ptr(),
            n_live.data_ptr(), rows, c, float(smoothing),
            float(1.0 - smoothing), int(padding_idx),
            dtype_code(x.dtype), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "xent_forward")
    LAUNCHES["xent_forward"] += 1
    return loss, lse, n_live


def _launch_bwd(logits2d, labels, lse, gmask, smoothing, n_live):
    rows, c = logits2d.shape
    decide("xentropy_bwd", rows_fp(rows, c, logits2d.dtype), logits2d.device)
    x = logits2d.contiguous()
    dx = torch.empty_like(x)
    if rows == 0:
        return dx
    lab = labels.to(torch.int64).contiguous()
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.apex_xent_bwd(
            x.data_ptr(), lab.data_ptr(), lse.data_ptr(), gmask.data_ptr(),
            None if n_live is None else n_live.data_ptr(), dx.data_ptr(),
            rows, c, float(smoothing), float(1.0 - smoothing),
            dtype_code(x.dtype), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "xent_backward")
    LAUNCHES["xent_backward"] += 1
    return dx


def xent_forward(logits2d, labels, smoothing, padding_idx):
    """logits2d (rows, C) fp32/bf16/fp16, labels (rows,) integers ->
    ``(losses, lse, n_live)`` fp32 of shape (rows,), the last the
    live-column count."""
    _validate(logits2d, labels, "xent_forward")
    if use_kernel(logits2d, labels):
        return _launch_fwd(logits2d, labels, smoothing, padding_idx)
    return xent_forward_reference(logits2d, labels, smoothing, padding_idx)


def xent_backward(logits2d, labels, lse, gmask, smoothing, n_live):
    """-> dlogits (rows, C) in logits2d's dtype.  ``gmask`` (rows,) is the
    incoming gradient with padding rows already zeroed; ``n_live`` (rows,)
    the forward's live-column count (read only when ``smoothing`` is not
    0)."""
    _validate(logits2d, labels, "xent_backward")
    rows = logits2d.shape[0]
    lse = _rowvec(lse, rows, "xent_backward", "lse")
    gmask = _rowvec(gmask, rows, "xent_backward", "gmask")
    n_live = _rowvec(n_live, rows, "xent_backward", "n_live") \
        if smoothing else None
    if use_kernel(logits2d, labels, lse, gmask, n_live):
        return _launch_bwd(logits2d, labels, lse, gmask, smoothing, n_live)
    return xent_backward_reference(logits2d, labels, lse, gmask, smoothing,
                                   n_live)
