"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Port of ``apex_tpu/kernels/attention.py::flash_attention_fwd``: q3 (BH, Sq,
D), k3/v3 (BH, Sk, D), an additive bias broadcastable as (BH|1, Sq|1, Sk),
top-left causal masking with an optional Mistral band, the scale applied
after q.k^T, masked scores at the finite -1e30.  Returns ``out`` in q's
dtype and the per-row logsumexp ``lse (BH, Sq)`` in fp32.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`flash_attention_reference`.
In-kernel dropout is ported with the training slice.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .dispatch import LAUNCHES, MASKED_FILL, check_dtype, dtype_code, \
    use_kernel

MAX_HEAD_DIM = 128   # csrc/flash_attention.cu keeps D / 16 columns a thread

LAUNCHES.setdefault("flash_attention_fwd", 0)


def flash_attention_reference(q3, k3, v3, bias, scale, causal, window=None):
    """The plain version: materialised fp32 scores, softmax, product."""
    sq, sk = q3.shape[1], k3.shape[1]
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        rows = torch.arange(sq, device=q3.device)[:, None]
        cols = torch.arange(sk, device=q3.device)[None, :]
        keep = rows >= cols
        if window is not None:
            keep = keep & (cols > rows - window)
        s = torch.where(keep, s, MASKED_FILL)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.softmax(s, dim=-1), v3.float())
    return out.to(q3.dtype), lse


def _validate(q3, k3, v3, bias, window, dropout_p):
    if dropout_p:
        raise NotImplementedError(
            "flash_attention_fwd: in-kernel attention dropout is ported "
            "with the training slice")
    for name, t in (("q3", q3), ("k3", k3), ("v3", v3)):
        if t.dim() != 3:
            raise ValueError(f"flash_attention_fwd: {name} must be (BH, S, "
                             f"D), got shape {tuple(t.shape)}")
        check_dtype(t, f"flash_attention_fwd {name}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"contiguous")
    if not q3.dtype == k3.dtype == v3.dtype:
        raise TypeError(f"flash_attention_fwd: q/k/v dtypes differ "
                        f"({q3.dtype}, {k3.dtype}, {v3.dtype})")
    bh, sq, d = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(f"flash_attention_fwd: q {tuple(q3.shape)}, k "
                         f"{tuple(k3.shape)}, v {tuple(v3.shape)} do not "
                         f"match")
    sk = k3.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: head dim {d} > "
                         f"{MAX_HEAD_DIM}, which the kernel does not take")
    if min(bh, sq, sk, d) == 0:
        raise ValueError(f"flash_attention_fwd: empty input "
                         f"{tuple(q3.shape)} x {tuple(k3.shape)}")
    if bias is not None:
        if bias.dim() != 3 or bias.shape[0] not in (1, bh) \
                or bias.shape[1] not in (1, sq) or bias.shape[2] != sk:
            raise ValueError(f"flash_attention_fwd: bias shape "
                             f"{tuple(bias.shape)} is not ({bh}|1, {sq}|1, "
                             f"{sk})")
        if not bias.is_floating_point():
            raise TypeError(f"flash_attention_fwd: bias dtype {bias.dtype} "
                            f"is not a float type")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window must be >= 1, got "
                         f"{window}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apex_flash_fwd.argtypes = [
        p, p, p, p, ctypes.c_longlong, ctypes.c_longlong, p, p,
        i, i, i, i, ctypes.c_float, i, i, i, p]
    lib.apex_flash_fwd.restype = ctypes.c_int
    return lib


def _launch(q3, k3, v3, bias, scale, causal, window):
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    bstride = qstride = 0
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        bstride = bias.shape[1] * sk if bias.shape[0] > 1 else 0
        qstride = sk if bias.shape[1] > 1 else 0
    lib = _lib()
    with torch.cuda.device(q3.device):
        err = lib.apex_flash_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
            None if bias is None else bias.data_ptr(), bstride, qstride,
            out.data_ptr(), lse.data_ptr(), bh, sq, sk, d, float(scale),
            int(bool(causal)), int(window or 0), dtype_code(q3.dtype),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_fwd(q3, k3, v3, bias, scale, causal, window=None,
                        dropout_p=0.0):
    """q3 (BH, Sq, D), k3/v3 (BH, Sk, D), bias (BH|1, Sq|1, Sk) or None.
    ``window`` (with ``causal``) keeps keys in (t - window, t].  Returns
    (out (BH, Sq, D) in q's dtype, lse (BH, Sq) fp32)."""
    _validate(q3, k3, v3, bias, window, dropout_p)
    if not causal:
        window = None    # the band is defined against the causal direction
    if use_kernel(q3, k3, v3, bias):
        return _launch(q3, k3, v3, bias, scale, causal, window)
    return flash_attention_reference(q3, k3, v3, bias, scale, causal, window)
