"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` and their
plain PyTorch versions.

Port of ``apex_tpu/kernels/attention.py::flash_attention_fwd``: q3 (BH, Sq,
D), k3/v3 (BH, Sk, D), an additive bias broadcastable as (BH|1, Sq|1, Sk),
top-left causal masking with an optional Mistral band, the scale applied
after q.k^T, masked scores at the finite -1e30.  Returns ``out`` in q's
dtype and the per-row logsumexp ``lse (BH, Sq)`` in fp32.  And of
``flash_attention_bwd``: the probabilities recomputed from ``lse``,
``delta = rowsum(g * out)`` in fp32 (plain PyTorch, as the JAX package
computes it outside its kernels), then ``dq``, ``dk``, ``dv`` in the
inputs' dtypes.  A CUDA tensor launches the kernels; a CPU tensor takes the
plain versions (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_reference`).  In-kernel attention dropout
(``_hash_keep_u32`` in the JAX package) is not ported yet: ``dropout_p > 0``
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .dispatch import LAUNCHES, MASKED_FILL, check_dtype, dtype_code, \
    use_kernel

MAX_HEAD_DIM = 128   # both sources keep D / 16 output columns a thread

LAUNCHES.setdefault("flash_attention_fwd", 0)
LAUNCHES.setdefault("flash_attention_bwd_dq", 0)
LAUNCHES.setdefault("flash_attention_bwd_dkv", 0)


def _scores(q3, k3, bias, scale, causal, window):
    """fp32 scores as the kernels see them: scale after q.k^T, the bias,
    then the causal / band mask at -1e30."""
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
    return s


def flash_attention_reference(q3, k3, v3, bias, scale, causal, window=None):
    """The plain version: materialised fp32 scores, softmax, product."""
    s = _scores(q3, k3, bias, scale, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.softmax(s, dim=-1), v3.float())
    return out.to(q3.dtype), lse


def _delta(g, out):
    """rowsum(g * out) in fp32, (BH, Sq)."""
    return (g.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_reference(q3, k3, v3, bias, out, lse, g, scale,
                                  causal, window=None):
    """The plain version of the backward: the fp32 probabilities recomputed
    from ``lse``, then the five products, materialised."""
    p = torch.exp(_scores(q3, k3, bias, scale, causal, window)
                  - lse[..., None])
    gf = g.float()
    ds = p * (torch.matmul(gf, v3.float().transpose(1, 2))
              - _delta(g, out)[..., None])
    dq = torch.matmul(ds, k3.float()) * scale
    dk = torch.matmul(ds.transpose(1, 2), q3.float()) * scale
    dv = torch.matmul(p.transpose(1, 2), gf)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def _validate(q3, k3, v3, bias, window, dropout_p,
              what="flash_attention_fwd"):
    if dropout_p:
        raise NotImplementedError(
            "flash attention: in-kernel attention dropout is not ported "
            "yet")
    for name, t in (("q3", q3), ("k3", k3), ("v3", v3)):
        if t.dim() != 3:
            raise ValueError(f"{what}: {name} must be (BH, S, D), got "
                             f"shape {tuple(t.shape)}")
        check_dtype(t, f"{what} {name}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if not q3.dtype == k3.dtype == v3.dtype:
        raise TypeError(f"{what}: q/k/v dtypes differ ({q3.dtype}, "
                        f"{k3.dtype}, {v3.dtype})")
    bh, sq, d = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(f"{what}: q {tuple(q3.shape)}, k "
                         f"{tuple(k3.shape)}, v {tuple(v3.shape)} do not "
                         f"match")
    sk = k3.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} > {MAX_HEAD_DIM}, which "
                         f"the kernel does not take")
    if min(bh, sq, sk, d) == 0:
        raise ValueError(f"{what}: empty input {tuple(q3.shape)} x "
                         f"{tuple(k3.shape)}")
    if bias is not None:
        if bias.dim() != 3 or bias.shape[0] not in (1, bh) \
                or bias.shape[1] not in (1, sq) or bias.shape[2] != sk:
            raise ValueError(f"{what}: bias shape {tuple(bias.shape)} is "
                             f"not ({bh}|1, {sq}|1, {sk})")
        if not bias.is_floating_point():
            raise TypeError(f"{what}: bias dtype {bias.dtype} is not a "
                            f"float type")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")


def _validate_bwd(q3, k3, v3, bias, out, lse, g, window, dropout_p):
    _validate(q3, k3, v3, bias, window, dropout_p, "flash_attention_bwd")
    for name, t in (("out", out), ("g", g)):
        if tuple(t.shape) != tuple(q3.shape):
            raise ValueError(f"flash_attention_bwd: {name} shape "
                             f"{tuple(t.shape)} != q shape "
                             f"{tuple(q3.shape)}")
        check_dtype(t, f"flash_attention_bwd {name}")
    if tuple(lse.shape) != tuple(q3.shape[:2]) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be fp32 of shape "
                         f"{tuple(q3.shape[:2])}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apex_flash_fwd.argtypes = [
        p, p, p, p, ll, ll, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
    lib.apex_flash_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd():
    lib = _build.load("flash_attention_bwd")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.apex_flash_bwd_dq.argtypes = [
        p, p, p, p, ll, ll, p, p, p, p, i, i, i, i, f, i, i, i, p]
    lib.apex_flash_bwd_dq.restype = i
    lib.apex_flash_bwd_dkv.argtypes = [
        p, p, p, p, ll, ll, p, p, p, p, p, i, i, i, i, f, i, i, i, p]
    lib.apex_flash_bwd_dkv.restype = i
    return lib


def _bias_layout(bias, sk):
    """The bias as a contiguous fp32 tensor and its (batch, row) strides in
    elements, 0 where it broadcasts."""
    if bias is None:
        return None, 0, 0
    bias = bias.to(torch.float32).contiguous()
    bstride = bias.shape[1] * sk if bias.shape[0] > 1 else 0
    qstride = sk if bias.shape[1] > 1 else 0
    return bias, bstride, qstride


def _launch(q3, k3, v3, bias, scale, causal, window):
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    bias, bstride, qstride = _bias_layout(bias, sk)
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


def _launch_bwd(q3, k3, v3, bias, out, lse, g, scale, causal, window):
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    g = g.to(q3.dtype).contiguous()
    delta = _delta(g, out).contiguous()
    lse = lse.contiguous()
    bias, bstride, qstride = _bias_layout(bias, sk)
    dq = torch.empty_like(q3)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    lib = _lib_bwd()
    common = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
              None if bias is None else bias.data_ptr(), bstride, qstride,
              g.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (bh, sq, sk, d, float(scale), int(bool(causal)), int(window or 0),
            dtype_code(q3.dtype))
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_flash_bwd_dq(*common, dq.data_ptr(), *tail, stream)
        _build.check(lib, err, "flash_attention_bwd (dq)")
        LAUNCHES["flash_attention_bwd_dq"] += 1
        err = lib.apex_flash_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(),
                                     *tail, stream)
        _build.check(lib, err, "flash_attention_bwd (dk, dv)")
        LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dq, dk, dv


def flash_attention_bwd(q3, k3, v3, bias, out, lse, g, scale, causal,
                        window=None, dropout_p=0.0):
    """The backward of :func:`flash_attention_fwd` from its inputs, its
    ``out`` and ``lse`` and the gradient ``g`` of ``out``.  Returns
    ``(dq, dk, dv)`` with the shapes and dtypes of q3, k3, v3."""
    _validate_bwd(q3, k3, v3, bias, out, lse, g, window, dropout_p)
    if not causal:
        window = None
    if use_kernel(q3, k3, v3, bias, out, lse, g):
        return _launch_bwd(q3, k3, v3, bias, out, lse, g, scale, causal,
                           window)
    return flash_attention_bwd_reference(q3, k3, v3, bias, out, lse, g,
                                         scale, causal, window)
