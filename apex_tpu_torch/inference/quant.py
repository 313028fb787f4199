"""Weight-only int8 quantization and the KV-cache helpers, the PyTorch
counterpart of ``apex_tpu/inference/quant.py``.

Weights (w8a16): :func:`quantize_int8` replaces each selected parameter
of a module by two buffers of that module, ``<name>_q`` (int8, the
original shape) and ``<name>_scale`` (one scale a leading row), and gives
the module a class of its own (``reparameterization``'s mechanism) on
which ``<name>`` is a property that dequantizes on every read.  So every
reader of the attribute (``nn.Linear.forward``, ``_linear(h,
self.q_proj.weight)``) sees the dequantized weight at the point of use,
and :func:`gather_rows` dequantizes only the selected rows of an
embedding.  A quantized model is inference-only: ``make_train_step``
refuses it, and ``reparameterization`` refuses an int8 weight.

KV caches: a float cache is a plain ``(B, H, S_max, D)`` tensor; an int8
cache is a :class:`QuantKV` of int8 values and one fp32 scale a cached
position.  Unlike the JAX package, whose arrays are immutable,
:func:`kv_write` writes into the cache in place (and returns it), so
decoding allocates no new cache per step.  The write position may be a
Python int or a 0-d int64 tensor on the cache's device: the tensor path
writes through ``index_copy_`` along the time axis, so a captured CUDA
graph reads the position where it lies and every replay writes the next
slot.  Both paths store the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantTensor(NamedTuple):
    """Int8 weight + per-leading-row scale; dequantizes to
    ``scale.dtype``."""
    q: torch.Tensor          # int8, the original shape
    scale: torch.Tensor      # (rows, 1, ..., 1), fp

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def size(self):
        return self.q.numel()

    def dequant(self):
        return self.q.to(self.scale.dtype) * self.scale


def _absmax_int8(xf, axis, scale_dtype):
    """The symmetric-absmax int8 core shared by weight and KV-cache
    quantization: ``xf`` fp32, reduced over ``axis`` (an int or a tuple).
    The scale is cast to ``scale_dtype`` before rounding, so quantization
    and dequantization use the one stored scale value."""
    absmax = torch.clamp_min(
        torch.amax(torch.abs(xf), dim=axis, keepdim=True), 1e-12)
    # a true division by a tensor: CUDA divides by a Python scalar as a
    # product with its reciprocal, which can round the other way
    scale = (absmax / torch.full_like(absmax, 127.0)).to(scale_dtype)
    q = torch.clamp(torch.round(xf / scale.to(torch.float32)),
                    -127, 127).to(torch.int8)
    return q, scale


#: the public name of the absmax core
absmax_int8 = _absmax_int8


def quantize_tensor_int8(x, dtype=None):
    """Absmax-per-row symmetric int8: ``x (rows, ...)`` -> QuantTensor with
    one scale per leading row.  ``dtype``: the dequantization dtype
    (default: x's)."""
    if x.dim() < 2:
        raise ValueError(
            f"quantize_tensor_int8 expects a >=2-D weight, got shape "
            f"{tuple(x.shape)} — 1-D params (norms/biases) stay full "
            f"precision")
    x = x.detach()
    q, scale = _absmax_int8(x.to(torch.float32), tuple(range(1, x.dim())),
                            dtype or x.dtype)
    return QuantTensor(q, scale)


def _dequantized(name):
    def get(module):
        return QuantTensor(getattr(module, f"{name}_q"),
                           getattr(module, f"{name}_scale")).dequant()
    return property(get)


def quantized_names(module):
    """The names of ``module``'s own weights that are int8."""
    return module.__dict__.get("_quantized", ())


def raw(module, name="weight"):
    """``module.<name>`` as stored: a :class:`QuantTensor` for an int8
    weight, else the tensor."""
    if name in quantized_names(module):
        return QuantTensor(getattr(module, f"{name}_q"),
                           getattr(module, f"{name}_scale"))
    return getattr(module, name)


def is_quantized(model):
    return any(quantized_names(m) for m in model.modules())


def quantize_int8(model, min_size=4096, dtype=None):
    """Quantize a model's weight matrices to int8 in place, for decode.

    Every parameter with ``ndim >= 2`` and at least ``min_size`` elements
    is replaced (projection weights, embeddings); 1-D parameters and small
    tensors stay full precision, and so do the source parameters of a
    reparameterization (merge first to quantize the composed weight).
    Returns the model, now in ``eval()`` mode.  ``dtype`` sets the
    dequantization dtype (default: each weight's own)."""
    from ..reparameterization.reparameterization import \
        _reparameterized_class
    n = 0
    for m in list(model.modules()):
        sources = set()
        for fn in (m.__dict__.get("_reparameterizations") or {}).values():
            sources.update(fn.reparameterization_names)
        for name, p in list(m._parameters.items()):
            if p is None or name in sources or p.dim() < 2 \
                    or p.numel() < min_size:
                continue
            qt = quantize_tensor_int8(p, dtype=dtype)
            del m._parameters[name]
            m.register_buffer(f"{name}_q", qt.q)
            m.register_buffer(f"{name}_scale", qt.scale)
            m._quantized = quantized_names(m) + (name,)
            setattr(_reparameterized_class(m), name, _dequantized(name))
            n += 1
    if n == 0:
        raise ValueError(
            f"quantize_int8: no parameter met the criteria (ndim >= 2, "
            f"size >= {min_size}) — nothing was quantized")
    model.eval()
    return model


def gather_rows(param, ids):
    """Embedding-style row gather that stays int8 until after the gather:
    for a :class:`QuantTensor` (``raw(module)`` of a quantized table) only
    the selected rows dequantize; a tensor is indexed as it is."""
    if isinstance(param, QuantTensor):
        return param.q[ids].to(param.scale.dtype) * param.scale[ids]
    return param[ids]


# ---------------------------------------------------------------- KV cache


class QuantKV(NamedTuple):
    """Int8 KV cache: values ``(B, H, S, D)`` int8 with one fp32 scale per
    cached position ``(B, H, S, 1)``, per-position absmax (each position
    is quantized once, when written)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.scale.dtype


def _is_int8(dtype) -> bool:
    return dtype == "int8" or dtype == torch.int8


def make_kv_cache(shape, dtype, device=None):
    """Zeros cache of ``shape (B, H, S, D)``: a tensor for a float
    ``dtype``, a :class:`QuantKV` for int8 (the string ``"int8"`` or
    ``torch.int8``) with fp32 scales."""
    if _is_int8(dtype):
        return QuantKV(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(tuple(shape[:-1]) + (1,), dtype=torch.float32,
                        device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def positions(t0, s_c, device):
    """Positions ``t0 .. t0 + s_c - 1`` as an int64 tensor on ``device``;
    ``t0`` a Python int or a 0-d int64 tensor there."""
    if isinstance(t0, torch.Tensor):
        return t0 + torch.arange(s_c, device=device)
    return torch.arange(t0, t0 + s_c, device=device)


def _write(arr, src, start):
    t0 = start[2]
    if isinstance(t0, torch.Tensor):
        if any(int(s) != 0 for i, s in enumerate(start) if i != 2) or \
                any(src.shape[i] != arr.shape[i] for i in (0, 1, 3)):
            raise ValueError(
                f"kv_write: a device position writes whole (B, H, ., D) "
                f"rows; got {tuple(src.shape)} at {start} into "
                f"{tuple(arr.shape)}")
        arr.index_copy_(2, positions(t0, src.shape[2], arr.device),
                        src.to(arr.dtype))
        return
    idx = []
    for s, n, c in zip(start, src.shape, arr.shape):
        s = int(s)
        if s < 0 or s + n > c:
            raise ValueError(
                f"kv_write: a write of {tuple(src.shape)} at {tuple(start)} "
                f"does not fit the cache {tuple(arr.shape)}")
        idx.append(slice(s, s + n))
    arr[tuple(idx)] = src.to(arr.dtype)


def kv_write(cache, new, start):
    """Write ``new (B, H, S_c, D)`` into ``cache`` at the 4-d index tuple
    ``start``, in place; returns the cache.  ``start[2]`` may be a 0-d
    int64 device tensor (the other entries 0).  A QuantKV quantizes each
    written position against its own absmax.  A Python-int write that does
    not fit raises (the JAX package's ``dynamic_update_slice`` would clamp
    it); a device position is the caller's to bound."""
    if len(start) != 4 or new.dim() != 4 or len(cache.shape) != 4:
        raise ValueError(f"kv_write: start {start} / new {tuple(new.shape)} "
                         f"do not match a 4-d cache")
    if isinstance(cache, QuantKV):
        q, scale = _absmax_int8(new.to(torch.float32), -1,
                                cache.scale.dtype)
        _write(cache.q, q, start)
        _write(cache.scale, scale, start)
        return cache
    _write(cache, new, start)
    return cache


def kv_value(cache, dtype=torch.float32):
    """Read the cache as ``dtype`` (fp32 by default; a QuantKV
    dequantizes)."""
    if isinstance(cache, QuantKV):
        return cache.q.to(dtype) * cache.scale.to(dtype)
    return cache.to(dtype)
