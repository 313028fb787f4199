"""KV-cache helpers, the float-cache subset of
``apex_tpu/inference/quant.py``.

A cache is a plain ``(B, H, S_max, D)`` tensor.  Unlike the JAX package,
whose arrays are immutable, :func:`kv_write` writes into the cache in
place (and returns it), so decoding allocates no new cache per step.  The
int8 cache comes with the int8 slice.
"""
from __future__ import annotations

import torch


def _is_int8(dtype) -> bool:
    return dtype == "int8" or dtype == torch.int8


def make_kv_cache(shape, dtype, device):
    """Zeros cache of ``shape (B, H, S, D)`` in a float ``dtype``."""
    if _is_int8(dtype):
        raise NotImplementedError(
            "the int8 KV cache is ported with the int8 slice")
    return torch.zeros(shape, dtype=dtype, device=device)


def kv_write(cache, new, start):
    """Write ``new (B, H, S_c, D)`` into ``cache`` at the 4-d index tuple
    ``start``, in place; returns the cache.  A write that does not fit
    raises (the JAX package's ``dynamic_update_slice`` would clamp it)."""
    if len(start) != cache.dim() or new.dim() != cache.dim():
        raise ValueError(f"kv_write: start {start} / new {tuple(new.shape)} "
                         f"do not match a {cache.dim()}-d cache")
    idx = []
    for s, n, c in zip(start, new.shape, cache.shape):
        s = int(s)
        if s < 0 or s + n > c:
            raise ValueError(
                f"kv_write: a write of {tuple(new.shape)} at {tuple(start)} "
                f"does not fit the cache {tuple(cache.shape)}")
        idx.append(slice(s, s + n))
    cache[tuple(idx)] = new.to(cache.dtype)
    return cache


def kv_value(cache, dtype=torch.float32):
    """Read the cache as ``dtype`` (fp32 by default)."""
    return cache.to(dtype)
