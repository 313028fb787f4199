"""Rolling (modular) KV cache for sliding-window decode, the PyTorch
counterpart of ``apex_tpu/inference/rolling.py``.

A ``sliding_window=w`` model attends only the last ``w`` positions, so its
decode cache holds ``w + ROLLING_SLACK`` slots: position ``p`` lives in
slot ``p % n_slots``.  After positions ``0 .. t_hi - 1`` are written, slot
``s`` holds global position ``t_hi - 1 - ((t_hi - 1 - s) mod n_slots)``
(:func:`rolling_slot_positions`, negative iff never written), and the
attention mask derives validity from that closed form alone.
"""
from __future__ import annotations

import torch

#: Extra slots past the window in every rolling cache: speculative decoding
#: rewinds after rejected proposals, and a stale write of up to SLACK rows
#: then aliases to a position at least a window behind every later query,
#: which the band excludes.  Bounds the verification chunk: k + 1 <= SLACK.
ROLLING_SLACK = 32


def rolling_slot_positions(n_slots, t_hi):
    """Global position held by each of the ``n_slots`` slots once positions
    ``0 .. t_hi - 1`` are written (``t_hi`` a Python int or a 0-d device
    tensor): the largest ``p < t_hi`` with ``p % n_slots == s``; negative
    means never written.  int64."""
    dev = t_hi.device if isinstance(t_hi, torch.Tensor) else None
    last = t_hi - 1
    s = torch.arange(n_slots, device=dev)
    return last - torch.remainder(last - s, n_slots)


def window_retired_blocks(t_hi, window, block_size):
    """The count of leading ``block_size`` blocks that no future query of a
    window-``window`` model can reach once positions ``0 .. t_hi - 1`` are
    written: block ``b`` retires once ``(b + 1) * bs - 1 < t_hi - w``.
    Host int math."""
    if window is None:
        return 0
    return max(0, (int(t_hi) - int(window)) // int(block_size))


def rolling_kv_write(cache, new, t0):
    """Write chunk ``new (B, H, S_c, D)`` at global positions ``t0 ..``
    into the rolling cache (slot = position mod the slot count), in place;
    returns the cache.  A chunk longer than the cache keeps only its last
    ``n_slots`` rows (the earlier ones are out of every later query's
    band).  ``t0`` is a Python int or a 0-d int64 device tensor.  A
    QuantKV quantizes per position first (the values a full-cache write
    stores)."""
    from .quant import QuantKV, _absmax_int8

    w, s_c = cache.shape[2], new.shape[2]
    if s_c > w:
        return rolling_kv_write(cache, new[:, :, s_c - w:, :],
                                t0 + (s_c - w))
    dev = new.device
    base = t0 + torch.arange(s_c, device=dev) \
        if isinstance(t0, torch.Tensor) \
        else torch.arange(t0, t0 + s_c, device=dev)
    slots = torch.remainder(base, w)

    def write(arr, src):
        arr.index_copy_(2, slots, src.to(arr.dtype))

    if isinstance(cache, QuantKV):
        q, scale = _absmax_int8(new.to(torch.float32), -1,
                                cache.scale.dtype)
        write(cache.q, q)
        write(cache.scale, scale)
        return cache
    write(cache, new)
    return cache
