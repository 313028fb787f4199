"""Carry weights between the JAX package and the port.

The port keeps the JAX package's parameter names (``tok_emb.weight``,
``blocks.{i}.attn.in_proj_weight``, ``blocks.{i}.fc1.weight``, ...,
``ln_f.bias``) and layouts (Linear weights are (out, in) on both sides), so
the state dict maps one to one.  Buffers travel with the parameters:
BatchNorm's running statistics, and its ``num_batches_tracked``, an int32
in the JAX package and an int64 here (each side's integer dtype is kept).
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_state_dict(model: torch.nn.Module, sd) -> torch.nn.Module:
    """Copy ``sd`` (``{name: np.ndarray}``, e.g. ``np.asarray`` over each
    value of an ``apex_tpu`` module's ``state_dict()``) into ``model``, cast
    to each parameter's device and dtype.  The key sets must be equal and
    every shape must match, or this raises before copying anything."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict keys differ: missing {missing}, "
                       f"unexpected {unexpected}")
    arrays = {}
    for name, t in own.items():
        arr = np.asarray(sd[name])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"match the model's {tuple(t.shape)}")
        if arr.dtype.name == "bfloat16":
            # numpy's bfloat16 (ml_dtypes) has no torch.from_numpy
            # counterpart; fp32 holds it exactly
            arr = arr.astype(np.float32)
        arrays[name] = arr
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(torch.from_numpy(np.array(arrays[name])))
    return model


def to_numpy_state_dict(model: torch.nn.Module) -> dict:
    """The inverse of :func:`from_jax_state_dict`: ``{name: np.ndarray}``
    under the JAX package's names, on the host (bf16 values widened to
    fp32, which holds them exactly, since numpy has no bf16; int64 counters
    narrowed to the JAX package's int32)."""
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif t.dtype == torch.int64:
            if t.numel() and t.abs().max() > torch.iinfo(torch.int32).max:
                raise OverflowError(f"{name}: {t.abs().max()} does not fit "
                                    f"the JAX package's int32")
            t = t.to(torch.int32)
        out[name] = t.numpy().copy()
    return out
