"""Bucketing helpers of the fused optimizers, the PyTorch counterpart of
``apex_tpu/optimizers/base.py``.

The port's optimizers subclass ``torch.optim.Optimizer`` itself, so the
JAX package's ``Optimizer`` base class (param groups, state, zero_grad,
state_dict for jax arrays) has no counterpart here; what remains is how a
step cuts the parameters into the units one kernel launch updates.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import torch


def split_by_dtype(params: Iterable[torch.Tensor]) -> Dict[torch.dtype,
                                                            List[torch.Tensor]]:
    """Params that have a gradient, grouped by storage dtype in order."""
    buckets: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is None:
            continue
        buckets.setdefault(p.dtype, []).append(p)
    return buckets


def group_buckets(param_groups):
    """``(group_index, [param, ...])`` dtype buckets across all param
    groups, in order: one kernel launch each."""
    out = []
    for gi, group in enumerate(param_groups):
        for plist in split_by_dtype(group["params"]).values():
            out.append((gi, plist))
    return out
