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


# ---------------------------------------------------------------------------
# amp's deferred scale update (amp.initialize(..., defer_scale_update=True))
# ---------------------------------------------------------------------------


def take_deferred_scaler(optimizer):
    """The loss scaler that amp's deferred mode handed ``optimizer`` for
    this step (cleared as it is taken), or None on the ordinary path."""
    stash = getattr(optimizer, "_amp_stash", None)
    scaler = getattr(stash, "_deferred_scaler", None)
    if scaler is not None:
        stash._deferred_scaler = None
    return scaler


class DeferredSteps:
    """What a fused optimizer keeps on the device for amp's deferred mode,
    where a step may be skipped without the host knowing: each param
    group's step count (an int32 device scalar, which a skipped step does
    not advance), and tables of the bias corrections the ordinary path
    computes on the host in double (``1 - beta ** step``, or its square
    root), rounded to fp32, one entry a step count, indexed on the device
    by the device count.  So a deferred step takes the same bits as the
    ordinary one, and reads nothing back.  Each table gains its entries by
    fills on the device, one a new step count, so no copy from the host
    waits on the card."""

    def __init__(self, device):
        self.device = device
        self.calls = 0
        self.base = 0           # the largest host count made a device one
        self._tables: dict = {}

    def step_of(self, group):
        """The group's device step count, made from its host count on
        the first deferred step."""
        s = group.get("step", 0)
        if not isinstance(s, torch.Tensor):
            self.base = max(self.base, int(s))
            s = torch.full((), int(s), dtype=torch.int32, device=self.device)
            group["step"] = s
        return s

    def correction(self, fn, beta, step):
        """``fn(beta, k)`` (a host double) rounded to fp32, at the device
        step count ``step``; the table holds every count up to the host
        counts plus the deferred calls made, a bound on the device's."""
        key = (fn, beta)
        table, filled = self._tables.get(key, (None, 0))
        need = self.base + self.calls
        if table is None or table.numel() < need + 1:
            grown = torch.ones(max(1024, 2 * (need + 1)), dtype=torch.float32,
                               device=self.device)
            if table is not None:
                grown[:table.numel()].copy_(table)
            table = grown
        for k in range(filled, need + 1):
            table[k].fill_(fn(beta, k))
        self._tables[key] = (table, max(filled, need + 1))
        # index_select: indexing by a 0-dim tensor would read it back
        return table.index_select(0, step.long().reshape(1)).reshape(())


def bias_correction(beta, k):
    return 1.0 - beta ** k


def sqrt_bias_correction(beta, k):
    return (1.0 - beta ** k) ** 0.5


def deferred_update(optimizer, scaler, update):
    """One optimizer step under amp's deferred mode: ``update(flag, step,
    bc)`` runs every group's update with the scaler's device overflow flag
    as its skip flag, ``step(group)`` the group's new device step count
    and ``bc(fn, beta, group)`` a bias correction at it; then each group's
    count advances where the flag is clear and the loss scale is updated,
    all on the device."""
    from ..amp.scaler import update_scale_state
    first = next(p for g in optimizer.param_groups for p in g["params"])
    steps = optimizer.__dict__.setdefault("_deferred_steps",
                                          DeferredSteps(first.device))
    steps.calls += 1
    # a static scale never skips (the ordinary path's update_scale)
    flag = scaler.state.overflow if scaler.dynamic \
        else torch.zeros_like(scaler.state.overflow)
    new = {id(g): steps.step_of(g) + 1 for g in optimizer.param_groups}
    update(flag, lambda g: new[id(g)],
           lambda fn, beta, g: steps.correction(fn, beta, new[id(g)]))
    skip = flag > 0
    for g in optimizer.param_groups:
        g["step"].copy_(torch.where(skip, g["step"], new[id(g)]))
    scaler.state, _ = update_scale_state(
        scaler.state, dynamic=scaler.dynamic,
        scale_factor=scaler._scale_factor,
        scale_window=scaler._scale_seq_len,
        min_loss_scale=scaler._min_loss_scale,
        max_loss_scale=scaler._max_loss_scale)
