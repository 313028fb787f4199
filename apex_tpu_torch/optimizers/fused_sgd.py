"""FusedSGD, the PyTorch counterpart of ``apex_tpu/optimizers/fused_sgd.py``
(and of the reference's ``apex/optimizers/fused_sgd.py``).

A ``torch.optim.Optimizer`` whose ``step()`` runs one
:func:`apex_tpu_torch.ops.multi_tensor_sgd` per launch set: on the card one
launch of the hand-written SGD kernel each, which updates params and
momentum buffers (fp32) in place.  Without amp the launch sets are the
(param group x dtype) buckets.  Under amp with master weights (an
``_amp_stash`` holding ``fp32_from_fp16_groups``) each group gives two: a
depth-4 launch over the fp32 masters of the half parameters that also
writes the half model copy, and a depth-3 launch over the parameters that
were fp32 already.  With ``materialize_master_grads=False`` the depth-4
launch reads the half model gradients, still scaled, and amp's
``most_recent_scale`` is folded into the kernel's ``scale``.  The step is
skipped when ``_overflow_buf`` (an int32 device scalar) is set.
"""
from __future__ import annotations

import torch
from torch.optim.optimizer import required

from .. import ops
from .base import split_by_dtype


class FusedSGD(torch.optim.Optimizer):
    """Drop-in replacement for torch.optim.SGD with multi-tensor batching
    (``wd_after_momentum`` adds the weight decay to the update after the
    momentum instead of to the gradient before it)."""

    def __init__(self, params, lr=required, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True):
        if lr is not required and lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if momentum < 0.0:
            raise ValueError(f"Invalid momentum value: {momentum}")
        if weight_decay < 0.0:
            raise ValueError(f"Invalid weight_decay value: {weight_decay}")
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov)
        super().__init__(params, defaults)
        self.wd_after_momentum = wd_after_momentum
        self.materialize_master_grads = materialize_master_grads
        self.most_recent_scale = 1.0
        self.scale_set_by_backward = False
        first = next(p for g in self.param_groups for p in g["params"])
        self._overflow_buf = ops.zero_flag(first.device)

    def get_momentums(self, params):
        """The fp32 momentum buffers of ``params`` (made as zeros where
        missing) and ``first_run``: whether the last one was just made."""
        momentums = []
        first_run = True
        for p in params:
            state = self.state[p]
            if "momentum_buffer" not in state:
                first_run = True
                state["momentum_buffer"] = torch.zeros_like(
                    p, dtype=torch.float32)
            else:
                first_run = False
            momentums.append(state["momentum_buffer"])
        return momentums, first_run

    def _amp_launch_sets(self, gid):
        """The two launch sets of one param group under amp's master
        weights: (lists, first_run) for the masters of the half parameters
        (depth 4) and for the fp32 parameters (depth 3)."""
        stash = self._amp_stash
        halves, masters = stash.fp16_groups[gid], \
            stash.fp32_from_fp16_groups[gid]
        if self.materialize_master_grads:
            pairs = [(h, m) for h, m in zip(halves, masters)
                     if m.grad is not None]
            grads = [m.grad for _, m in pairs]
        else:
            pairs = [(h, m) for h, m in zip(halves, masters)
                     if h.grad is not None]
            grads = [h.grad for h, _ in pairs]
        model = [h for h, _ in pairs]
        master = [m for _, m in pairs]
        m_mom, fr16 = self.get_momentums(master)
        fp32_params = [p for p in stash.fp32_from_fp32_groups[gid]
                       if p.grad is not None]
        fp32_mom, fr32 = self.get_momentums(fp32_params)
        return [([grads, master, m_mom, model], fr16),
                ([[p.grad for p in fp32_params], fp32_params, fp32_mom],
                 fr32)]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        explicit_master_params = (
            hasattr(self, "_amp_stash")
            and hasattr(self._amp_stash, "fp32_from_fp16_groups"))
        scale = 1.0 / self.most_recent_scale
        for gid, group in enumerate(self.param_groups):
            if explicit_master_params:
                sets = self._amp_launch_sets(gid)
            else:
                sets = []
                for plist in split_by_dtype(group["params"]).values():
                    moms, first_run = self.get_momentums(plist)
                    sets.append(([[p.grad for p in plist], plist, moms],
                                 first_run))
            for lists, first_run in sets:
                if not lists[0]:
                    continue
                ops.multi_tensor_sgd(
                    self._overflow_buf, lists, group["weight_decay"],
                    group["momentum"], group["dampening"], group["lr"],
                    group["nesterov"], first_run, self.wd_after_momentum,
                    scale)
        self.most_recent_scale = 1.0
        self.scale_set_by_backward = False
        return loss
