"""FusedLAMB, the PyTorch counterpart of ``apex_tpu/optimizers/fused_lamb.py``
(and of the reference's ``apex/optimizers/fused_lamb.py``).

A ``torch.optim.Optimizer`` whose ``step()`` runs, for each (param group x
dtype) bucket, the L2 norm of the bucket's gradients (the norm that
``max_grad_norm`` clips by, as in the JAX package and the reference's
host function) and :func:`apex_tpu_torch.ops.multi_tensor_lamb`: Adam
moments, per-tensor trust ratios.  LAMB is jnp in the JAX package, so it is
plain PyTorch here, one tensor at a time, and the new values are copied
into the params and moments in place.  The moments take each parameter's
dtype, as in the JAX package.  The step count is a Python int per group,
so the bias corrections are computed on the host.  Under amp's deferred
scale update the step keeps its old values where the scaler's device flag
is set and its step counts on the device (``base.deferred_update``).
"""
from __future__ import annotations

import torch

from .. import ops
from .base import (bias_correction, deferred_update, group_buckets,
                   take_deferred_scaler)


class FusedLAMB(torch.optim.Optimizer):
    """LAMB with global-grad-norm clipping and per-tensor trust ratios
    (``adam_w_mode=True`` decouples the weight decay)."""

    #: amp's deferred scale update may run in this optimizer's step
    _step_cache_scaler_ok = True

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm)
        super().__init__(params, defaults)
        self.adam_w_mode = 1 if adam_w_mode else 0
        self.set_grad_none = set_grad_none
        first = next(p for g in self.param_groups for p in g["params"])
        self._overflow_buf = ops.zero_flag(first.device)

    def zero_grad(self, set_to_none: bool = None):
        if set_to_none is None:
            set_to_none = self.set_grad_none
        super().zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()

        buckets = group_buckets(self.param_groups)
        if not buckets:
            return loss
        for _, plist in buckets:
            for p in plist:
                state = self.state[p]
                if len(state) == 0:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)

        def update(flag, step_of, bc_of):
            skip = None if bc_of is None else flag.reshape(()) > 0
            for gi, plist in buckets:
                group = self.param_groups[gi]
                grads = [p.grad for p in plist]
                ms = [self.state[p]["exp_avg"] for p in plist]
                vs = [self.state[p]["exp_avg_sq"] for p in plist]
                _, grad_norm, _ = ops.multi_tensor_l2norm(flag, [grads])
                beta1, beta2 = group["betas"]
                bcs = None if bc_of is None or not group["bias_correction"] \
                    else (bc_of(bias_correction, beta1, group),
                          bc_of(bias_correction, beta2, group))
                _, new_ps, new_ms, new_vs = ops.multi_tensor_lamb(
                    flag, [grads, plist, ms, vs], group["lr"], beta1, beta2,
                    group["eps"], step_of(group),
                    bool(group["bias_correction"]), group["weight_decay"],
                    1 if group["grad_averaging"] else 0, self.adam_w_mode,
                    grad_norm, group["max_grad_norm"], bias_corrections=bcs)
                olds, news = plist + ms + vs, new_ps + new_ms + new_vs
                if skip is not None:
                    # the deferred mode's skip, on the device
                    news = [torch.where(skip, o, n) for o, n in zip(olds,
                                                                    news)]
                torch._foreach_copy_(olds, news)

        scaler = take_deferred_scaler(self)
        if scaler is not None:
            deferred_update(self, scaler, update)
            return loss
        for group in self.param_groups:
            group["step"] = group.get("step", 0) + 1
        update(self._overflow_buf, lambda g: g["step"], None)
        return loss
