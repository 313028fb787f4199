"""FusedAdam, the PyTorch counterpart of ``apex_tpu/optimizers/fused_adam.py``
(and of the reference's ``apex/optimizers/fused_adam.py``).

A ``torch.optim.Optimizer`` whose ``step()`` runs one
:func:`apex_tpu_torch.ops.multi_tensor_adam` per (param group x dtype)
bucket: on the card one launch of the hand-written Adam kernel each, which
updates params and moments in place.  The step count is a Python int per
group, so the bias corrections are computed on the host.  The step is
skipped when ``_overflow_buf`` (an int32 device scalar) is set.  The
moments take each parameter's dtype, as in the JAX package, so half
parameters (amp O3) keep half moments; the update itself is fp32.
Under amp's deferred scale update the step skips on the scaler's device
flag and keeps its step counts on the device (``base.deferred_update``).
"""
from __future__ import annotations

import torch

from .. import ops
from .base import (bias_correction, deferred_update, group_buckets,
                   take_deferred_scaler)


class FusedAdam(torch.optim.Optimizer):
    """Drop-in replacement for torch.optim.Adam / AdamW
    (``adam_w_mode=True`` selects decoupled weight decay)."""

    #: amp's deferred scale update may run in this optimizer's step
    _step_cache_scaler_ok = True

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
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
    def step(self, closure=None, grads=None, output_params=None, scale=None,
             grad_norms=None):
        if any(x is not None for x in [grads, output_params, scale,
                                       grad_norms]):
            raise RuntimeError(
                "FusedAdam has been updated.  Simply initialize it "
                "identically to torch.optim.Adam, and call step() with no "
                "arguments.")
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
            for gi, plist in buckets:
                group = self.param_groups[gi]
                beta1, beta2 = group["betas"]
                bcs = None if bc_of is None or not group["bias_correction"] \
                    else (bc_of(bias_correction, beta1, group),
                          bc_of(bias_correction, beta2, group))
                ops.multi_tensor_adam(
                    flag,
                    [[p.grad for p in plist], plist,
                     [self.state[p]["exp_avg"] for p in plist],
                     [self.state[p]["exp_avg_sq"] for p in plist]],
                    group["lr"], beta1, beta2, group["eps"], step_of(group),
                    self.adam_w_mode, bool(group["bias_correction"]),
                    group["weight_decay"], bias_corrections=bcs)

        scaler = take_deferred_scaler(self)
        if scaler is not None:
            deferred_update(self, scaler, update)
            return loss
        for group in self.param_groups:
            group["step"] = group.get("step", 0) + 1
        update(self._overflow_buf, lambda g: g["step"], None)
        return loss
