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
so the bias corrections are computed on the host.
"""
from __future__ import annotations

import torch

from .. import ops
from .base import group_buckets


class FusedLAMB(torch.optim.Optimizer):
    """LAMB with global-grad-norm clipping and per-tensor trust ratios
    (``adam_w_mode=True`` decouples the weight decay)."""

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
        for group in self.param_groups:
            group["step"] = group.get("step", 0) + 1
        flag = self._overflow_buf
        for gi, plist in buckets:
            group = self.param_groups[gi]
            for p in plist:
                state = self.state[p]
                if len(state) == 0:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
            grads = [p.grad for p in plist]
            ms = [self.state[p]["exp_avg"] for p in plist]
            vs = [self.state[p]["exp_avg_sq"] for p in plist]
            _, grad_norm, _ = ops.multi_tensor_l2norm(flag, [grads])
            beta1, beta2 = group["betas"]
            _, new_ps, new_ms, new_vs = ops.multi_tensor_lamb(
                flag, [grads, plist, ms, vs], group["lr"], beta1, beta2,
                group["eps"], group["step"], bool(group["bias_correction"]),
                group["weight_decay"], 1 if group["grad_averaging"] else 0,
                self.adam_w_mode, grad_norm, group["max_grad_norm"])
            torch._foreach_copy_(plist + ms + vs, new_ps + new_ms + new_vs)
        return loss
