"""The two-stage FusedLAMB, the PyTorch counterpart of
``apex_tpu/contrib/optimizers/fused_lamb.py`` (the reference's
``apex/contrib/optimizers/fused_lamb.py`` over its stage-1 and stage-2
kernels).

The global L2 norm of every group's gradients (``multi_tensor_l2norm``)
gives each group's clip, ``max_grad_norm / |g|`` where the norm exceeds
``max_grad_norm`` (> 0), which multiplies the gradients.  Stage 1, per
tensor: the moments and the direction ``u = (m / bc1) / (sqrt(v / bc2) +
eps) + wd p`` (the weight decay always decoupled).  Stage 2: ``p -= lr
(|p| / |u|) u``, with the ratio 1 where either norm is 0.  The math and
the moments are fp32 whatever the storage dtype; the step count is a
Python int per group, so the bias corrections are computed on the host.
"""
from __future__ import annotations

import torch

from ... import ops


class FusedLAMB(torch.optim.Optimizer):
    """Two-stage LAMB (the contrib surface; the single-call version is
    ``optimizers.FusedLAMB``)."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        if not adam_w_mode:
            raise RuntimeError(
                "contrib FusedLAMB only supports adam_w_mode (decoupled "
                "decay), matching the stage-1 kernel")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm)
        super().__init__(params, defaults)
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

        live = []
        for group in self.param_groups:
            plist = [p for p in group["params"] if p.grad is not None]
            if not plist:
                continue
            for p in plist:
                st = self.state[p]
                if len(st) == 0:
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
            live.append((group, plist))
        if not live:
            return loss
        _, gnorm, _ = ops.multi_tensor_l2norm(
            self._overflow_buf, [[p.grad for _, pl in live for p in pl]])
        one = torch.ones((), dtype=torch.float32, device=gnorm.device)
        for group, plist in live:
            group["step"] = group.get("step", 0) + 1
            beta1, beta2 = group["betas"]
            max_norm = group["max_grad_norm"]
            clip = torch.where(gnorm > max_norm, max_norm / gnorm, one) \
                if max_norm > 0 else one
            beta3 = (1.0 - beta1) if group["grad_averaging"] else 1.0
            if group["bias_correction"]:
                bc1 = 1.0 - beta1 ** group["step"]
                bc2 = 1.0 - beta2 ** group["step"]
            else:
                bc1 = bc2 = 1.0
            for p in plist:
                st = self.state[p]
                gf = p.grad.float() * clip
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(beta1).add_(beta3 * gf)
                v.mul_(beta2).addcmul_(gf, gf, value=1 - beta2)
                pf = p.float()
                u = (m / bc1) / (torch.sqrt(v / bc2) + group["eps"]) \
                    + group["weight_decay"] * pf
                pn = torch.sqrt(torch.sum(pf * pf))
                un = torch.sqrt(torch.sum(u * u))
                ratio = torch.where((pn > 0) & (un > 0), pn / un, one)
                p.copy_(pf - group["lr"] * ratio * u)
        return loss
