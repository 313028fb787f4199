"""LARC, layer-wise adaptive rate control around an optimizer, the PyTorch
counterpart of ``apex_tpu/parallel/LARC.py`` (reference
``apex/parallel/LARC.py:5-107``).

For each parameter, a trust ratio ``tc * ||p|| / (||g|| + wd * ||p|| +
eps)`` (in ``clip`` mode capped so the effective lr is ``min(adaptive_lr,
lr)``) scales the gradient, with the weight decay folded in, in place; the
wrapped optimizer then steps with its weight decay set to 0.  A parameter
whose norm or gradient norm is 0 keeps its gradient.  The norms come from
``ops.multi_tensor_l2norm(per_tensor=True)``, on the device.
"""
from __future__ import annotations

import torch

from .. import ops


class LARC:
    def __init__(self, optimizer, trust_coefficient=0.02, clip=True,
                 eps=1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.eps = eps
        self.clip = clip

    def __getstate__(self):
        return self.optim.__getstate__()

    def __setstate__(self, state):
        self.optim.__setstate__(state)

    @property
    def state(self):
        return self.optim.state

    def __repr__(self):
        return self.optim.__repr__()

    @property
    def param_groups(self):
        return self.optim.param_groups

    @param_groups.setter
    def param_groups(self, value):
        self.optim.param_groups = value

    def state_dict(self):
        return self.optim.state_dict()

    def load_state_dict(self, state_dict):
        self.optim.load_state_dict(state_dict)

    def zero_grad(self, *args, **kwargs):
        self.optim.zero_grad(*args, **kwargs)

    def add_param_group(self, param_group):
        self.optim.add_param_group(param_group)

    @torch.no_grad()
    def step(self):
        weight_decays = []
        for group in self.optim.param_groups:
            weight_decay = group.get("weight_decay", 0)
            weight_decays.append(weight_decay)
            group["weight_decay"] = 0
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            flag = ops.zero_flag(params[0].device)
            _, _, p_norms = ops.multi_tensor_l2norm(
                flag, [[p.detach() for p in params]], per_tensor=True)
            _, _, g_norms = ops.multi_tensor_l2norm(
                flag, [[p.grad for p in params]], per_tensor=True)
            for p, param_norm, grad_norm in zip(params, p_norms, g_norms):
                adaptive_lr = self.trust_coefficient * param_norm / (
                    grad_norm + param_norm * weight_decay + self.eps)
                if self.clip:
                    adaptive_lr = torch.clamp(adaptive_lr / group["lr"],
                                              max=1.0)
                active = (param_norm != 0) & (grad_norm != 0)
                adaptive_lr = torch.where(active, adaptive_lr, 1.0)
                wd_term = torch.where(active, weight_decay, 0.0)
                new_grad = (p.grad.float() + wd_term * p.float()) \
                    * adaptive_lr
                p.grad.copy_(new_grad.to(p.grad.dtype))

        self.optim.step()
        for i, group in enumerate(self.optim.param_groups):
            group["weight_decay"] = weight_decays[i]
