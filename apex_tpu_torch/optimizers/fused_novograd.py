"""FusedNovoGrad, the PyTorch counterpart of
``apex_tpu/optimizers/fused_novograd.py`` (and of the reference's
``apex/optimizers/fused_novograd.py``).

A ``torch.optim.Optimizer`` whose ``step()`` runs
:func:`apex_tpu_torch.ops.multi_tensor_novograd` per (param group x dtype)
bucket and copies the new values into the params, moments and norms in
place.  NovoGrad is jnp in the JAX package, so it is plain PyTorch here.
The state keeps the JAX package's layout: ``exp_avg`` in each parameter's
dtype and ``exp_avg_sq``, one fp32 running-norm scalar per parameter (the
reference keeps two flat per-group tensors instead).  On a parameter's
first step the norm is seeded with its gradient's norm (L2 or max), so the
first blend leaves it there, or with zero under ``init_zero``.  The step
count is a Python int per group, so the bias corrections are computed on
the host.  Under amp with master weights the step updates the fp32
masters and amp's patched step copies them into the half model params, as
for ``FusedAdam`` and ``FusedLAMB``.
"""
from __future__ import annotations

import torch

from .. import ops
from .base import group_buckets


class FusedNovoGrad(torch.optim.Optimizer):
    """NovoGrad: per-tensor second-moment norms, Adam-style first moments
    (``reg_inside_moment=True`` puts the weight decay inside the moment)."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.95, 0.98), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False, grad_averaging=True,
                 norm_type=2, init_zero=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging, norm_type=norm_type,
                        init_zero=init_zero)
        super().__init__(params, defaults)
        # moment mode 0 applies the weight decay inside the moment update
        self.moment_mode = 0 if reg_inside_moment else 1
        self.set_grad_none = set_grad_none
        first = next(p for g in self.param_groups for p in g["params"])
        self._overflow_buf = ops.zero_flag(first.device)

    def zero_grad(self, set_to_none: bool = None):
        if set_to_none is None:
            set_to_none = self.set_grad_none
        super().zero_grad(set_to_none=set_to_none)

    def _init_norm(self, p, group):
        """The first step's running norm: the gradient's own, so the first
        blend is a no-op, or zero under ``init_zero``."""
        if group["init_zero"]:
            return torch.zeros((), dtype=torch.float32, device=p.device)
        return ops.multi_tensor.novograd_norms([p.grad],
                                               group["norm_type"])[0]

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
                    state["exp_avg_sq"] = self._init_norm(p, group)
            ms = [self.state[p]["exp_avg"] for p in plist]
            ns = [self.state[p]["exp_avg_sq"] for p in plist]
            beta1, beta2 = group["betas"]
            _, new_ps, new_ms, new_ns = ops.multi_tensor_novograd(
                flag, [[p.grad for p in plist], plist, ms, ns], group["lr"],
                beta1, beta2, group["eps"], group["step"],
                bool(group["bias_correction"]), group["weight_decay"],
                1 if group["grad_averaging"] else 0, self.moment_mode,
                group["norm_type"])
            torch._foreach_copy_(plist + ms + ns, new_ps + new_ms + new_ns)
        return loss
