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
for ``FusedAdam`` and ``FusedLAMB``.  Under amp's deferred scale update the
step keeps its old values where the scaler's device flag is set, its step
counts on the device (``base.deferred_update``), and seeds a new norm at
the parameter's first step that the device keeps.
"""
from __future__ import annotations

import torch

from .. import ops
from .base import (bias_correction, deferred_update, group_buckets,
                   sqrt_bias_correction, take_deferred_scaler)


class FusedNovoGrad(torch.optim.Optimizer):
    """NovoGrad: per-tensor second-moment norms, Adam-style first moments
    (``reg_inside_moment=True`` puts the weight decay inside the moment)."""

    #: amp's deferred scale update may run in this optimizer's step
    _step_cache_scaler_ok = True

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
        scaler = take_deferred_scaler(self)

        def update(flag, step_of, bc_of):
            skip = None if bc_of is None else flag.reshape(()) > 0
            for gi, plist in buckets:
                group = self.param_groups[gi]
                grads = [p.grad for p in plist]
                seed = []
                for p in plist:
                    state = self.state[p]
                    if len(state) == 0:
                        state["exp_avg"] = torch.zeros_like(p)
                        if skip is None:
                            state["exp_avg_sq"] = self._init_norm(p, group)
                        else:
                            # seeded by the first step the device keeps
                            state["exp_avg_sq"] = torch.zeros(
                                (), dtype=torch.float32, device=p.device)
                            if not group["init_zero"]:
                                state["norm_seeded"] = torch.zeros(
                                    (), dtype=torch.bool, device=p.device)
                    seed.append(state.get("norm_seeded"))
                ms = [self.state[p]["exp_avg"] for p in plist]
                ns = [self.state[p]["exp_avg_sq"] for p in plist]
                ns_in = ns
                if skip is not None and any(x is not None for x in seed):
                    own = ops.multi_tensor.novograd_norms(grads,
                                                          group["norm_type"])
                    ns_in = [n if sd is None else torch.where(sd, n, o)
                             for n, o, sd in zip(ns, own, seed)]
                beta1, beta2 = group["betas"]
                bcs = None if bc_of is None or not group["bias_correction"] \
                    else (bc_of(bias_correction, beta1, group),
                          bc_of(sqrt_bias_correction, beta2, group))
                _, new_ps, new_ms, new_ns = ops.multi_tensor_novograd(
                    flag, [grads, plist, ms, ns_in], group["lr"], beta1,
                    beta2, group["eps"], step_of(group),
                    bool(group["bias_correction"]), group["weight_decay"],
                    1 if group["grad_averaging"] else 0, self.moment_mode,
                    group["norm_type"], bias_corrections=bcs)
                olds, news = plist + ms + ns, new_ps + new_ms + new_ns
                if skip is not None:
                    # the deferred mode's skip, on the device
                    news = [torch.where(skip, o, n) for o, n in zip(olds,
                                                                    news)]
                    for sd in seed:
                        if sd is not None:
                            sd.logical_or_(~skip)
                torch._foreach_copy_(olds, news)

        if scaler is not None:
            deferred_update(self, scaler, update)
            return loss
        for group in self.param_groups:
            group["step"] = group.get("step", 0) + 1
        update(self._overflow_buf, lambda g: g["step"], None)
        return loss
