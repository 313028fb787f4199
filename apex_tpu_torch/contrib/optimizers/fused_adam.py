"""The deprecated-API FusedAdam, the PyTorch counterpart of
``apex_tpu/contrib/optimizers/fused_adam.py`` (the reference's
``apex/contrib/optimizers/fused_adam.py``).

The legacy surface that the modern ``optimizers.FusedAdam`` dropped:
``step`` takes explicit ``grads``, ``output_params``, ``scale`` and
``grad_norms``, divides the gradients by the combined scale (the amp
unscale, times the group's ``max_grad_norm`` clip where the reported norm
exceeds it), and writes a half copy of the new weights into
``output_params`` in the same update.  ``eps_inside_sqrt`` takes
``sqrt(v_hat + eps)`` as the denominator (eps mode 0) instead of
``sqrt(v_hat) + eps``; the weight decay is added to the update after the
moments.  Each parameter carries its own step count and so its own bias
corrections (a parameter that had no gradient for a while does not reset
another's).  The math is fp32 whatever the storage dtype, the moments are
fp32, and the clip is computed on the device from the norm tensors, with
no host read.
"""
from __future__ import annotations

import torch

from ... import ops


def _per_group(x, n_groups):
    """``x`` as one list per param group: None for every group, a flat
    list for a single group, or a list of lists as given."""
    if x is None:
        return [None] * n_groups
    if not isinstance(x[0], (list, tuple)):
        return [list(x)]
    return [list(g) for g in x]


class FusedAdam(torch.optim.Optimizer):
    """Legacy fused Adam with the unscale folded into the update and half
    output copies."""

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0., max_grad_norm=0., amsgrad=False,
                 use_mt=False, amp_scale_adjustment=1.0):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm)
        super().__init__(params, defaults)
        self.eps_mode = 0 if eps_inside_sqrt else 1
        self._amp_scale_adjustment = amp_scale_adjustment
        # recorded for the API; the update is one loop over the tensors
        self._use_multi_tensor = use_mt
        first = next(p for g in self.param_groups for p in g["params"])
        self._overflow_buf = ops.zero_flag(first.device)

    def _combined_scale(self, group, scale, grad_norm, dev):
        """The divisor of the group's gradients: ``scale``, times the clip
        ``(|g| / scale + 1e-6) / max_grad_norm`` where that exceeds 1
        (``grad_norm`` is the norm of the still-scaled gradients)."""
        s = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        if group["max_grad_norm"] <= 0 or grad_norm is None:
            return s
        gnorm = torch.as_tensor(grad_norm, dtype=torch.float32, device=dev)
        clip = (gnorm / s + 1e-6) / group["max_grad_norm"]
        return torch.where(clip > 1, clip * s, s)

    @torch.no_grad()
    def step(self, closure=None, grads=None, output_params=None, scale=1.,
             grad_norms=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()

        n = len(self.param_groups)
        grads_group = _per_group(grads, n)
        output_group = _per_group(output_params, n)
        norms = grad_norms if grad_norms is not None else [None] * n
        for group, g_this, out_this, gnorm in zip(
                self.param_groups, grads_group, output_group, norms):
            params = group["params"]
            if g_this is None:
                g_this = [p.grad for p in params]
            if out_this is None:
                out_this = [None] * len(params)
            live = [(p, g, o) for p, g, o in zip(params, g_this, out_this)
                    if g is not None]
            if not live:
                continue
            dev = live[0][0].device
            div = self._combined_scale(group, scale, gnorm, dev)
            beta1, beta2 = group["betas"]
            eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
            for p, g, o in live:
                st = self.state[p]
                if len(st) == 0:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
                st["step"] += 1
                if group["bias_correction"]:
                    bc1 = 1.0 - beta1 ** st["step"]
                    bc2 = 1.0 - beta2 ** st["step"]
                else:
                    bc1 = bc2 = 1.0
                gf = g.float() / div
                pf = p.float()
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(beta1).add_(gf, alpha=1 - beta1)
                v.mul_(beta2).addcmul_(gf, gf, value=1 - beta2)
                if self.eps_mode == 0:
                    denom = torch.sqrt(v / bc2 + eps)
                else:
                    denom = torch.sqrt(v / bc2) + eps
                pf = pf - lr * ((m / bc1) / denom + wd * pf)
                p.copy_(pf)
                if o is not None:
                    # straight from fp32 to the output's dtype
                    o.copy_(pf)
        return loss
