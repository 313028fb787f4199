"""WeightNorm, ``w = g * v / |v|``, the PyTorch counterpart of
``apex_tpu/reparameterization/weight_norm.py`` (the reference's
``apex/reparameterization/weight_norm.py``, whose fused CUDA kernel the
JAX package computes as a few elementwise and reduction ops, as the port
does)."""
from __future__ import annotations

import torch
from torch import nn

from .reparameterization import Reparameterization


def _norm(p, dim):
    """The norm over every dimension but ``dim``, dims kept; over the
    whole tensor for ``dim=None``."""
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(p)))
    axes = tuple(i for i in range(p.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(p), dim=axes, keepdim=True))


class WeightNorm(Reparameterization):
    """Splits a weight into its magnitude ``g`` and direction ``v``; the
    attribute is ``g * v / |v|``, computed in fp32 and cast to ``v``'s
    dtype on every read.  ``dim=0`` takes a norm per output channel,
    ``dim=None`` one over the whole tensor."""

    def compute_weight(self, module=None, name=None):
        if module is None:
            module = self.module
        if name is None:
            name = self.name
        module, name = Reparameterization.get_module_and_name(module, name)
        g = getattr(module, name + "_g")
        v = getattr(module, name + "_v")
        vf = v.float()
        return (g.float() * (vf / _norm(vf, self.dim))).to(v.dtype)

    def reparameterize(self, name, weight, dim):
        w = weight.detach()
        return [name + "_g", name + "_v"], [nn.Parameter(_norm(w, dim)),
                                            nn.Parameter(w.clone())]
