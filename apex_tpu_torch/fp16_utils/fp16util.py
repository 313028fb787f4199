"""Manual mixed-precision helpers, the PyTorch counterpart of
``apex_tpu/fp16_utils/fp16util.py``.

``network_to_half`` casts a network's parameters and buffers to the half
dtype and keeps BatchNorm's in fp32; ``convert_network`` does the same for
any dtype; ``prep_param_lists`` makes fp32 master copies of the model's
parameters, optionally flattened into one tensor; the copy helpers move
gradients to the masters and values back.  "Half" defaults to bfloat16,
as in the JAX package (float16 is one argument away).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

_BN = nn.modules.batchnorm._BatchNorm


def tofp16(network: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast the whole network to ``dtype``."""
    return network.to(dtype)


def BN_convert_float(module: nn.Module) -> nn.Module:
    """Cast every BatchNorm module back to fp32."""
    for m in module.modules():
        if isinstance(m, _BN):
            m.float()
    return module


def network_to_half(network: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """The network in ``dtype`` with its BatchNorm in fp32."""
    return BN_convert_float(tofp16(network, dtype))


class FP16Model(nn.Module):
    """A network converted to ``dtype`` (BatchNorm kept fp32) whose
    floating inputs are cast to ``dtype`` at each call."""

    def __init__(self, network: nn.Module, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.network = convert_network(network, dtype)

    def forward(self, *inputs):
        return self.network(*(
            x.to(self.dtype) if isinstance(x, torch.Tensor)
            and x.is_floating_point() else x for x in inputs))


def convert_module(module: nn.Module, dtype) -> nn.Module:
    """Cast one module's own floating parameters and buffers to ``dtype``,
    unless it is a BatchNorm."""
    if isinstance(module, _BN):
        return module
    for t in list(module.parameters(recurse=False)) \
            + list(module.buffers(recurse=False)):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return module


def convert_network(network: nn.Module, dtype) -> nn.Module:
    """Cast every module but BatchNorm to ``dtype``."""
    for m in network.modules():
        convert_module(m, dtype)
    return network


def prep_param_lists(model: nn.Module, flat_master: bool = False
                     ) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """``(model_params, master_params)``: the parameters that take a
    gradient and an fp32 copy of each, or with ``flat_master`` one fp32
    parameter holding them all, flattened in order."""
    model_params = [p for p in model.parameters() if p.requires_grad]
    with torch.no_grad():
        if flat_master:
            flat = torch.cat([p.reshape(-1).float() for p in model_params])
            return model_params, [nn.Parameter(flat)]
        return model_params, [nn.Parameter(p.float().clone())
                              for p in model_params]


def model_grads_to_master_grads(model_params, master_params,
                                flat_master: bool = False):
    """Copy the model's gradients into the masters' in fp32 (a missing
    gradient is zeros in the flat master, None otherwise)."""
    if flat_master:
        master_params[0].grad = torch.cat([
            p.grad.reshape(-1).float() if p.grad is not None
            else torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
            for p in model_params])
        return
    for model, master in zip(model_params, master_params):
        master.grad = None if model.grad is None else model.grad.float()


def master_params_to_model_params(model_params, master_params,
                                  flat_master: bool = False):
    """Copy the masters' values back into the model, in its dtypes."""
    with torch.no_grad():
        if flat_master:
            offset = 0
            flat = master_params[0]
            for p in model_params:
                n = p.numel()
                p.copy_(flat[offset:offset + n].view_as(p))
                offset += n
            return
        for model, master in zip(model_params, master_params):
            model.copy_(master)


def to_python_float(t) -> float:
    if hasattr(t, "item"):
        return float(t.item())
    return float(t)


def clip_grad_norm(parameters, max_norm: float, norm_type: float = 2.0):
    """Scale the gradients of ``parameters`` so that their total norm is at
    most ``max_norm``; returns the norm before clipping as a float."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return 0.0
    if norm_type == float("inf"):
        total = max(float(p.grad.abs().max()) for p in params)
    else:
        total = float(sum(p.grad.float().abs().pow(norm_type).sum()
                          for p in params)) ** (1.0 / norm_type)
    clip_coef = max_norm / (total + 1e-6)
    if clip_coef < 1.0:
        for p in params:
            p.grad = (p.grad.float() * clip_coef).to(p.grad.dtype)
    return total
