"""LoRA (low-rank adaptation), the PyTorch counterpart of
``apex_tpu/reparameterization/lora.py``: ``w = w0 + (alpha / r) B A`` with
``w0`` frozen and only the rank-r factors trained.

Built on the computed-on-read machinery of
:mod:`.reparameterization`, so every reader of the attribute (the fused
train step, the eager loop, ``generate``) sees the adapted weight without
a change to the model's code.  ``remove`` is the LoRA merge: it bakes
``w0 + (alpha / r) B A`` into a plain parameter.  The value is computed in
fp32 and cast to ``w0``'s dtype.  A starts as 0.02 N(0, 1), drawn on the
CPU from a ``torch.Generator`` (``apply_lora``'s, else one seeded from the
global CPU generator) and moved to the weight's device, so the card and
the CPU draw the same factors; B starts at zero, so the adapted model
starts at the base model.  Train by giving the optimizer only
:func:`lora_parameters`: parameters in no group stay frozen.  The fused
step still differentiates every parameter (the frozen ones feed only the
overflow check), as the JAX step does.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .reparameterization import Reparameterization


class LoRA(Reparameterization):
    """``dim`` carries the rank r; ``alpha`` (class attribute, default
    ``2 r``) and ``generator`` are set by :func:`apply_lora`."""

    alpha = None
    generator = None

    def __init__(self, name, dim, module, retain_forward=True):
        if dim is None or dim < 1:
            raise ValueError(f"LoRA rank must be a positive int, "
                             f"got {dim!r}")
        super().__init__(name, dim, module, retain_forward)
        self.r = dim
        self.scale = (self.alpha if self.alpha is not None
                      else 2.0 * dim) / dim

    def compute_weight(self, module=None, name=None):
        if module is None:
            module = self.module
        if name is None:
            name = self.name
        module, name = Reparameterization.get_module_and_name(module, name)
        w0 = getattr(module, name + "_w0")
        b = getattr(module, name + "_lora_b")
        a = getattr(module, name + "_lora_a")
        delta = self.scale * torch.matmul(b.float(), a.float())
        return (w0.float() + delta.reshape(w0.shape)).to(w0.dtype)

    def reparameterize(self, name, weight, dim):
        out_f = weight.shape[0]
        in_f = math.prod(weight.shape[1:])
        if dim > min(out_f, in_f):
            raise ValueError(
                f"LoRA rank {dim} exceeds min(out, in) = "
                f"{min(out_f, in_f)} of '{name}' {tuple(weight.shape)}")
        gen = self.generator
        if gen is None:
            gen = torch.Generator().manual_seed(
                int(torch.randint(0, 2 ** 62, ())))
        w0 = nn.Parameter(weight.detach(), requires_grad=False)
        a = nn.Parameter((0.02 * torch.randn((dim, in_f), generator=gen,
                                             dtype=torch.float32))
                         .to(weight.device))
        b = nn.Parameter(torch.zeros((out_f, dim), dtype=torch.float32,
                                     device=weight.device))
        return ([name + "_w0", name + "_lora_b", name + "_lora_a"],
                [w0, b, a])


def apply_lora(module, name="", r=8, alpha=None, hook_child=True,
               generator=None):
    """Adapt ``name`` (or, with no name, every >1-d parameter that the
    rank fits) with a rank-``r`` LoRA scaled by ``alpha / r`` (default
    ``2 r``); ``generator`` (a CPU ``torch.Generator``) draws the A
    factors.  Returns the module.  A fine-tune::

        apply_lora(model, "blocks.0.q_proj.weight", r=8)
        opt = FusedAdam(lora_parameters(model), lr=1e-4)
        step = make_train_step(model, opt, loss_fn)       # w0 frozen

    Merge for inference with ``remove_reparameterization(model, LoRA,
    remove_all=True)`` (or one name)."""
    from . import apply_reparameterization

    attrs = {}
    if alpha is not None:
        attrs["alpha"] = float(alpha)
    if generator is not None:
        attrs["generator"] = generator
    cls = type("LoRA", (LoRA,), attrs) if attrs else LoRA
    return apply_reparameterization(
        module, reparameterization=cls, name=name, dim=r,
        hook_child=hook_child)


def lora_parameters(module):
    """The trainable factors (``*_lora_a`` and ``*_lora_b``): the list to
    give the optimizer."""
    return [p for n, p in module.named_parameters()
            if n.endswith("_lora_a") or n.endswith("_lora_b")]
