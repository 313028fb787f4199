"""The contrib FP16_Optimizer, the cut-down master-weight wrapper, the
PyTorch counterpart of ``apex_tpu/contrib/optimizers/fp16_optimizer.py``
(the reference's ``apex/contrib/optimizers/fp16_optimizer.py``).

Built for the contrib fused optimizers: every parameter of the inner
optimizer's groups gets an fp32 master that takes its place there, and
``step`` drives the legacy ``step(grads=, output_params=, scale=,
grad_norms=)`` surface, so the inner optimizer unscales, updates the
masters and writes the half model weights in one pass (the
``fp16_utils`` wrapper instead copies gradients and weights around the
step).  The loss scaler is ``fp16_utils``' host-side one: the overflow
check is one host read a step; on an overflow the scale halves first and
the step is skipped, otherwise the scale may grow after the step, so the
unscale uses the scale the backward applied.  The per-group norms of the
still-scaled gradients travel to the inner optimizer as device scalars,
for its ``max_grad_norm`` clip.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ...fp16_utils.loss_scaler import DynamicLossScaler, LossScaler


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=True):
        self.optimizer = init_optimizer
        self.verbose = verbose
        self.fp16_groups = []   # the model's (half) params
        self.fp32_groups = []   # their fp32 masters
        for group in self.optimizer.param_groups:
            fp16, fp32 = [], []
            for p in group["params"]:
                fp16.append(p)
                fp32.append(nn.Parameter(p.detach().float().clone()))
            self.fp16_groups.append(fp16)
            self.fp32_groups.append(fp32)
            group["params"] = fp32

        if dynamic_loss_scale:
            self.dynamic_loss_scale = True
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.dynamic_loss_scale = False
            self.loss_scaler = LossScaler(static_loss_scale)
        self.overflow = False

    def zero_grad(self, set_grads_to_None=True):
        for group in self.fp16_groups:
            for p in group:
                if set_grads_to_None:
                    p.grad = None
                elif p.grad is not None:
                    p.grad.detach_()
                    p.grad.zero_()

    def backward(self, loss, update_master_grads=True):
        """The scaled backward; the gradients land on the half model
        params."""
        self.loss_scaler.backward(loss)

    def step(self, closure=None):
        if closure is not None:
            raise RuntimeError(
                "contrib FP16_Optimizer does not support closures")
        model_params = [p for g in self.fp16_groups for p in g]
        grads = [[p.grad for p in g] for g in self.fp16_groups]
        self.overflow = bool(self.loss_scaler.has_overflow(model_params))
        if self.overflow:
            # the scale halves first and the step is skipped
            self.loss_scaler.update_scale(True)
            if self.verbose:
                print(f"OVERFLOW! Skipping step. Reducing loss scale to "
                      f"{self.loss_scaler.loss_scale}")
            return
        grad_norms = [
            torch.sqrt(torch.stack([g.float().square().sum() for g in gg
                                    if g is not None]).sum())
            if any(g is not None for g in gg) else None
            for gg in grads]
        self.optimizer.step(grads=grads, output_params=self.fp16_groups,
                            scale=self.loss_scaler.loss_scale,
                            grad_norms=grad_norms)
        # growth after the step: the unscale used the backward's scale
        self.loss_scaler.update_scale(False)

    @property
    def loss_scale(self):
        return self.loss_scaler.loss_scale

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def state_dict(self):
        # a snapshot of the scaler, not the live object
        return {
            "loss_scaler": copy.deepcopy(self.loss_scaler),
            "dynamic_loss_scale": self.dynamic_loss_scale,
            "overflow": self.overflow,
            "optimizer_state_dict": self.optimizer.state_dict(),
            "fp32_groups": [[p.detach().clone() for p in g]
                            for g in self.fp32_groups],
        }

    def load_state_dict(self, state_dict):
        # a copy of the checkpoint's scaler, not the object itself
        self.loss_scaler = copy.deepcopy(state_dict["loss_scaler"])
        self.dynamic_loss_scale = state_dict["dynamic_loss_scale"]
        self.overflow = state_dict["overflow"]
        self.optimizer.load_state_dict(state_dict["optimizer_state_dict"])
        with torch.no_grad():
            for group, saved in zip(self.fp32_groups,
                                    state_dict["fp32_groups"]):
                for p, d in zip(group, saved):
                    p.copy_(d)
            for m_group, f_group in zip(self.fp16_groups, self.fp32_groups):
                for m, f in zip(m_group, f_group):
                    m.copy_(f)
