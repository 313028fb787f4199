"""``FP16_Optimizer``, the legacy master-weight wrapper, the PyTorch
counterpart of ``apex_tpu/fp16_utils/fp16_optimizer.py``.

It wraps any of the port's optimizers: each half parameter gets an fp32
master that takes its place in the inner optimizer's ``param_groups``;
``backward(loss)`` scales the loss and backpropagates, and
``update_master_grads`` checks the model gradients for an overflow
(dynamic scale) and unscales them into the masters; ``step`` skips on an
overflow, else steps the masters and copies them back into the model.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from .fp16util import (clip_grad_norm, master_params_to_model_params,
                       model_grads_to_master_grads)
from .loss_scaler import DynamicLossScaler, LossScaler

_HALF = (torch.float16, torch.bfloat16)


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=True):
        self.optimizer = init_optimizer
        self.verbose = verbose
        self.fp16_groups: List[List[nn.Parameter]] = []
        self.fp32_from_fp16_groups: List[List[nn.Parameter]] = []
        self.fp32_from_fp32_groups: List[List[nn.Parameter]] = []
        for group in self.optimizer.param_groups:
            fp16, fp32_from_fp16, fp32, new_params = [], [], [], []
            for p in group["params"]:
                if p.dtype in _HALF:
                    master = nn.Parameter(p.detach().float().clone())
                    fp16.append(p)
                    fp32_from_fp16.append(master)
                    new_params.append(master)
                    if p in self.optimizer.state:
                        self.optimizer.state[master] = \
                            self.optimizer.state.pop(p)
                else:
                    fp32.append(p)
                    new_params.append(p)
            group["params"] = new_params
            self.fp16_groups.append(fp16)
            self.fp32_from_fp16_groups.append(fp32_from_fp16)
            self.fp32_from_fp32_groups.append(fp32)

        self.dynamic_loss_scale = bool(dynamic_loss_scale)
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.overflow = False
        self.first_closure_call_this_step = True

    def maybe_print(self, msg):
        if self.verbose:
            print(msg)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_grads_to_None=False):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        params += [p for g in self.fp16_groups for p in g]
        for p in params:
            if set_grads_to_None:
                p.grad = None
            elif p.grad is not None:
                p.grad = torch.zeros_like(p.grad)

    def backward(self, loss, update_master_grads=True, retain_graph=False):
        (loss * float(self.loss_scaler.loss_scale)).backward(
            retain_graph=retain_graph)
        if update_master_grads:
            self.update_master_grads()

    def update_master_grads(self):
        """Check the model's gradients (the fp32 ones too) for an overflow,
        update the scale, and unless it overflowed unscale them into the
        masters."""
        self.overflow = self.loss_scaler.has_overflow(
            [p for g in self.fp16_groups for p in g]
            + [p for g in self.fp32_from_fp32_groups for p in g])
        self.loss_scaler.update_scale(self.overflow)
        if self.overflow:
            return
        inv = 1.0 / float(self.loss_scaler.loss_scale)
        for fp16_group, master_group in zip(self.fp16_groups,
                                            self.fp32_from_fp16_groups):
            model_grads_to_master_grads(fp16_group, master_group)
            for m in master_group:
                if m.grad is not None:
                    m.grad = m.grad * inv
        if inv != 1.0:
            for fp32_group in self.fp32_from_fp32_groups:
                for p in fp32_group:
                    if p.grad is not None:
                        p.grad = p.grad * inv

    def clip_master_grads(self, max_norm, norm_type=2):
        """The masters' gradient norm before clipping, or -1 when this
        iteration overflowed."""
        if self.overflow:
            return -1
        return clip_grad_norm(
            [p for g in self.optimizer.param_groups for p in g["params"]],
            max_norm, norm_type)

    def step(self, closure=None):
        if self.overflow:
            self.maybe_print(
                f"OVERFLOW! Skipping step. Attempted loss scale: "
                f"{self.loss_scaler.loss_scale}")
            return
        if closure is not None:
            raise NotImplementedError(
                "FP16_Optimizer: a closure-based step is not supported")
        self.optimizer.step()
        for fp16_group, master_group in zip(self.fp16_groups,
                                            self.fp32_from_fp16_groups):
            master_params_to_model_params(fp16_group, master_group)

    def state_dict(self):
        return {
            "loss_scaler": self.loss_scaler,
            "dynamic_loss_scale": self.dynamic_loss_scale,
            "overflow": self.overflow,
            "first_closure_call_this_step":
                self.first_closure_call_this_step,
            "optimizer_state_dict": self.optimizer.state_dict(),
            "fp32_from_fp16": [[p.detach().clone() for p in g]
                               for g in self.fp32_from_fp16_groups],
        }

    def load_state_dict(self, state_dict):
        self.loss_scaler = state_dict["loss_scaler"]
        self.dynamic_loss_scale = state_dict["dynamic_loss_scale"]
        self.overflow = state_dict["overflow"]
        self.first_closure_call_this_step = \
            state_dict["first_closure_call_this_step"]
        self.optimizer.load_state_dict(state_dict["optimizer_state_dict"])
        with torch.no_grad():
            for cur, saved in zip(self.fp32_from_fp16_groups,
                                  state_dict["fp32_from_fp16"]):
                for p, data in zip(cur, saved):
                    p.copy_(data)

    def _get_loss_scale(self):
        return self.loss_scaler.loss_scale

    def _set_loss_scale(self, value):
        self.loss_scaler.cur_scale = value

    loss_scale = property(_get_loss_scale, _set_loss_scale)
