"""The legacy loss scalers, the PyTorch counterpart of
``apex_tpu/fp16_utils/loss_scaler.py``: host-side and driven once an
iteration (``has_overflow(params)``, ``update_scale(overflow)``).

``LossScaler`` is static.  ``DynamicLossScaler`` starts at 2**32, halves
on an overflow (never below 1) and doubles after ``scale_window=1000``
iterations without one; amp's scaler instead starts at 2**16 with a window
of 2000.
"""
from __future__ import annotations

import torch


def _params_have_overflow(params) -> bool:
    """True when a gradient of ``params`` holds an inf or a NaN (one host
    read for all of them)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return False
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    return not bool(finite)


class LossScaler:
    """A static loss scale."""

    def __init__(self, scale=1.0):
        self.cur_scale = float(scale)

    def has_overflow(self, params):
        return False

    @staticmethod
    def _has_inf_or_nan(x):
        return False

    def update_scale(self, overflow):
        pass

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, module, grad_in, grad_out):
        return tuple(self.loss_scale * g for g in grad_in)

    def backward(self, loss, retain_graph=False):
        scaled_loss = loss * self.loss_scale
        scaled_loss.backward(retain_graph=retain_graph)


class DynamicLossScaler:
    """A loss scale that halves on an overflow and doubles after
    ``scale_window`` clean iterations."""

    def __init__(self, init_scale=2 ** 32, scale_factor=2.0,
                 scale_window=1000):
        self.cur_scale = float(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def has_overflow(self, params):
        return _params_have_overflow(params)

    @staticmethod
    def _has_inf_or_nan(x):
        return not bool(torch.isfinite(torch.as_tensor(x).float()).all())

    def update_scale(self, overflow):
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) \
                % self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, module, grad_in, grad_out):
        return tuple(self.loss_scale * g for g in grad_in)

    def backward(self, loss, retain_graph=False):
        scaled_loss = loss * self.loss_scale
        scaled_loss.backward(retain_graph=retain_graph)
