"""The legacy optimizer wrapper, the PyTorch counterpart of
``apex_tpu/amp/opt.py``.

``handle = amp.init(); optimizer = handle.wrap_optimizer(opt, num_loss=N)``
gives each of N losses its own loss scaler: ``with
optimizer.scale_loss(loss) as scaled: scaled.backward()`` for each loss,
then one ``optimizer.step()``, skipped when any loss overflowed.  The
gradients accumulated before a second loss's backward are set aside and
added back after its unscale, so that each loss is unscaled by its own
scale.
"""
from __future__ import annotations

import contextlib

from ._amp_state import master_params, maybe_print
from .scaler import LossScaler


class OptimWrapper:
    def __init__(self, optimizer, amp_handle, num_loss, loss_scale="dynamic"):
        self._optimizer = optimizer
        self._amp_handle = amp_handle
        self._num_loss = num_loss
        self._loss_idx = 0
        self._skip_next = [False] * num_loss
        # each loss's scaler honours the handle's loss_scale, as the JAX
        # package's do, on the optimizer's device
        first = next(master_params(optimizer), None)
        dev = None if first is None else first.device
        self._loss_scaler = [LossScaler(loss_scale, device=dev)
                             for _ in range(num_loss)]

    @contextlib.contextmanager
    def scale_loss(self, loss):
        if not self._amp_handle.is_active():
            yield loss
            return

        # the gradients so far are set aside: once this loss's gradients
        # are added to them it can no longer be unscaled on its own
        cached_grads = []
        if self._loss_idx > 0:
            for p in master_params(self._optimizer):
                cached_grads.append(p.grad)
                p.grad = None

        scaler = self._cur_loss_scaler()
        loss_scale = scaler.loss_scale()
        yield loss.float() * loss_scale

        scaler.clear_overflow_state()
        params = list(master_params(self._optimizer))
        live = [p for p in params if p.grad is not None]
        if live:
            grads = [p.grad for p in live]
            for p, g in zip(live, scaler.unscale(grads, grads, loss_scale,
                                                 models_are_masters=True)):
                p.grad = g
        self._skip_next[self._loss_idx] = scaler.update_scale()
        self._loss_idx += 1

        for p, cached in zip(params, cached_grads):
            if cached is not None:
                p.grad = cached if p.grad is None else p.grad + cached

    def _cur_loss_scaler(self):
        assert 0 <= self._loss_idx < self._num_loss
        return self._loss_scaler[self._loss_idx]

    def step(self, closure=None):
        if not self._amp_handle.is_active():
            return self._optimizer.step(closure=closure)

        self._loss_idx = 0
        for group in self._optimizer.param_groups:
            for p in group["params"]:
                self._amp_handle.remove_cache(p)

        if closure is not None:
            raise NotImplementedError(
                "The `closure` argument is unsupported by the amp "
                "optimizer wrapper.")
        if any(self._skip_next):
            maybe_print("Gradient overflow, skipping update")
            self._skip_next = [False] * self._num_loss
        else:
            return self._optimizer.step()

    # everything else is the wrapped optimizer's
    def __getattr__(self, attr):
        return getattr(self._optimizer, attr)

    def __repr__(self):
        return self._optimizer.__repr__()

    def state_dict(self):
        return self._optimizer.state_dict()

    def load_state_dict(self, state_dict):
        return self._optimizer.load_state_dict(state_dict)

    def zero_grad(self):
        return self._optimizer.zero_grad()

    def add_param_group(self, param_group):
        return self._optimizer.add_param_group(param_group)
