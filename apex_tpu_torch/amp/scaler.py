"""Loss scaling, the PyTorch counterpart of ``apex_tpu/amp/scaler.py``.

Two layers, as there:

* a functional core (``ScalerState``, ``init_scaler_state``,
  ``update_scale_state``) whose state is device tensors, so a train step's
  unscale, overflow check, skip and scale update make no host round trip;
* a stateful ``LossScaler`` with the reference's API and dynamics: the
  dynamic scale starts at ``min(max_loss_scale, 2**16)``, halves on an
  overflow (clamped to ``min_loss_scale``) and doubles after
  ``scale_window`` clean steps (clamped to ``max_loss_scale``).

``amp.initialize`` and ``scale_loss`` come with a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.dispatch import resolve_device
from ..ops import multi_tensor_scale

_f32, _i32 = torch.float32, torch.int32


class ScalerState(NamedTuple):
    """On-device dynamic-loss-scale state."""
    loss_scale: torch.Tensor   # f32 scalar
    unskipped: torch.Tensor    # i32 scalar: clean steps since the last change
    overflow: torch.Tensor     # i32 scalar: this step's noop flag


def init_scaler_state(loss_scale, init_scale=2.0 ** 16,
                      max_loss_scale=2.0 ** 24, device=None) -> ScalerState:
    scale = (min(max_loss_scale, init_scale) if loss_scale == "dynamic"
             else float(loss_scale))
    device = resolve_device(device)
    return ScalerState(torch.tensor(scale, dtype=_f32, device=device),
                       torch.zeros((), dtype=_i32, device=device),
                       torch.zeros((), dtype=_i32, device=device))


def update_scale_state(state: ScalerState, *, dynamic: bool,
                       scale_factor: float = 2.0,
                       scale_window: int = 2000,
                       min_loss_scale: Optional[float] = None,
                       max_loss_scale: float = 2.0 ** 24):
    """The scale update after one step, on the device.  Returns
    ``(new_state, should_skip)``, ``should_skip`` a device bool."""
    overflow = state.overflow > 0
    zero = torch.zeros_like(state.overflow)
    if not dynamic:
        # a static scale never skips and never changes
        return (ScalerState(state.loss_scale, state.unskipped + 1, zero),
                torch.zeros_like(overflow))
    halved = state.loss_scale / scale_factor
    if min_loss_scale is not None:
        halved = torch.clamp(halved, min=float(min_loss_scale))
    scale = torch.where(overflow, halved, state.loss_scale)
    unskipped = torch.where(overflow, zero, state.unskipped + 1)
    grow = unskipped == scale_window
    scale = torch.where(
        grow, torch.clamp(scale * scale_factor, max=float(max_loss_scale)),
        scale)
    unskipped = torch.where(grow, zero, unskipped)
    return ScalerState(scale, unskipped, zero), overflow


class LossScaler:
    """Stateful facade with the reference's API.  Holds a ``ScalerState``
    of device tensors; ``loss_scale()`` and ``update_scale()`` read it back
    to the host (one sync each), as the reference does."""

    def __init__(self, loss_scale, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_loss_scale=None,
                 max_loss_scale=2.0 ** 24, device=None):
        self.dynamic = loss_scale == "dynamic"
        #: known-without-sync scale for static scalers (None when dynamic)
        self.static_scale = None if self.dynamic else float(loss_scale)
        self._state = init_scaler_state(loss_scale, init_scale,
                                        max_loss_scale, device)
        self._max_loss_scale = max_loss_scale
        self._min_loss_scale = min_loss_scale
        self._scale_seq_len = scale_window
        self._scale_factor = scale_factor

    @property
    def state(self) -> ScalerState:
        return self._state

    @state.setter
    def state(self, s: ScalerState):
        self._state = s

    def loss_scale(self):
        return float(self._state.loss_scale)

    @property
    def device_scale(self):
        """The loss scale as a device scalar (no host sync)."""
        return self._state.loss_scale

    def clear_overflow_state(self):
        self._state = self._state._replace(
            overflow=torch.zeros_like(self._state.overflow))

    def unscale(self, model_grads, master_grads, unused_scale=None,
                models_are_masters=False, scale_override=None):
        """``master = model / scale`` in fp32, cast to each master's dtype,
        flagging non-finite gradients into the state.  Returns the new
        master gradients (functional: callers rebind)."""
        scale = (self._state.loss_scale if scale_override is None
                 else torch.as_tensor(scale_override, dtype=_f32,
                                      device=self._state.loss_scale.device))
        flag, masters = multi_tensor_scale(
            self._state.overflow, [list(model_grads), list(master_grads)],
            1.0 / scale)
        self._state = self._state._replace(overflow=flag)
        return masters

    def unscale_with_stashed(self, model_grads, stashed_master_grads,
                             master_grads, scale_override=None):
        raise NotImplementedError(
            "LossScaler.unscale_with_stashed needs multi_tensor_axpby, "
            "which is ported with slice 3 (amp.scale_loss)")

    def update_scale(self):
        """One host sync, as in the reference: returns a Python bool
        ``should_skip``."""
        new_state, should_skip = update_scale_state(
            self._state, dynamic=self.dynamic,
            scale_factor=self._scale_factor,
            scale_window=self._scale_seq_len,
            min_loss_scale=self._min_loss_scale,
            max_loss_scale=self._max_loss_scale)
        skip = bool(should_skip)
        self._state = new_state
        return skip
