"""Loss scaling, the PyTorch counterpart of ``apex_tpu/amp/scaler.py``.

Two layers, as there:

* a functional core (``ScalerState``, ``init_scaler_state``,
  ``update_scale_state``, ``unscale_grads``, ``unscale_with_stashed_grads``)
  whose state is device tensors, so a train step's unscale, overflow
  check, skip and scale update make no host round trip;
* a stateful ``LossScaler`` with the reference's API and dynamics: the
  dynamic scale starts at ``min(max_loss_scale, 2**16)``, halves on an
  overflow (clamped to ``min_loss_scale``) and doubles after
  ``scale_window`` clean steps (clamped to ``max_loss_scale``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.dispatch import resolve_device
from ..ops import multi_tensor_axpby, multi_tensor_scale

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


def unscale_grads(state: ScalerState, model_grads, master_dtypes=None,
                  check_overflow: bool = True, scale_override=None):
    """``master = model / loss_scale`` in fp32, cast to ``master_dtypes``
    (default: each gradient's own), with the overflow flag raised on a
    non-finite gradient.  Returns ``(new_state, master_grads)``."""
    scale = state.loss_scale if scale_override is None \
        else torch.as_tensor(scale_override, dtype=_f32,
                             device=state.loss_scale.device)
    outs = [torch.empty(0, dtype=g.dtype if master_dtypes is None
                        else master_dtypes[i])
            for i, g in enumerate(model_grads)]
    flag, masters = multi_tensor_scale(state.overflow,
                                       [list(model_grads), outs], 1.0 / scale)
    if not check_overflow:
        flag = state.overflow
    return state._replace(overflow=flag), masters


def unscale_with_stashed_grads(state: ScalerState, model_grads,
                               stashed_grads, scale_override=None):
    """Gradient accumulation over backward passes: ``out = (out_scale /
    grads_have_scale) * new + (out_scale / stashed_have_scale) * stashed``
    through ``multi_tensor_axpby``, the flag raised on a non-finite new
    gradient; ``scale_override`` is the triple (grads_have_scale,
    stashed_have_scale, out_scale), by default (loss scale, 1, 1).
    Returns ``(new_state, master_grads)`` in the stashed gradients'
    dtypes."""
    out_scale = 1.0
    if scale_override is not None:
        grads_have_scale, stashed_have_scale, out_scale = scale_override
    else:
        grads_have_scale, stashed_have_scale = state.loss_scale, 1.0
    flag, masters = multi_tensor_axpby(
        state.overflow, [list(model_grads), list(stashed_grads),
                         list(stashed_grads)],
        out_scale / grads_have_scale, out_scale / stashed_have_scale, 0)
    return state._replace(overflow=flag), masters


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

    @property
    def _unskipped(self):
        return int(self._state.unskipped)

    @_unskipped.setter
    def _unskipped(self, v):
        self._state = self._state._replace(unskipped=torch.tensor(
            v, dtype=_i32, device=self._state.unskipped.device))

    @property
    def _loss_scale(self):
        return float(self._state.loss_scale)

    @_loss_scale.setter
    def _loss_scale(self, v):
        self._state = self._state._replace(loss_scale=torch.tensor(
            v, dtype=_f32, device=self._state.loss_scale.device))

    def clear_overflow_state(self):
        self._state = self._state._replace(
            overflow=torch.zeros_like(self._state.overflow))

    def unscale(self, model_grads, master_grads, unused_scale=None,
                models_are_masters=False, scale_override=None):
        """``master = model / scale`` in fp32, cast to each master's dtype
        (``master_grads`` give only the dtypes), flagging non-finite
        gradients into the state.  Returns the new master gradients
        (functional: callers rebind)."""
        self._state, masters = unscale_grads(
            self._state, list(model_grads),
            master_dtypes=[m.dtype for m in master_grads],
            scale_override=scale_override)
        return masters

    def unscale_with_stashed(self, model_grads, stashed_master_grads,
                             master_grads, scale_override=None):
        """``new / scale + stashed`` (see
        :func:`unscale_with_stashed_grads`); returns the new master
        gradients."""
        self._state, masters = unscale_with_stashed_grads(
            self._state, model_grads, stashed_master_grads, scale_override)
        return masters

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
