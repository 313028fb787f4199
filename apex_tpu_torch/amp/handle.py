"""The ``scale_loss`` context manager, the PyTorch counterpart of
``apex_tpu/amp/handle.py``.

Entering runs each optimizer's ``_prepare_amp_backward`` and yields
``loss.float() * loss_scale``; leaving clears the scaler's overflow state,
runs ``_post_amp_backward`` (the half gradients unscaled into fp32 master
gradients, the overflow flag raised on a non-finite one) and
``update_scale`` (one host read); on an overflow each optimizer's next
``step()`` is patched, once, to skip and print "Gradient overflow".  An
optimizer with a ``DistributedDataParallel`` attached has its gradients
exchanged before the unscale, so that every rank decides alike.

``delay_unscale=True`` leaves the gradients scaled for a later
``scale_loss`` (or ``step()``, which finalizes them) to unscale once.
``delay_overflow_check=True`` skips the scale update.  In the deferred
mode (``amp.initialize(..., defer_scale_update=True)``) with one optimizer
that can take it (``FusedAdam``, ``FusedLAMB``, ``FusedNovoGrad``: the
optimizers with ``_step_cache_scaler_ok``), leaving reads nothing: the
scaler is handed to the optimizer, whose next ``step()`` takes the
scaler's device overflow flag as its skip flag and updates the loss scale
on the device, so no iteration reads the card (and nothing prints
"Gradient overflow"; read ``loss_scale()`` to see the scale).

Beside it, the legacy API: ``init`` returns an ``AmpHandle`` whose
construction makes an O1 policy the ambient one of every module call (or
a ``NoOpHandle``), ``handle.wrap_optimizer`` gives an ``OptimWrapper``
with a scaler per loss, and ``disable_casts`` / ``handle._disable_casts``
turn the casts off for a block.
"""
from __future__ import annotations

import contextlib

import torch

from . import policy as _policy
from ._amp_state import _amp_state, maybe_print
from ._process_optimizer import exchange_before_unscale, reset_fused_sgd_scale


def _patch_step_skip(opt, scaler, idx):
    opt_step = opt.step

    def skip_step(closure=None):
        if closure is not None:
            raise RuntimeError("Currently, Amp does not support closure use "
                               "with optimizers.")
        maybe_print("Gradient overflow.  Skipping step, loss scaler "
                    f"{idx} reducing loss scale to {scaler.loss_scale()}")
        for param in getattr(opt._amp_stash, "all_fp32_from_fp16_params",
                             []):
            param.grad = None
        reset_fused_sgd_scale(opt)
        opt.step = opt_step
        opt._amp_stash.already_patched = False

    return skip_step


@contextlib.contextmanager
def scale_loss(loss, optimizers, loss_id=0, model=None, delay_unscale=False,
               delay_overflow_check=False):
    """``with amp.scale_loss(loss, optimizer) as scaled: scaled.backward()``
    (the reference's surface; ``loss_id`` picks one of ``num_losses``
    scalers)."""
    if _amp_state.opt_properties is None:
        raise RuntimeError(
            "Invoked 'with amp.scale_loss', but internal Amp state has not "
            "been initialized.  model, optimizer = amp.initialize(model, "
            "optimizer, opt_level=...) must be called before "
            "'with amp.scale_loss'.")

    if not _amp_state.opt_properties.enabled:
        yield loss
        return

    if isinstance(optimizers, torch.optim.Optimizer):
        optimizers = [optimizers]

    loss_scaler = _amp_state.loss_scalers[loss_id]
    # a dynamic scale multiplies on the device: reading it back would be a
    # host sync every iteration
    loss_scale = loss_scaler.device_scale if loss_scaler.dynamic \
        else loss_scaler.loss_scale()

    if ((not _amp_state.opt_properties.master_weights)
            and (not loss_scaler.dynamic) and loss_scale == 1.0):
        yield loss.float()
        return

    if not delay_unscale:
        for optimizer in optimizers:
            if not optimizer._amp_stash.params_have_scaled_gradients:
                optimizer._prepare_amp_backward()

    yield loss.float() * loss_scale

    if delay_unscale:
        for optimizer in optimizers:
            optimizer._amp_stash.params_have_scaled_gradients = True
            optimizer._amp_stash._delayed_scaler = loss_scaler
        return
    loss_scaler.clear_overflow_state()
    for optimizer in optimizers:
        exchange_before_unscale(optimizer)
        optimizer._post_amp_backward(loss_scaler)
        optimizer._amp_stash.params_have_scaled_gradients = False
        optimizer._amp_stash._delayed_scaler = None
    # the deferred mode: the scale update runs in the optimizer's step,
    # exactly once, so only with one optimizer
    if (not delay_overflow_check and len(optimizers) == 1
            and _amp_state.opt_properties.defer_scale_update
            and getattr(optimizers[0], "_step_cache_scaler_ok", False)):
        optimizers[0]._amp_stash._deferred_scaler = loss_scaler
        return
    should_skip = False if delay_overflow_check \
        else loss_scaler.update_scale()
    if should_skip:
        for optimizer in optimizers:
            if not optimizer._amp_stash.already_patched:
                optimizer.step = _patch_step_skip(optimizer, loss_scaler,
                                                  loss_id)
                optimizer._amp_stash.already_patched = True


#: the free cast-disable scope (the reference handle's ``disable_casts``)
disable_casts = _policy.disable_casts


class AmpHandle:
    """The legacy handle :func:`init` returns.  Constructing it makes an O1
    ``CastPolicy`` the ambient policy of every module call and installs
    the module hooks that apply it; ``_deactivate`` takes it away.  The
    cast cache of the reference (``has_cache``, ``cache``,
    ``remove_cache``) is kept for its API but holds nothing: every cast is
    made anew at each op, as in the JAX package.  Each
    ``wrap_optimizer`` makes the wrapper's scalers on the optimizer's
    device."""

    def __init__(self, loss_scale="dynamic", enable_caching=True,
                 verbose=False, allow_banned=False):
        from .frontend import get_default_half_dtype
        self._enable_caching = enable_caching
        self._verbose = verbose
        self._cache = {}
        self._loss_scale = loss_scale
        self._is_active = True
        self._policy = _policy.CastPolicy(
            half_dtype=get_default_half_dtype(), enabled=True,
            allow_banned=allow_banned, verbose=verbose)
        _policy.replay_registrations(self._policy)
        _amp_state.handle = self._policy
        _amp_state.ambient_policy = self._policy
        _policy.install_module_hooks()

    def is_active(self):
        return self._is_active and _amp_state.ambient_policy is self._policy

    @contextlib.contextmanager
    def _disable_casts(self):
        self._is_active = False
        try:
            with _policy.disable_casts():
                yield
        finally:
            self._is_active = True

    def wrap_optimizer(self, optimizer, num_loss=1):
        from .opt import OptimWrapper
        return OptimWrapper(optimizer, self, num_loss,
                            loss_scale=self._loss_scale)

    def scale_loss(self, loss, optimizer):
        raise RuntimeError(
            "The old Amp API's handle.scale_loss is no longer supported.  "
            "Use handle.wrap_optimizer(optimizer).scale_loss(loss), or move "
            "to the amp.initialize API.")

    def _clear_cache(self):
        self._cache.clear()

    def _deactivate(self):
        """Take the ambient policy and its module hooks away (the
        reference restores the torch functions it patched)."""
        if _amp_state.ambient_policy is self._policy:
            _amp_state.ambient_policy = None
            _amp_state.handle = None
            _policy.remove_module_hooks()

    @property
    def has_cache(self):
        return self._enable_caching

    @property
    def cache(self):
        return self._cache

    def remove_cache(self, param):
        if self.has_cache and param in self.cache:
            del self.cache[param]

    @property
    def verbose(self):
        return self._verbose


class NoOpHandle:
    """What ``init(enabled=False)`` returns: casts nothing, scales
    nothing."""

    def is_active(self):
        return False

    @contextlib.contextmanager
    def _disable_casts(self):
        yield

    def wrap_optimizer(self, optimizer, num_loss=1):
        from .opt import OptimWrapper
        return OptimWrapper(optimizer, self, num_loss)

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer):
        yield loss

    @property
    def has_cache(self):
        return False

    @property
    def verbose(self):
        return False

    def _clear_cache(self):
        pass

    def _deactivate(self):
        pass


def init(enabled=True, loss_scale="dynamic", enable_caching=True,
         verbose=False, allow_banned=False):
    """The legacy entry point: an ``AmpHandle`` whose construction turns
    O1's casts on for every module call (or a ``NoOpHandle`` when not
    ``enabled``).  ``amp.initialize`` is the current API."""
    if not enabled:
        return NoOpHandle()
    return AmpHandle(loss_scale, enable_caching, verbose, allow_banned)
