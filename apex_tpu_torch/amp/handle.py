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
``delay_overflow_check=True`` skips the scale update.  The JAX package's
deferred mode (``defer_scale_update``) needs the runtime executor and is
refused at ``initialize``; the legacy ``AmpHandle``/``init`` API comes with
O1.
"""
from __future__ import annotations

import contextlib

import torch

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
    loss_scale = loss_scaler.loss_scale()

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
    should_skip = False if delay_overflow_check \
        else loss_scaler.update_scale()
    if should_skip:
        for optimizer in optimizers:
            if not optimizer._amp_stash.already_patched:
                optimizer.step = _patch_step_skip(optimizer, loss_scaler,
                                                  loss_id)
                optimizer._amp_stash.already_patched = True
