"""In-place patching of optimizer instances for amp, the PyTorch
counterpart of ``apex_tpu/amp/_process_optimizer.py``.

The same machinery as there: an ``_amp_stash`` with the half and master
parameter lists, lazy creation of fp32 masters (each half parameter of the
optimizer's groups swapped for an fp32 copy), a patched ``step`` that
copies the masters back into the half model parameters, a patched
``zero_grad`` and ``add_param_group``, and the ``_prepare_amp_backward`` /
``_post_amp_backward`` pair that ``scale_loss`` drives: before the
backward, the gradients already there are stashed; after it, the new
half gradients are unscaled into fp32 master gradients (or added to the
stashed ones) with the overflow flag raised on a non-finite one.  "Half"
means float16 or bfloat16.

``FusedAdam`` and ``FusedLAMB`` take that generic path: their step
updates the fp32 masters, and the patched step copies them into the half
model parameters.  ``FusedSGD`` gets the JAX package's variants: its step
writes the half model copy itself (a depth-4 launch), so the patched step
makes no copy of its own; and with ``materialize_master_grads=False`` the
backward leaves the half gradients scaled (unscaled only by what an
earlier stashed gradient needs) and records in ``most_recent_scale`` the
scale the kernel divides them by.
"""
from __future__ import annotations

import types

import torch

from ..optimizers import FusedSGD
from ._amp_state import maybe_print

_HALF = (torch.float16, torch.bfloat16)


class AmpOptimizerState:
    pass


def _check_dtype(param):
    if param.dtype not in _HALF + (torch.float32,):
        raise TypeError("Optimizer's parameters must be float32 or half "
                        f"(float16/bfloat16). Received {param.dtype}")


def _master_of(param):
    return torch.nn.Parameter(param.detach().float().clone())


def _master_params_to_model_params(self):
    stash = self._amp_stash
    if stash.all_fp16_params:
        with torch.no_grad():
            torch._foreach_copy_(stash.all_fp16_params,
                                 stash.all_fp32_from_fp16_params)


def _masters_of_group(stash, params):
    """Sort one group's parameters into half and fp32 ones, put an fp32
    master in the list in place of each half one, and add the group to the
    stash.  Returns the (half, master) pairs."""
    fp16_g, fp32_g, masters_g = [], [], []
    for i, param in enumerate(params):
        if not param.requires_grad:
            continue
        _check_dtype(param)
        if param.dtype in _HALF:
            fp16_g.append(param)
            params[i] = _master_of(param)
            masters_g.append(params[i])
        else:
            fp32_g.append(param)
    stash.fp16_groups.append(fp16_g)
    stash.fp32_from_fp16_groups.append(masters_g)
    stash.fp32_from_fp32_groups.append(fp32_g)
    stash.all_fp16_params += fp16_g
    stash.all_fp32_from_fp16_params += masters_g
    stash.all_fp32_from_fp32_params += fp32_g
    stash.all_fp16_grad_stash += [None] * len(fp16_g)
    stash.all_fp32_from_fp32_grad_stash += [None] * len(fp32_g)
    return list(zip(fp16_g, masters_g))


def lazy_init_with_master_weights(self):
    stash = self._amp_stash
    stash.fp16_groups, stash.fp32_from_fp16_groups = [], []
    stash.fp32_from_fp32_groups = []
    stash.all_fp16_params, stash.all_fp32_from_fp16_params = [], []
    stash.all_fp32_from_fp32_params = []
    stash.all_fp16_grad_stash, stash.all_fp32_from_fp32_grad_stash = [], []
    for param_group in self.param_groups:
        for half, master in _masters_of_group(stash, param_group["params"]):
            if half in self.state:
                # a state loaded before the masters existed was cast to the
                # half param's dtype by torch's load_state_dict: back to
                # the master's, as the reference's load_state_dict(
                # state_dict()) round trip at this point does
                self.state[master] = {
                    k: v.to(master.dtype) if k != "step" and isinstance(
                        v, torch.Tensor) and v.is_floating_point() else v
                    for k, v in self.state.pop(half).items()}
    for param in stash.all_fp32_from_fp16_params \
            + stash.all_fp32_from_fp32_params:
        param.grad = None


def post_backward_models_are_masters(scaler, params, stashed_grads,
                                     scale_override=None):
    """Unscale the gradients of parameters that are their own masters,
    adding the stashed ones where there are."""
    grads_have_scale = scaler.device_scale
    stashed_have_scale, out_scale = 1.0, 1.0

    if not scaler.dynamic and scaler.static_scale == 1.0:
        for i in range(len(stashed_grads)):
            stashed_grads[i] = None
        return

    if scale_override is not None:
        grads_have_scale, stashed_have_scale, out_scale = scale_override

    needing_unscale, needing_stash, stashed = [], [], []
    for param, stashed_grad in zip(params, stashed_grads):
        if param.grad is None and stashed_grad is not None:
            param.grad = stashed_grad
        elif param.grad is not None and stashed_grad is None:
            needing_unscale.append(param)
        elif param.grad is not None and stashed_grad is not None:
            needing_stash.append(param)
            stashed.append(stashed_grad)

    if needing_unscale:
        new = scaler.unscale(
            [p.grad for p in needing_unscale],
            [p.grad for p in needing_unscale], None,
            models_are_masters=True,
            scale_override=grads_have_scale / out_scale)
        for p, g in zip(needing_unscale, new):
            p.grad = g

    if needing_stash:
        new = scaler.unscale_with_stashed(
            [p.grad for p in needing_stash], stashed,
            [p.grad for p in needing_stash],
            scale_override=(grads_have_scale, stashed_have_scale, out_scale))
        for p, g in zip(needing_stash, new):
            p.grad = g

    for i in range(len(stashed_grads)):
        stashed_grads[i] = None


def prepare_backward_with_master_weights(self):
    stash = self._amp_stash
    self._amp_lazy_init()
    for param in stash.all_fp16_params:
        param.grad = None
    for i, param in enumerate(stash.all_fp32_from_fp32_params):
        stash.all_fp32_from_fp32_grad_stash[i] = param.grad
        param.grad = None


def post_backward_with_master_weights(self, scaler):
    stash = self._amp_stash
    self._amp_lazy_init()
    fp16_needing_unscale, new_masters = [], []
    fp16_needing_stash, preexisting_masters = [], []
    for fp16_param, fp32_param in zip(stash.all_fp16_params,
                                      stash.all_fp32_from_fp16_params):
        if fp16_param.grad is None:
            continue
        if fp32_param.grad is None:
            fp16_needing_unscale.append(fp16_param)
            new_masters.append(fp32_param)
        else:
            fp16_needing_stash.append(fp16_param)
            preexisting_masters.append(fp32_param)

    if fp16_needing_unscale:
        # the masters only give the dtype of the unscaled gradients
        new = scaler.unscale([p.grad for p in fp16_needing_unscale],
                             new_masters, scaler.device_scale,
                             models_are_masters=False)
        for mp, g in zip(new_masters, new):
            mp.grad = g

    if fp16_needing_stash:
        new = scaler.unscale_with_stashed(
            [p.grad for p in fp16_needing_stash],
            [p.grad for p in preexisting_masters],
            [p.grad for p in preexisting_masters])
        for mp, g in zip(preexisting_masters, new):
            mp.grad = g

    post_backward_models_are_masters(
        scaler, stash.all_fp32_from_fp32_params,
        stash.all_fp32_from_fp32_grad_stash)


def lazy_init_no_master_weights(self):
    stash = self._amp_stash
    stash.all_fp16_params = []
    stash.all_fp32_params = []
    for param_group in self.param_groups:
        for param in param_group["params"]:
            _check_dtype(param)
            if param.dtype in _HALF:
                stash.all_fp16_params.append(param)
            else:
                stash.all_fp32_params.append(param)
    stash.all_fp16_grad_stash = [None] * len(stash.all_fp16_params)
    stash.all_fp32_grad_stash = [None] * len(stash.all_fp32_params)


def prepare_backward_no_master_weights(self):
    stash = self._amp_stash
    self._amp_lazy_init()
    for i, param in enumerate(stash.all_fp16_params):
        stash.all_fp16_grad_stash[i] = param.grad
        param.grad = None
    for i, param in enumerate(stash.all_fp32_params):
        stash.all_fp32_grad_stash[i] = param.grad
        param.grad = None


def post_backward_no_master_weights(self, scaler):
    stash = self._amp_stash
    self._amp_lazy_init()
    for params, stashed_grads in (
            (stash.all_fp16_params, stash.all_fp16_grad_stash),
            (stash.all_fp32_params, stash.all_fp32_grad_stash)):
        post_backward_models_are_masters(scaler, params, stashed_grads)


def prepare_backward_with_master_weights_FusedSGD(self):
    if self.materialize_master_grads:
        prepare_backward_with_master_weights(self)
        return
    stash = self._amp_stash
    self._amp_lazy_init()
    for i, param in enumerate(stash.all_fp16_params):
        stash.all_fp16_grad_stash[i] = param.grad
        param.grad = None
    for i, param in enumerate(stash.all_fp32_from_fp32_params):
        stash.all_fp32_from_fp32_grad_stash[i] = param.grad
        param.grad = None


def post_backward_with_master_weights_FusedSGD(self, scaler):
    """With ``materialize_master_grads`` as for any optimizer; without, the
    half and fp32 gradients keep ``out_scale`` (the loss scale, or the
    smaller of it and the previous backward's), which FusedSGD's kernel
    divides out through ``most_recent_scale``."""
    if self.materialize_master_grads:
        post_backward_with_master_weights(self, scaler)
        return
    stash = self._amp_stash
    self._amp_lazy_init()
    grads_have_scale = scaler.loss_scale()
    stashed_have_scale = self.most_recent_scale
    out_scale = grads_have_scale
    if self.scale_set_by_backward:
        out_scale = min(grads_have_scale, self.most_recent_scale)
    for params, stashed_grads in (
            (stash.all_fp16_params, stash.all_fp16_grad_stash),
            (stash.all_fp32_from_fp32_params,
             stash.all_fp32_from_fp32_grad_stash)):
        post_backward_models_are_masters(
            scaler, params, stashed_grads,
            (grads_have_scale, stashed_have_scale, out_scale))
    self.most_recent_scale = out_scale
    self.scale_set_by_backward = True


def exchange_before_unscale(optimizer):
    """A ``DistributedDataParallel`` attached to ``optimizer`` (its
    ``attach_optimizer``) exchanges the window's gradients here, before amp
    unscales them: every rank then unscales the same gradients and takes
    the same overflow-skip decision."""
    ddp = getattr(optimizer, "_ddp_attached", None)
    if ddp is not None:
        ddp.exchange_window()


def finalize_delayed_unscale(optimizer, scaler=None):
    """Settle gradients left scaled by ``scale_loss(delay_unscale=True)``
    when the caller goes to ``optimizer.step()`` without a last non-delayed
    ``scale_loss``: the one pending unscale and scale update run here, so
    the window is unscaled exactly once.  Returns ``(finalized,
    should_skip, scaler)``."""
    stash = optimizer._amp_stash
    if not getattr(stash, "params_have_scaled_gradients", False):
        return False, False, None
    if scaler is None:
        scaler = getattr(stash, "_delayed_scaler", None)
    if scaler is None:
        from ._amp_state import _amp_state
        scaler = _amp_state.loss_scalers[0]
    scaler.clear_overflow_state()
    exchange_before_unscale(optimizer)
    optimizer._post_amp_backward(scaler)
    stash.params_have_scaled_gradients = False
    stash._delayed_scaler = None
    return True, scaler.update_scale(), scaler


def _skip_delayed_overflow_step(optimizer, scaler):
    """The overflow skip of ``scale_loss``'s step patch, for a window whose
    unscale was finalized at ``step()`` instead."""
    stash = optimizer._amp_stash
    maybe_print(
        "Gradient overflow.  Skipping step, loss scaler reducing loss "
        f"scale to {scaler.loss_scale()}")
    for param in getattr(stash, "all_fp32_from_fp16_params", []):
        param.grad = None
    reset_fused_sgd_scale(optimizer)


def reset_fused_sgd_scale(optimizer):
    """A skipped step consumes no scale: FusedSGD's recorded one is
    dropped, as its own step drops it."""
    if hasattr(optimizer, "most_recent_scale"):
        optimizer.most_recent_scale = 1.0
        optimizer.scale_set_by_backward = False


def _amp_lazy_init(self):
    stash = self._amp_stash
    if not stash.lazy_init_called:
        self._lazy_init_maybe_master_weights()
        stash.lazy_init_called = True


def _patch_master_weights(optimizer):
    optimizer._lazy_init_maybe_master_weights = types.MethodType(
        lazy_init_with_master_weights, optimizer)
    optimizer._master_params_to_model_params = types.MethodType(
        _master_params_to_model_params, optimizer)
    old_step = optimizer.step

    def new_step(self, closure=None):
        if closure is not None:
            raise RuntimeError("Currently, Amp does not support closure "
                               "use with optimizers.")
        _, should_skip, scaler = finalize_delayed_unscale(self)
        if should_skip:
            _skip_delayed_overflow_step(self, scaler)
            return None
        retval = old_step()
        if not isinstance(self, FusedSGD):
            self._master_params_to_model_params()
        for param in self._amp_stash.all_fp32_from_fp16_params:
            param.grad = None
        return retval

    def new_zero_grad(self, set_to_none: bool = None):
        if set_to_none is None:
            set_to_none = getattr(self, "set_grad_none", True)
        stash = self._amp_stash
        self._amp_lazy_init()
        for param in stash.all_fp16_params + stash.all_fp32_from_fp32_params:
            if param.grad is not None:
                if set_to_none:
                    param.grad = None
                else:
                    param.grad = torch.zeros_like(param.grad)
        for param in stash.all_fp32_from_fp16_params:
            param.grad = None

    optimizer.step = types.MethodType(new_step, optimizer)
    optimizer.zero_grad = types.MethodType(new_zero_grad, optimizer)
    sgd = isinstance(optimizer, FusedSGD)
    optimizer._prepare_amp_backward = types.MethodType(
        prepare_backward_with_master_weights_FusedSGD if sgd
        else prepare_backward_with_master_weights, optimizer)
    optimizer._post_amp_backward = types.MethodType(
        post_backward_with_master_weights_FusedSGD if sgd
        else post_backward_with_master_weights, optimizer)


def _patch_no_master_weights(optimizer):
    optimizer._lazy_init_maybe_master_weights = types.MethodType(
        lazy_init_no_master_weights, optimizer)
    old_step = optimizer.step

    def new_step(self, closure=None):
        _, should_skip, scaler = finalize_delayed_unscale(self)
        if should_skip:
            _skip_delayed_overflow_step(self, scaler)
            return None
        return old_step() if closure is None else old_step(closure)

    optimizer.step = types.MethodType(new_step, optimizer)
    optimizer._prepare_amp_backward = types.MethodType(
        prepare_backward_no_master_weights, optimizer)
    optimizer._post_amp_backward = types.MethodType(
        post_backward_no_master_weights, optimizer)


def _new_group_params(stash, new_group, master_weights):
    """Register a new param group's parameters in the stash (making masters
    of its half parameters with master weights)."""
    if master_weights:
        _masters_of_group(stash, new_group["params"])
        return
    for param in new_group["params"]:
        _check_dtype(param)
        if param.dtype in _HALF:
            stash.all_fp16_params.append(param)
            stash.all_fp16_grad_stash.append(None)
        else:
            stash.all_fp32_params.append(param)
            stash.all_fp32_grad_stash.append(None)


def _process_optimizer(optimizer, properties):
    if hasattr(optimizer, "_amp_stash"):
        raise RuntimeError("A given optimizer should only be passed through "
                           "amp.initialize once.")
    optimizer._amp_stash = AmpOptimizerState()
    stash = optimizer._amp_stash
    stash.lazy_init_called = False
    stash.already_patched = False
    stash.params_have_scaled_gradients = False
    # the scaler whose scaled gradients scale_loss(delay_unscale=True) left
    # pending; consumed by finalize_delayed_unscale
    stash._delayed_scaler = None

    for name in ("_lazy_init_maybe_master_weights",
                 "_master_params_to_model_params",
                 "_prepare_amp_backward", "_post_amp_backward",
                 "_amp_lazy_init"):
        if hasattr(optimizer, name):
            raise RuntimeError(
                f"Incoming optimizer already has {name} defined.")

    if properties.master_weights:
        _patch_master_weights(optimizer)
    else:
        _patch_no_master_weights(optimizer)
    optimizer._amp_lazy_init = types.MethodType(_amp_lazy_init, optimizer)

    old_add_param_group = optimizer.add_param_group

    def new_add_param_group(self, new_group):
        self._amp_lazy_init()
        if not isinstance(new_group, dict):
            raise TypeError("param group must be a dict")
        new_params = new_group["params"]
        if isinstance(new_params, torch.Tensor):
            new_group["params"] = [new_params]
        elif isinstance(new_params, set):
            raise TypeError("optimizer parameters need to be organized in "
                            "ordered collections; sets are not allowed.")
        else:
            new_group["params"] = list(new_params)
        _new_group_params(self._amp_stash, new_group,
                          properties.master_weights)
        old_add_param_group(new_group)

    optimizer.add_param_group = types.MethodType(new_add_param_group,
                                                 optimizer)
    return optimizer
