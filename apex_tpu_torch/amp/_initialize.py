"""Apply an amp session's properties to models and optimizers, the PyTorch
counterpart of ``apex_tpu/amp/_initialize.py``.

O2/O3 cast the model's floating parameters and buffers to the half dtype
(BatchNorm modules stay fp32 under ``keep_batchnorm_fp32``, as the
reference's ``convert_network`` keeps them).  Where the JAX package tags
the model with ``_amp_input_cast_dtype`` / ``_amp_output_cast_dtype`` for
its tape to honour, the port registers a forward pre-hook that casts the
floating positional inputs to the half dtype and a forward hook that casts
a floating tensor output to fp32 (or ``cast_model_outputs``); a tuple
output, such as an ``output_hidden`` GPT's ``(hidden, table)``, is left as
it is, as there.  ``model.state_dict()`` reports fp32 values.

O1 builds the session's ``CastPolicy`` (the default half dtype, the
registrations made so far replayed onto it), tags each model with it as
``_amp_policy``, makes it the ambient policy of every other module call
(criterions included) and installs the module hooks that apply it
(``policy.py``).  The model stays fp32.
"""
from __future__ import annotations

import torch

from ._amp_state import _amp_state, warn_or_err
from ._process_optimizer import _process_optimizer
from .policy import CastPolicy, install_module_hooks, replay_registrations
from .scaler import LossScaler


def check_models(models):
    for model in models:
        if isinstance(model, torch.nn.parallel.DistributedDataParallel):
            raise RuntimeError(
                "Incoming model is an instance of "
                "torch.nn.parallel.DistributedDataParallel. Parallel "
                "wrappers should only be applied to the model(s) AFTER the "
                "model(s) have been returned from amp.initialize.")
        if not isinstance(model, torch.nn.Module):
            raise RuntimeError("amp.initialize expects torch.nn.Module "
                               f"models, got {type(model)}")


def check_params_fp32(models):
    for model in models:
        for name, param in model.named_parameters():
            if param.is_floating_point() and param.requires_grad \
                    and param.dtype != torch.float32:
                warn_or_err(
                    f"Found param {name} with type {param.dtype}, expected "
                    "torch.float32.  When using amp.initialize, you do not "
                    "need to call .half() or .bfloat16() on your model "
                    "before passing it, no matter what optimization level "
                    "you choose.")


def check_optimizers(optimizers):
    for optim in optimizers:
        if hasattr(optim, "_amp_stash"):
            raise RuntimeError(
                "An incoming optimizer has already been processed by "
                "amp.initialize; reuse is not supported.")


def convert_network(model, dtype):
    """Cast the floating parameters and buffers of every module except
    BatchNorm's to ``dtype``, in place."""
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            continue
        for t in list(m.parameters(recurse=False)) \
                + list(m.buffers(recurse=False)):
            if t.is_floating_point():
                t.data = t.data.to(dtype)
    return model


def _cast_tree(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, (tuple, list)):
        return type(x)(_cast_tree(v, dtype) for v in x)
    if isinstance(x, dict):
        return {k: _cast_tree(v, dtype) for k, v in x.items()}
    return x


def _install_casts(model, in_dtype, out_dtype):
    if in_dtype is not None:
        model.register_forward_pre_hook(
            lambda mod, args: tuple(_cast_tree(a, in_dtype) for a in args))
    if out_dtype is not None:
        def out_hook(mod, args, out):
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                return out.to(out_dtype)
            return out
        model.register_forward_hook(out_hook)


def _fp32_state_dict_hook(module, state_dict, prefix, local_metadata):
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point() \
                and v.dtype != torch.float32:
            state_dict[k] = v.float()
    return state_dict


def _initialize(models, optimizers, properties, num_losses=1,
                cast_model_outputs=None):
    optimizers_was_list = False
    if isinstance(optimizers, torch.optim.Optimizer):
        optimizers = [optimizers]
    elif optimizers is None:
        optimizers = []
    elif isinstance(optimizers, list):
        optimizers_was_list = True
        check_optimizers(optimizers)
    else:
        raise TypeError("optimizers must be either a single optimizer or a "
                        "list of optimizers.")

    if isinstance(models, torch.nn.Module):
        models_was_list = False
        models = [models]
    elif isinstance(models, list):
        models_was_list = True
    else:
        raise TypeError("models must be either a single model or a list of "
                        "models.")

    check_models(models)
    if not _amp_state.allow_incoming_model_not_fp32:
        check_params_fp32(models)

    cast = properties.cast_model_type
    if cast:
        for model in models:
            if properties.keep_batchnorm_fp32:
                convert_network(model, cast)
            else:
                model.to(cast)
            _install_casts(model, cast, cast_model_outputs
                           if cast_model_outputs is not None
                           else torch.float32)
            # the JAX package's tag, which keeps the ambient O1 policy of
            # a legacy handle off this model
            model._amp_input_cast_dtype = cast
            model._register_state_dict_hook(_fp32_state_dict_hook)
    elif cast_model_outputs is not None:
        for model in models:
            _install_casts(model, None, cast_model_outputs)

    for i, optimizer in enumerate(optimizers):
        optimizers[i] = _process_optimizer(optimizer, properties)

    dev = None
    for model in models:
        for p in model.parameters():
            dev = p.device
            break
    _amp_state.loss_scalers = [
        LossScaler(properties.loss_scale,
                   min_loss_scale=_amp_state.min_loss_scale,
                   max_loss_scale=_amp_state.max_loss_scale, device=dev)
        for _ in range(num_losses)]

    if properties.patch_torch_functions:
        from .frontend import get_default_half_dtype
        policy = CastPolicy(half_dtype=get_default_half_dtype(), enabled=True,
                            verbose=_amp_state.verbosity == 2)
        replay_registrations(policy)
        _amp_state.handle = policy
        _amp_state.ambient_policy = policy
        for model in models:
            model._amp_policy = policy
        install_module_hooks()

    if optimizers_was_list:
        return (models if models_was_list else models[0]), optimizers
    if models_was_list:
        return models if len(optimizers) == 0 else (models, optimizers[0])
    return models[0] if len(optimizers) == 0 else (models[0], optimizers[0])
