"""amp front end, the PyTorch counterpart of ``apex_tpu/amp/frontend.py``:
the O0-O3 presets, ``initialize`` and the amp checkpoint state.

The presets default to float16, as the reference's do;
``cast_model_type="bfloat16"`` or ``set_default_half_dtype("bfloat16")``
picks bf16.  Dtypes may be given as ``torch.dtype``s or strings
("float16", "fp16", "half", "bfloat16", "bf16", "float32", ...).

O1 keeps the model in fp32 and casts around each operation by the cast
policy of ``policy.py`` and ``lists/``, applied to every module call of
the session (``_initialize.py``).  ``defer_scale_update=True`` needs the
runtime executor and raises ``NotImplementedError``.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ._amp_state import _amp_state, maybe_print, warn_or_err
from .policy import remove_module_hooks

_DTYPE_ALIASES = {
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
}

_default_half_dtype = [torch.float16]


def set_default_half_dtype(dtype):
    """Set what "half" means for the O2 and O3 presets (float16 or
    bfloat16)."""
    _default_half_dtype[0] = resolve_dtype(dtype)


def get_default_half_dtype():
    return _default_half_dtype[0]


def resolve_dtype(value):
    """A ``torch.dtype`` from a dtype or one of the dtype names."""
    if value is None or isinstance(value, torch.dtype):
        return value
    if isinstance(value, str):
        try:
            return _DTYPE_ALIASES[value.lower()]
        except KeyError:
            raise ValueError(f"Unknown dtype string {value!r}") from None
    name = getattr(value, "name", None) or getattr(value, "__name__", None)
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    raise ValueError(f"Cannot resolve {value!r} to a torch dtype")


class Properties:
    """The options of one amp session, with the reference's consistency
    checks on each assignment."""

    def __init__(self):
        self.options = {
            "enabled": False,
            "opt_level": None,
            "cast_model_type": None,
            "patch_torch_functions": False,
            "keep_batchnorm_fp32": None,
            "master_weights": None,
            "loss_scale": 1.0,
            "defer_scale_update": False,
        }

    def __getattr__(self, name):
        if "options" in self.__dict__:
            options = self.__dict__["options"]
            if name in options:
                return options[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        if "options" not in self.__dict__ or name not in self.options:
            super().__setattr__(name, value)
            return
        if name == "cast_model_type":
            if not isinstance(value, bool):
                value = resolve_dtype(value)
            if self.opt_level == "O1" and value is not None \
                    and value is not False and value != torch.float32:
                warn_or_err(
                    "O1 inserts casts around functions rather than model "
                    "weights, so with O1, the model weights themselves "
                    "should remain FP32. If you wish to cast the model to "
                    "a different type, use opt_level='O2' or 'O3'. "
                    f"cast_model_type was {value}")
        elif name == "patch_torch_functions":
            if self.opt_level != "O1" and value:
                warn_or_err("Currently, patch_torch_functions=True should "
                            "only be set by selecting opt_level='O1'.")
        elif name == "keep_batchnorm_fp32":
            if self.opt_level == "O1" and value is not None:
                warn_or_err(
                    "With opt_level O1, batchnorm functions are "
                    "automatically patched to run in FP32, so "
                    "keep_batchnorm_fp32 should be None. "
                    f"keep_batchnorm_fp32 was {value}")
            value = {"False": False, "True": True}.get(value, value)
            if value not in (True, False, None):
                raise ValueError(
                    "keep_batchnorm_fp32 must be a boolean, the string "
                    "'True' or 'False', or None, found "
                    f"keep_batchnorm_fp32={value}")
        elif name == "master_weights":
            if self.opt_level == "O1" and value is not None:
                warn_or_err("It doesn't make sense to use master_weights "
                            "with O1. With O1, your model weights "
                            "themselves should be FP32.")
        elif name == "loss_scale":
            value = value if value == "dynamic" else float(value)
        self.options[name] = value


class O3:
    brief = "O3:  Pure half-precision training."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O3"
        properties.cast_model_type = get_default_half_dtype()
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = False
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class O2:
    brief = ("O2:  Half-precision training with FP32 batchnorm and FP32 "
             "master weights.")

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O2"
        properties.cast_model_type = get_default_half_dtype()
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = True
        properties.master_weights = True
        properties.loss_scale = "dynamic"
        return properties


class O1:
    brief = "O1:  Insert automatic casts around compute functions."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O1"
        properties.cast_model_type = None
        properties.patch_torch_functions = True
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = None
        properties.loss_scale = "dynamic"
        return properties


class O0:
    brief = "O0:  Pure FP32 training."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O0"
        properties.cast_model_type = torch.float32
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


opt_levels = {"O3": O3(), "O2": O2(), "O1": O1(), "O0": O0()}


def initialize(models, optimizers=None, enabled=True, opt_level="O1",
               cast_model_type=None, patch_torch_functions=None,
               keep_batchnorm_fp32=None, master_weights=None, loss_scale=None,
               cast_model_outputs=None, num_losses=1, verbosity=1,
               min_loss_scale=None, max_loss_scale=2.0 ** 24,
               defer_scale_update=None):
    """Set models and optimizers up for mixed-precision training: the
    reference's argument surface.  Returns what it was given, processed
    (a model, a list of models, and with optimizers the pair)."""
    from ._initialize import _initialize

    _amp_state.opt_properties = Properties()
    _amp_state.verbosity = verbosity
    _amp_state.ambient_policy = None
    remove_module_hooks()

    if not enabled:
        _amp_state.handle = None
        if optimizers is None:
            return models
        return models, optimizers

    if opt_level not in opt_levels:
        raise RuntimeError(
            f"Unexpected optimization level {opt_level}. Options are 'O0', "
            "'O1', 'O2', 'O3'.  Note that in `O0`, `O1`, etc., the prefix O "
            "is the letter O, not the number zero.")
    if defer_scale_update:
        raise NotImplementedError(
            "amp defer_scale_update=True needs the runtime executor, which "
            "is not ported yet")

    _amp_state.opt_properties = opt_levels[opt_level](
        _amp_state.opt_properties)
    maybe_print(f"Selected optimization level {opt_levels[opt_level].brief}",
                True)
    maybe_print("Defaults for this optimization level are:", True)
    for k, v in _amp_state.opt_properties.options.items():
        maybe_print(f"{k:22} : {v}", True)

    _amp_state.min_loss_scale = min_loss_scale
    _amp_state.max_loss_scale = max_loss_scale

    maybe_print("Processing user overrides (additional kwargs that are not "
                "None)...", True)
    for name, value in (("enabled", enabled),
                        ("cast_model_type", cast_model_type),
                        ("patch_torch_functions", patch_torch_functions),
                        ("keep_batchnorm_fp32", keep_batchnorm_fp32),
                        ("master_weights", master_weights),
                        ("loss_scale", loss_scale)):
        if value is not None:
            setattr(_amp_state.opt_properties, name, value)

    maybe_print("After processing overrides, optimization options are:", True)
    for k, v in _amp_state.opt_properties.options.items():
        maybe_print(f"{k:22} : {v}", True)

    return _initialize(models, optimizers, _amp_state.opt_properties,
                       num_losses, cast_model_outputs)


def state_dict(destination=None):
    """The amp checkpoint state: each loss scaler's scale and count of
    clean steps (two host reads each)."""
    if destination is None:
        destination = OrderedDict()
    for idx, loss_scaler in enumerate(_amp_state.loss_scalers):
        destination[f"loss_scaler{idx}"] = {
            "loss_scale": loss_scaler.loss_scale(),
            "unskipped": loss_scaler._unskipped,
        }
    return destination


def load_state_dict(state_dict):
    """Restore what :func:`state_dict` saved (the reference's warnings and
    errors)."""
    if len(state_dict) != len(_amp_state.loss_scalers):
        print(f"Warning: state_dict contains {len(state_dict)} entries, while "
              f"{len(_amp_state.loss_scalers)} loss_scalers are used")
    nb_loss_scalers = len(_amp_state.loss_scalers)
    unexpected_keys = []
    idx = 0
    for key in state_dict:
        if "loss_scaler" not in key:
            unexpected_keys.append(key)
        else:
            if idx > (nb_loss_scalers - 1):
                print(f"Skipping loss_scaler[{idx}], since num_losses was set "
                      f"to {nb_loss_scalers}")
                break
            _amp_state.loss_scalers[idx]._loss_scale = \
                state_dict[key]["loss_scale"]
            _amp_state.loss_scalers[idx]._unskipped = \
                state_dict[key]["unskipped"]
            idx += 1
    if unexpected_keys:
        raise RuntimeError(
            "Error(s) in loading state_dict. Unexpected key(s) in state_dict: "
            + ", ".join(f'"{k}"' for k in unexpected_keys) + ". ")
