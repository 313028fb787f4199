"""Mixed precision, the PyTorch counterpart of ``apex_tpu/amp``:
``initialize`` (O0-O3) and ``scale_loss`` over the loss scaler, the amp
checkpoint state, the device-side scaler core the fused train step uses,
O1's per-op cast policy with its registry API (``policy.py``, ``lists/``)
and the legacy ``init`` / ``AmpHandle`` / ``OptimWrapper`` API."""
from . import lists
from ._amp_state import _amp_state, master_params, maybe_print
from .frontend import (Properties, get_default_half_dtype, initialize,
                       load_state_dict, opt_levels, resolve_dtype,
                       set_default_half_dtype, state_dict)
from .handle import AmpHandle, NoOpHandle, init, scale_loss
from .opt import OptimWrapper
from .policy import (CastPolicy, apply_op_policy, autocast, current_policy,
                     disable_casts, float_function, half_function,
                     promote_function, register_float_function,
                     register_half_function, register_promote_function)
from .scaler import (LossScaler, ScalerState, init_scaler_state,
                     unscale_grads, unscale_with_stashed_grads,
                     update_scale_state)

__all__ = ["AmpHandle", "CastPolicy", "LossScaler", "NoOpHandle",
           "OptimWrapper", "Properties", "ScalerState", "apply_op_policy",
           "autocast", "current_policy", "disable_casts", "float_function",
           "get_default_half_dtype", "half_function", "init",
           "init_scaler_state", "initialize", "lists", "load_state_dict",
           "master_params", "maybe_print", "opt_levels", "promote_function",
           "register_float_function", "register_half_function",
           "register_promote_function", "resolve_dtype", "scale_loss",
           "set_default_half_dtype", "state_dict", "unscale_grads",
           "unscale_with_stashed_grads", "update_scale_state"]
