"""Mixed precision, the PyTorch counterpart of ``apex_tpu/amp``:
``initialize`` (O0, O2, O3) and ``scale_loss`` over the loss scaler, the
amp checkpoint state, and the device-side scaler core the fused train step
uses.  O1's cast policy and the legacy ``init``/``AmpHandle`` API come with
a later slice."""
from ._amp_state import _amp_state, master_params, maybe_print
from .frontend import (Properties, get_default_half_dtype, initialize,
                       load_state_dict, opt_levels, resolve_dtype,
                       set_default_half_dtype, state_dict)
from .handle import scale_loss
from .scaler import (LossScaler, ScalerState, init_scaler_state,
                     unscale_grads, unscale_with_stashed_grads,
                     update_scale_state)

__all__ = ["LossScaler", "Properties", "ScalerState", "get_default_half_dtype",
           "init_scaler_state", "initialize", "load_state_dict",
           "master_params", "maybe_print", "opt_levels", "resolve_dtype",
           "scale_loss", "set_default_half_dtype", "state_dict",
           "unscale_grads", "unscale_with_stashed_grads",
           "update_scale_state"]
