"""The legacy manual mixed-precision helpers, the PyTorch counterpart of
``apex_tpu/fp16_utils``: network conversion, fp32 master parameter lists,
the static and dynamic loss scalers and ``FP16_Optimizer``."""
from .fp16_optimizer import FP16_Optimizer
from .fp16util import (BN_convert_float, FP16Model, clip_grad_norm,
                       convert_module, convert_network,
                       master_params_to_model_params,
                       model_grads_to_master_grads, network_to_half,
                       prep_param_lists, to_python_float, tofp16)
from .loss_scaler import DynamicLossScaler, LossScaler

__all__ = ["BN_convert_float", "DynamicLossScaler", "FP16Model",
           "FP16_Optimizer", "LossScaler", "clip_grad_norm",
           "convert_module", "convert_network",
           "master_params_to_model_params", "model_grads_to_master_grads",
           "network_to_half", "prep_param_lists", "to_python_float",
           "tofp16"]
