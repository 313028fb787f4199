from .multi_tensor import (ADAM_MODE_DECOUPLED, ADAM_MODE_L2, adam_unfused,
                           multi_tensor_adam, multi_tensor_axpby,
                           multi_tensor_l2norm, multi_tensor_lamb,
                           multi_tensor_maxnorm, multi_tensor_novograd,
                           multi_tensor_scale, multi_tensor_sgd,
                           nonfinite_flag, sgd_unfused, zero_flag)

__all__ = ["ADAM_MODE_DECOUPLED", "ADAM_MODE_L2", "adam_unfused",
           "multi_tensor_adam", "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_lamb", "multi_tensor_maxnorm", "multi_tensor_novograd",
           "multi_tensor_scale",
           "multi_tensor_sgd", "nonfinite_flag", "sgd_unfused", "zero_flag"]
