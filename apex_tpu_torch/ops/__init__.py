from .multi_tensor import (ADAM_MODE_DECOUPLED, ADAM_MODE_L2, adam_unfused,
                           multi_tensor_adam, multi_tensor_scale, zero_flag)

__all__ = ["ADAM_MODE_DECOUPLED", "ADAM_MODE_L2", "adam_unfused",
           "multi_tensor_adam", "multi_tensor_scale", "zero_flag"]
