"""The deprecated fused-optimizer surface, the PyTorch counterpart of
``apex_tpu/contrib/optimizers`` (the reference's
``apex/contrib/optimizers``): the legacy-API ``FusedAdam`` (explicit
``grads`` / ``output_params`` / ``scale`` in ``step``), the two-stage
``FusedLAMB`` and the cut-down ``FP16_Optimizer`` built for them.  All
three are jnp in the JAX package and plain PyTorch here."""
from .fp16_optimizer import FP16_Optimizer
from .fused_adam import FusedAdam
from .fused_lamb import FusedLAMB

__all__ = ["FP16_Optimizer", "FusedAdam", "FusedLAMB"]
