"""Fused optimizers and lr schedules: FusedAdam, FusedSGD, FusedLAMB and
FusedNovoGrad.  The deprecated-API optimizers (the legacy FusedAdam, the
two-stage FusedLAMB, FP16_Optimizer) are in ``contrib.optimizers``."""
from .base import group_buckets, split_by_dtype
from .fused_adam import FusedAdam
from .fused_lamb import FusedLAMB
from .fused_novograd import FusedNovoGrad
from .fused_sgd import FusedSGD
from .schedules import (step_decay, warmup_cosine, warmup_linear,
                        warmup_poly)

__all__ = ["FusedAdam", "FusedLAMB", "FusedNovoGrad", "FusedSGD",
           "group_buckets", "split_by_dtype", "step_decay", "warmup_cosine",
           "warmup_linear", "warmup_poly"]
