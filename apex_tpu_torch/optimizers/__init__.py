"""Fused optimizers and lr schedules.  FusedAdam is ported; FusedSGD,
FusedLAMB and FusedNovoGrad come with the slices that run them."""
from .base import group_buckets, split_by_dtype
from .fused_adam import FusedAdam
from .schedules import (step_decay, warmup_cosine, warmup_linear,
                        warmup_poly)

__all__ = ["FusedAdam", "group_buckets", "split_by_dtype", "step_decay",
           "warmup_cosine", "warmup_linear", "warmup_poly"]
