"""Fused optimizers and lr schedules.  FusedAdam and FusedSGD are ported;
FusedLAMB and FusedNovoGrad come with the slices that run them."""
from .base import group_buckets, split_by_dtype
from .fused_adam import FusedAdam
from .fused_sgd import FusedSGD
from .schedules import (step_decay, warmup_cosine, warmup_linear,
                        warmup_poly)

__all__ = ["FusedAdam", "FusedSGD", "group_buckets", "split_by_dtype",
           "step_decay", "warmup_cosine", "warmup_linear", "warmup_poly"]
