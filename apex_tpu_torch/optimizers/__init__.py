"""Fused optimizers and lr schedules.  FusedAdam, FusedSGD and FusedLAMB
are ported; FusedNovoGrad comes with the slice that runs it (ROADMAP
A3)."""
from .base import group_buckets, split_by_dtype
from .fused_adam import FusedAdam
from .fused_lamb import FusedLAMB
from .fused_sgd import FusedSGD
from .schedules import (step_decay, warmup_cosine, warmup_linear,
                        warmup_poly)

__all__ = ["FusedAdam", "FusedLAMB", "FusedSGD", "group_buckets",
           "split_by_dtype", "step_decay", "warmup_cosine", "warmup_linear",
           "warmup_poly"]
