"""Fused optimizers.  FusedAdam is ported; FusedSGD, FusedLAMB and
FusedNovoGrad come with the slices that run them."""
from .base import group_buckets, split_by_dtype
from .fused_adam import FusedAdam

__all__ = ["FusedAdam", "group_buckets", "split_by_dtype"]
