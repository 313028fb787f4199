"""Counterpart of ``apex_tpu/contrib/groupbn`` (the reference's
``apex.contrib.groupbn``)."""
from .batch_norm import BatchNorm2d_NHWC

__all__ = ["BatchNorm2d_NHWC"]
