"""SyncBatchNorm, the PyTorch counterpart of
``apex_tpu/parallel/sync_batchnorm.py`` (and of the reference's
``apex/parallel/sync_batchnorm.py``).

A subclass of torch's ``_BatchNorm``, so amp's ``keep_batchnorm_fp32``
and the fused train step treat it as BatchNorm.  In training with more
than one rank in its group, each rank's ``(mean, m2, count)`` is
all-gathered, with a gradient, and merged as a Welford merge weighted by
the counts, so ranks may hold batches of different sizes
(:func:`apex_tpu_torch.nn.functional.batch_norm`), the reference's
``welford_parallel`` scheme.  With one rank, or without
``torch.distributed``, it computes what ``torch.nn.BatchNorm2d`` computes
(the JAX package's unbound-axis case); in eval mode it uses the running
statistics and no collective.  ``channel_last=True`` takes and returns
(N, H, W, C) tensors, statistics over the last axis: with one rank its
permuted (N, C, H, W) view, which has ``torch.channels_last`` strides, goes
through torch's batch norm and comes back permuted (no copy at either
end); across ranks the merge runs over the last axis directly.  As in the
JAX package, ``channel_last`` and ``channels_last`` (the flag that
``nn.to_channels_last`` sets) are one flag.  The JAX package's
``axis_name`` (the mesh axis the statistics are merged over) is taken at
its default or None: ``process_group`` plays its part.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn.modules.batchnorm import _BatchNorm

from .._unported import PARALLEL, refuse
from ..nn import functional as F


def check_axis_name(where, axis_name):
    """The JAX package's mesh axis, accepted at its default ``"data"`` or
    None (``process_group`` decides the ranks) and refused otherwise."""
    if axis_name not in ("data", None):
        refuse(f"{where}: axis_name={axis_name!r}", PARALLEL)


class SyncBatchNorm(_BatchNorm):
    """Cross-rank BatchNorm; ``process_group`` (default: every rank) is
    the group whose ranks share statistics, ``fuse_relu`` applies a ReLU to
    the output."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_group=None,
                 channel_last=False, fuse_relu=False, axis_name="data",
                 device=None, dtype=None):
        check_axis_name("SyncBatchNorm", axis_name)
        super().__init__(num_features, eps=eps, momentum=momentum,
                         affine=affine,
                         track_running_stats=track_running_stats,
                         device=device, dtype=dtype)
        self.process_group = process_group
        self.channel_last = channel_last
        self.fuse_relu = fuse_relu

    # one flag, two spellings: the reference API says channel_last,
    # nn.to_channels_last says channels_last
    @property
    def channel_last(self):
        return self.channels_last

    @channel_last.setter
    def channel_last(self, v):
        self.channels_last = bool(v)

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input (got {x.dim()}D "
                             f"input)")

    def _group(self):
        """The process group to gather over, or None when there is one
        rank."""
        if not dist.is_available() or not dist.is_initialized():
            return None
        group = self.process_group or dist.group.WORLD
        return group if dist.get_world_size(group) > 1 else None

    def forward(self, x):
        self._check_input_dim(x)
        bn_training = self.training or (self.running_mean is None
                                        and self.running_var is None)
        group = self._group() if bn_training else None
        if group is None:
            y = super().forward(x.movedim(-1, 1)).movedim(1, -1) \
                if self.channels_last else super().forward(x)
        else:
            track = self.training and self.track_running_stats
            if track:
                self.num_batches_tracked.add_(1)
            momentum = self.momentum
            if momentum is None:    # a cumulative average, as torch's
                momentum = 1.0 / float(self.num_batches_tracked)
            y, new_rm, new_rv = F.batch_norm(
                x, self.running_mean if track else None,
                self.running_var if track else None, self.weight,
                self.bias, training=True, momentum=momentum, eps=self.eps,
                channel_axis=-1 if self.channels_last else 1,
                process_group=group)
            if track:
                with torch.no_grad():
                    self.running_mean.copy_(new_rm)
                    self.running_var.copy_(new_rv)
        return torch.relu(y) if self.fuse_relu else y
