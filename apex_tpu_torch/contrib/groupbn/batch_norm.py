"""Group BatchNorm over NHWC input, the PyTorch counterpart of
``apex_tpu/contrib/groupbn/batch_norm.py`` (the reference's
``apex.contrib.groupbn.BatchNorm2d_NHWC``: NHWC batch norm with an optional
residual add and ReLU, its statistics shared over a group of GPUs).

As in the JAX package it is the shared batch norm
(:func:`apex_tpu_torch.nn.functional.batch_norm` over ``channel_axis=-1``,
plain PyTorch), not a kernel of its own.  ``bn_group`` > 1 merges the
statistics over this rank's group of :func:`create_syncbn_process_group`
(``bn_group``, ``group_world_size``), every rank when the group is the
whole world; the reference's CUDA launch knobs (``max_cta_per_sm``,
``cta_launch_margin``, ``multi_stream``) are taken for API parity and
change nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...kernels.dispatch import resolve_device
from ...nn import functional as F
from ...parallel import check_axis_name, create_syncbn_process_group


class BatchNorm2d_NHWC(torch.nn.Module):
    """BatchNorm over (N, H, W, C) input, statistics over the last axis.

    ``fuse_relu`` applies a ReLU to the output, after ``forward(x, z)``'s
    residual add; in training the group's batch mean and ``1 / sqrt(var +
    eps)`` are kept in the ``minibatch_mean`` and ``minibatch_riv``
    buffers beside the running statistics.  Built on the card unless
    ``device`` says otherwise, like the port's models."""

    def __init__(self, num_features, fuse_relu=False, bn_group=1,
                 max_cta_per_sm=2, cta_launch_margin=12, multi_stream=False,
                 eps=1e-5, momentum=0.1, axis_name="data",
                 group_world_size=None, device=None):
        super().__init__()
        check_axis_name("BatchNorm2d_NHWC", axis_name)
        self.num_features = num_features
        self.fuse_relu = fuse_relu
        self.bn_group = bn_group
        self.eps = eps
        self.momentum = momentum
        self.axis_name = axis_name if bn_group > 1 else None
        # None with bn_group > 1: the group is every rank
        self.process_group = (
            create_syncbn_process_group(bn_group, group_world_size)
            if bn_group > 1 else None)
        dev = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.weight = torch.nn.Parameter(torch.ones(num_features, **f32))
        self.bias = torch.nn.Parameter(torch.zeros(num_features, **f32))
        for name, fill in (("running_mean", 0.0), ("running_var", 1.0),
                           ("minibatch_mean", 0.0), ("minibatch_riv", 1.0)):
            self.register_buffer(name, torch.full((num_features,), fill,
                                                  **f32))

    def _group(self):
        if self.bn_group <= 1 or not dist.is_initialized():
            return None
        return self.process_group or dist.group.WORLD

    def forward(self, x, z=None):
        y, new_rm, new_rv, mb_mean, mb_riv = F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=self.training, momentum=self.momentum, eps=self.eps,
            channel_axis=-1, return_stats=True,
            process_group=self._group() if self.training else None)
        if self.training:
            with torch.no_grad():
                for buf, new in ((self.running_mean, new_rm),
                                 (self.running_var, new_rv),
                                 (self.minibatch_mean, mb_mean),
                                 (self.minibatch_riv, mb_riv)):
                    buf.copy_(new)
        if z is not None:
            y = y + z
        return torch.relu(y) if self.fuse_relu else y

    def extra_repr(self):
        return (f"{self.num_features}, fuse_relu={self.fuse_relu}, "
                f"bn_group={self.bn_group}")
