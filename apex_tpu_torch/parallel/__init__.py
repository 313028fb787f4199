"""Data parallelism, the PyTorch counterpart of ``apex_tpu/parallel``
(reference ``apex/parallel/__init__.py``): ``DistributedDataParallel``,
``Reducer``, ``SyncBatchNorm``, ``LARC``, ``convert_syncbn_model`` and
``create_syncbn_process_group``, on ``torch.distributed`` with one process
per card (NCCL on the card, gloo on the CPU).  Tensor, pipeline, expert
and context parallelism, ZeRO and the planner come with later slices."""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn.modules.batchnorm import _BatchNorm

from .distributed import (DistributedDataParallel, DistributedInitError,
                          Reducer, all_reduce_mean, apply_flat_dist_call,
                          broadcast_module, flat_dist_call, init_distributed,
                          num_processes, rank, split_by_type,
                          timed_flat_dist_call, world_size)
from .LARC import LARC
from .sync_batchnorm import SyncBatchNorm, check_axis_name

__all__ = ["DistributedDataParallel", "DistributedInitError", "LARC",
           "Reducer", "SyncBatchNorm", "all_reduce_mean",
           "apply_flat_dist_call", "broadcast_module", "convert_syncbn_model",
           "create_syncbn_process_group", "flat_dist_call",
           "init_distributed", "num_processes", "rank", "split_by_type",
           "timed_flat_dist_call", "world_size"]


def convert_syncbn_model(module, process_group=None, channel_last=False,
                         axis_name="data"):
    """Replace every BatchNorm module of ``module`` with a
    :class:`SyncBatchNorm` holding its parameters and buffers (reference
    ``apex/parallel/__init__.py:21-56``); returns the converted module.
    ``axis_name`` as for :class:`SyncBatchNorm`."""
    check_axis_name("convert_syncbn_model", axis_name)
    mod = module
    if isinstance(module, _BatchNorm) and not isinstance(module,
                                                         SyncBatchNorm):
        ref = module.weight if module.affine else module.running_mean
        kw = {} if ref is None else dict(device=ref.device, dtype=ref.dtype)
        mod = SyncBatchNorm(module.num_features, eps=module.eps,
                            momentum=module.momentum, affine=module.affine,
                            track_running_stats=module.track_running_stats,
                            process_group=process_group,
                            channel_last=channel_last, **kw)
        with torch.no_grad():
            if module.affine:
                mod.weight.copy_(module.weight)
                mod.bias.copy_(module.bias)
            if module.track_running_stats:
                mod.running_mean.copy_(module.running_mean)
                mod.running_var.copy_(module.running_var)
                mod.num_batches_tracked.copy_(module.num_batches_tracked)
        mod.train(module.training)
    else:
        for name, child in list(module._modules.items()):
            if child is not None:
                setattr(module, name, convert_syncbn_model(
                    child, process_group=process_group,
                    channel_last=channel_last))
    return mod


def create_syncbn_process_group(group_size, world_size=None):
    """The process group of this rank when the ranks are cut into
    consecutive groups of ``group_size`` that share BatchNorm statistics
    (reference ``apex/parallel/__init__.py:58-95``); None (every rank) for
    ``group_size`` 0 or the world size.  Every rank must call it, since
    each group is made on every rank.  ``world_size`` defaults to
    ``torch.distributed``'s."""
    n = world_size if world_size is not None else dist.get_world_size()
    if group_size == 0 or group_size == n:
        return None
    if group_size < 0:
        raise ValueError(f"group_size must be non-negative, got {group_size}")
    if group_size > n:
        raise ValueError(
            f"group_size {group_size} exceeds world size {n}")
    if n % group_size != 0:
        raise ValueError(
            f"world size {n} must be divisible by group_size {group_size}")
    me = dist.get_rank()
    mine = None
    for start in range(0, n, group_size):
        group = dist.new_group(list(range(start, start + group_size)))
        if start <= me < start + group_size:
            mine = group
    return mine
