#!/usr/bin/env python3
"""The imagenet example's amp O2 + DDP iteration, NCHW against
``--channels-last --sync_bn``, in several orders, on one card.

    PYTHONPATH=. python3 tools/imagenet_layout_turns.py

Run from the root of a checkout on a host with one H100.  Each arm builds
``chip_smoke._imagenet_model`` (ResNet-50, ``convert_syncbn_model``, amp
O2 in fp16, DDP over NCCL at world size 1, batch 64 of 224 x 224), runs 3
iterations, then times 10 with the loss read back each (images/s on the
host clock) and prints the host's enqueue ms of each iteration and the
process's live Python objects before the arm.  The arms run in the order
``TURNS`` (NCHW and NHWC alternating which goes first) with a
``gc.collect()`` before each, so a drift of the host's time over a process
shows apart from the layout.  ``native_bn`` arms run batch norm on torch's
own kernels instead of cuDNN's (``torch.batch_norm(..., cudnn_enabled=
False)``).
"""
import gc
import time

import numpy as np
import torch

import chip_smoke as c
from apex_tpu_torch import _build, amp, models, parallel

# (channels_last, native_bn)
TURNS = ((True, False), (False, False), (False, False), (True, False),
         (True, True), (False, False), (True, False), (False, True))


def _native_batch_norm(input, running_mean, running_var, weight=None,
                       bias=None, training=False, momentum=0.1, eps=1e-5):
    return torch.batch_norm(input, weight, bias, running_mean, running_var,
                            training, momentum, eps, False)


def arm(cl, native_bn):
    """One arm: images/s over 10 iterations and each one's enqueue ms."""
    from apex_tpu_torch.amp._amp_state import reset
    gc.collect()
    live = len(gc.get_objects())
    reset()
    real = torch.nn.functional.batch_norm
    if native_bn:
        torch.nn.functional.batch_norm = _native_batch_norm
    try:
        model, opt = c._imagenet_model(torch, models, parallel, amp, "cuda",
                                       max_loss_scale=2.0 ** 10,
                                       channels_last=cl)
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal(
            (c.AMP_RESNET_BATCH, 3, 224, 224)).astype(np.float32)).cuda()
        if cl:
            x = x.permute(0, 2, 3, 1).contiguous()
        y = torch.from_numpy(rng.integers(0, 1000, (c.AMP_RESNET_BATCH,))
                             ).cuda()
        crit = c._resnet_loss(torch)
        for _ in range(3):
            c._amp_iteration(amp, model, opt, crit, x, y)
        torch.cuda.synchronize()
        host = []
        t0 = time.perf_counter()
        for _ in range(10):
            h0 = time.perf_counter()
            loss, _ = c._amp_iteration(amp, model, opt, crit, x, y)
            host.append(1e3 * (time.perf_counter() - h0))
            float(loss)
        torch.cuda.synchronize()
        ips = 10 * c.AMP_RESNET_BATCH / (time.perf_counter() - t0)
    finally:
        torch.nn.functional.batch_norm = real
    print(f"channels_last={cl} native_bn={native_bn}: {ips:.1f} images/s; "
          f"live objects before {live}; enqueue ms "
          f"{', '.join('%.1f' % h for h in host)}", flush=True)


def main():
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(c.card_line())
    _build._build(["multi_tensor_sgd"])
    parallel.init_distributed(f"127.0.0.1:{c._free_port()}",
                              num_processes=1, process_id=0, timeout_s=120)
    try:
        for cl, native_bn in TURNS:
            arm(cl, native_bn)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
