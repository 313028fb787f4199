#!/usr/bin/env python3
"""Where the host time of the ResNet-50 steps goes, by layout, on one card.

    PYTHONPATH=. python3 tools/resnet_layout_host.py

Run from the root of a checkout on a host with one H100.  For the bench's
bf16 ResNet-50 step at batch 128 (``chip_smoke.resnet_arm``'s set-up) the
arms ``nchw``, ``nhwc`` (``nn.to_channels_last``, conv weights
channels-last), ``nhwc_oihw`` (conv weights left OIHW-contiguous) and
``cl_memory`` (torch's own recipe: NCHW shapes in ``torch.channels_last``
memory, no flip), in turns: the step ms over 10 steps (host clock, ending
in a synchronize), the host ms of enqueueing one step after a synchronize
(five times), and the CPU operators of one step by self time
(``torch.profiler``, CPU only).  Then the imagenet example's amp O2 + DDP
iteration (batch 64, NCCL at world size 1) NCHW and ``--channels-last
--sync_bn``, twice each: images/s over 8 iterations (the loss read back
each) and the CPU operators of one iteration.
"""
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as c
from apex_tpu_torch import _build, amp, models, nn, parallel
from apex_tpu_torch.nn.modules import conv_weights_to
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.training import make_train_step

STEP_TURNS = ("nhwc", "nhwc_oihw", "cl_memory", "nchw", "nchw", "cl_memory",
              "nhwc_oihw", "nhwc")


def cpu_table(fn, label, rows=16):
    """The CPU operators of one call of ``fn`` by self time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    print(f"==== {label}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=rows, max_name_column_width=60))


def step_arm(name):
    """One arm of the bf16 ResNet-50 step: times and a CPU table."""
    nhwc, fmt = c.RESNET_ARMS.get(name, (False, None))
    torch.manual_seed(c.SEED)
    model = models.resnet50(device="cuda")
    if nhwc:
        conv_weights_to(nn.to_channels_last(model), getattr(torch, fmt))
    if name == "cl_memory":
        model = model.to(memory_format=torch.channels_last)
    step = make_train_step(model, FusedSGD(list(model.parameters()),
                                           **c.SGD_HYPER),
                           c._resnet_loss(torch), half_dtype=torch.bfloat16,
                           loss_scale=1.0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (c.RESNET_BATCH, 3, 224, 224)).astype(np.float32)).cuda()
    if nhwc:
        x = x.permute(0, 2, 3, 1).contiguous()
    if name == "cl_memory":
        x = x.contiguous(memory_format=torch.channels_last)
    y = torch.from_numpy(rng.integers(0, 1000, (c.RESNET_BATCH,))).cuda()
    for _ in range(3):
        step(x, y)
    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y)
        enq.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step(x, y)
    torch.cuda.synchronize()
    print(f"{name}: step {100 * (time.perf_counter() - t0):.2f} ms; host "
          f"enqueue of one step after a synchronize "
          f"{', '.join('%.2f' % e for e in enq)} ms")
    cpu_table(lambda: step(x, y), name)


def imagenet_arm(cl):
    """The imagenet amp O2 + DDP iteration: images/s and a CPU table."""
    from apex_tpu_torch.amp._amp_state import reset
    reset()
    model, opt = c._imagenet_model(torch, models, parallel, amp, "cuda",
                                   max_loss_scale=2.0 ** 10, channels_last=cl)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        (c.AMP_RESNET_BATCH, 3, 224, 224)).astype(np.float32)).cuda()
    if cl:
        x = x.permute(0, 2, 3, 1).contiguous()
    y = torch.from_numpy(rng.integers(0, 1000, (c.AMP_RESNET_BATCH,))).cuda()
    crit = c._resnet_loss(torch)
    for _ in range(3):
        c._amp_iteration(amp, model, opt, crit, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        loss, _ = c._amp_iteration(amp, model, opt, crit, x, y)
        float(loss)
    torch.cuda.synchronize()
    print(f"imagenet channels_last={cl}: "
          f"{8 * c.AMP_RESNET_BATCH / (time.perf_counter() - t0):.1f} "
          f"images/s")
    cpu_table(lambda: c._amp_iteration(amp, model, opt, crit, x, y),
              f"imagenet channels_last={cl}")


def main():
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(c.card_line())
    _build._build(["multi_tensor_sgd"])
    for name in STEP_TURNS:
        step_arm(name)
    parallel.init_distributed(f"127.0.0.1:{c._free_port()}",
                              num_processes=1, process_id=0, timeout_s=120)
    try:
        for cl in (False, True, False, True):
            imagenet_arm(cl)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
