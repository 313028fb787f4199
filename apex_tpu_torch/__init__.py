"""apex_tpu_torch: the PyTorch and CUDA port of ``apex_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``apex_tpu`` stays the reference; this package mirrors its
layout under the same names.  It imports ``torch`` and numpy, never JAX
and nothing of ``apex_tpu``.  Each TPU kernel on a ported path is a CUDA
kernel written for ``sm_90a`` (``csrc/``), built with ``nvcc`` at its first
launch; a CUDA tensor launches it, a CPU tensor takes its plain PyTorch
version.  Entry points run on the card unless the caller passes
``device="cpu"``.

Ported so far: GPT-2-family greedy and sampled generation (prefill through
the flash-attention forward kernel, KV-cache decode, every LayerNorm
through the LayerNorm forward kernel), single-device GPT training
(``training.make_train_step`` with ``optimizers.FusedAdam``, the dynamic or
static loss scaler, O2-style half copies over fp32 masters, gradient
accumulation and lr schedules), whose backward runs the flash-attention and
LayerNorm backward kernels and whose update runs the multi-tensor Adam
kernel; the label-smoothed cross-entropy and the chunked LM-head loss
(``contrib.xentropy``) over the xentropy kernels; the eager mixed
precision loop (``amp.initialize`` O0/O2/O3 and ``amp.scale_loss``); and
ResNet training (``models.resnet50``) through the fused step or the amp
loop with ``optimizers.FusedSGD``, whose update runs the multi-tensor SGD
kernel, with data parallelism and SyncBatchNorm on ``torch.distributed``
(``parallel``); and the Llama family (``models.llama``: RoPE, RMSNorm,
SwiGLU, grouped-query attention), served through ``generate`` and trained
through ``make_train_step``, whose RMSNorms run the RMSNorm kernels
(``normalization.FusedRMSNorm``) and whose loss may run the fused LM-head +
cross-entropy kernels (``kernels.lm_head_xent.fused_lm_head_xent``); amp
O1 (a per-op cast policy applied to every module call), the legacy
``amp.init`` API and ``fp16_utils``; and the GAN iteration
(``training.make_gan_train_step``); and the runtime (``runtime``: the
step cache, the executor that captures each train step as a CUDA graph
and replays it, the input prefetcher, the chaos hooks, the resilience
runtime's atomic schema-3 checkpoints, which the JAX package restores and
which restore the JAX package's, ``CheckpointManager`` and
``BadStepGuard``, and the native host runtime), ``utils.checkpoint``, and
the Hugging Face and torchvision state-dict converters (``models.hf``);
serving (``serve``); and the observe runtime (``observe``: spans as NVTX
ranges, the train step's on-device telemetry, the stall watchdog, the
metric catalog), ``pyprof`` over ``torch.profiler`` and the kernels'
measured dispatch ledger (``kernels.ledger``).
"""
from . import (amp, contrib, fp16_utils, inference, kernels, models,
               multi_tensor_apply, nn, normalization, observe, ops,
               optimizers, parallel, pyprof, runtime, training)

__all__ = ["amp", "contrib", "fp16_utils", "inference", "kernels", "models",
           "multi_tensor_apply", "nn", "normalization", "observe", "ops",
           "optimizers", "parallel", "pyprof", "runtime", "training"]
