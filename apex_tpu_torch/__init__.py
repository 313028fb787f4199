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
through the LayerNorm forward kernel), inference only.
"""
from . import contrib, inference, kernels, models, normalization

__all__ = ["contrib", "inference", "kernels", "models", "normalization"]
