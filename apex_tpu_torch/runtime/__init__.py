"""apex_tpu_torch.runtime: the step cache, the executor that captures and
replays the train steps as CUDA graphs, and the input prefetcher, the
PyTorch counterparts of their namesakes in ``apex_tpu/runtime``.

  DataPrefetcher   — apex_tpu_torch.runtime.data
  step_cache       — the program cache and its counters
  executor         — the one place that captures and replays a CUDA graph
                     (Executor, Program, set_overlap, overlap_enabled)

The JAX package's native host runtime (``csrc/runtime.cpp``: flatten,
normalize, bf16 casts), ``chaos``, ``resilience`` and ``elastic`` are not
ported (ROADMAP A7).
"""
from __future__ import annotations

from .data import DataPrefetcher
from . import step_cache
from . import executor
from .executor import Executor, Program, set_overlap, overlap_enabled

__all__ = ["DataPrefetcher", "step_cache", "executor", "Executor",
           "Program", "set_overlap", "overlap_enabled"]
