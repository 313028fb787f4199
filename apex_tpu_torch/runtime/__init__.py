"""apex_tpu_torch.runtime: the native host runtime, the step cache, the
executor that captures and replays the train steps as CUDA graphs, the
input prefetcher, fault injection and the resilience runtime, the PyTorch
counterparts of their namesakes in ``apex_tpu/runtime``.

  flatten(arrays) / unflatten(flat, like)   — bucket coalescing (apex_C)
  normalize_u8_nhwc_to_f32_nchw(...)        — fused decode-side normalize
  normalize_u8_nhwc_to_f32_nhwc(...)        — the same, channels-last
  f32_to_bf16(x)                            — bulk host cast (RNE), a
                                              ``torch.bfloat16`` tensor
  available()                               — True when the library loads
  DataPrefetcher   — apex_tpu_torch.runtime.data
  step_cache       — the program cache and its counters
  executor         — the one place that captures and replays a CUDA graph
                     (Executor, Program, set_overlap, overlap_enabled)
  chaos            — deterministic fault injection
  resilience       — atomic and async checkpoints in the JAX package's
                     schema-3 format (either package restores the other's
                     shard files), CheckpointManager, BadStepGuard

The host functions are ``csrc/runtime.cpp`` (the port's copy of the JAX
package's host C++), built with ``g++`` at first use into
``build/apex_tpu_torch/`` (``_build.load_host``) and called through
``ctypes``; a failed build raises (the JAX module's quiet numpy path is
not copied).  ``elastic`` refuses, naming ROADMAP A9: its restore re-plans
through ``parallel.auto``, which the port has not yet.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

_lock = threading.Lock()
_lib = None


def _get():
    """The host runtime's library, built and typed at the first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                from .. import _build
                lib = _build.load_host("runtime")
                lib.apex_flatten.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int]
                lib.apex_unflatten.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_int]
                for nrm in ("apex_normalize_u8_nhwc_to_f32_nchw",
                            "apex_normalize_u8_nhwc_to_f32_nhwc"):
                    getattr(lib, nrm).argtypes = [
                        ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int64,
                        ctypes.POINTER(ctypes.c_float),
                        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
                lib.apex_f32_to_bf16.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int]
                _lib = lib
    return _lib


def available() -> bool:
    """True when the host runtime's library is (or can be) built and
    loaded; the functions below raise where it cannot."""
    try:
        _get()
    except (OSError, RuntimeError):
        return False
    return True


def _as_contig(a):
    return np.ascontiguousarray(a)


def flatten(arrays, out=None, threads: int = 0):
    """Coalesce a list of same-dtype arrays into one flat 1-d numpy array
    (apex_C.flatten)."""
    arrays = [_as_contig(np.asarray(a)) for a in arrays]
    if not arrays:
        return np.empty((0,), np.float32)
    dtype = arrays[0].dtype
    if any(a.dtype != dtype for a in arrays):
        raise TypeError(
            "flatten: all arrays must share a dtype (bucket per dtype, "
            "reference split_half_float_double)")
    total = sum(a.size for a in arrays)
    if out is None:
        out = np.empty((total,), dtype)
    elif out.size != total or out.dtype != dtype:
        raise ValueError("flatten: bad out buffer")
    elif not out.flags["C_CONTIGUOUS"]:
        raise ValueError("flatten: out buffer must be C-contiguous")
    lib = _get()
    n = len(arrays)
    srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    nbytes = (ctypes.c_int64 * n)(*[a.nbytes for a in arrays])
    lib.apex_flatten(srcs, nbytes, n, out.ctypes.data, threads)
    return out


def unflatten(flat, like, threads: int = 0):
    """Split a flat array back into numpy arrays shaped like ``like``
    (apex_C.unflatten)."""
    flat = _as_contig(np.asarray(flat))
    outs = [np.empty(np.shape(t), flat.dtype) for t in like]
    total = sum(o.size for o in outs)
    if flat.size != total:
        raise ValueError(
            f"unflatten: flat has {flat.size} elements, targets need {total}")
    lib = _get()
    n = len(outs)
    dsts = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    nbytes = (ctypes.c_int64 * n)(*[o.nbytes for o in outs])
    lib.apex_unflatten(flat.ctypes.data, dsts, nbytes, n, threads)
    return outs


def _normalize(fn, batch, mean, std, threads, out_shape):
    batch = _as_contig(np.asarray(batch, np.uint8))
    n, h, w, c = batch.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"mean/std must have shape ({c},)")
    out = np.empty(out_shape(n, h, w, c), np.float32)
    getattr(_get(), fn)(
        batch.ctypes.data, out.ctypes.data, n, h, w, c,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    return out


def normalize_u8_nhwc_to_f32_nchw(batch, mean, std, threads: int = 0):
    """uint8 (N,H,W,C) -> float32 (N,C,H,W), (x/255 - mean)/std fused: the
    prefetcher's per-batch byte work on the host."""
    return _normalize("apex_normalize_u8_nhwc_to_f32_nchw", batch, mean,
                      std, threads, lambda n, h, w, c: (n, c, h, w))


def normalize_u8_nhwc_to_f32_nhwc(batch, mean, std, threads: int = 0):
    """uint8 (N,H,W,C) -> float32 (N,H,W,C), (x/255 - mean)/std fused,
    layout-preserving (the input path of channels-last models)."""
    return _normalize("apex_normalize_u8_nhwc_to_f32_nhwc", batch, mean,
                      std, threads, lambda n, h, w, c: (n, h, w, c))


def f32_to_bf16(x, threads: int = 0) -> torch.Tensor:
    """Bulk float32 -> bfloat16 (round to nearest even) on the host, as a
    CPU ``torch.bfloat16`` tensor."""
    x = _as_contig(np.asarray(x, np.float32))
    out = torch.empty(x.shape, dtype=torch.bfloat16)
    _get().apex_f32_to_bf16(x.ctypes.data, out.data_ptr(), x.size, threads)
    return out


from .data import DataPrefetcher  # noqa: E402
from . import step_cache  # noqa: E402
from . import executor  # noqa: E402
from .executor import (  # noqa: E402
    Executor, Program, set_overlap, overlap_enabled)
from . import chaos  # noqa: E402
from . import resilience  # noqa: E402
from .resilience import (  # noqa: E402
    BadStepGuard, CheckpointCorruptError, CheckpointManager,
    CheckpointReshardError, SaveHandle, TrainingDivergedError)
from . import elastic  # noqa: E402
from .elastic import (  # noqa: E402
    ElasticTrainer, current_devices, elastic_restore)

__all__ = ["flatten", "unflatten", "normalize_u8_nhwc_to_f32_nchw",
           "normalize_u8_nhwc_to_f32_nhwc", "f32_to_bf16", "available",
           "DataPrefetcher", "step_cache", "executor", "Executor",
           "Program", "set_overlap", "overlap_enabled", "chaos",
           "resilience", "CheckpointManager", "CheckpointCorruptError",
           "SaveHandle", "BadStepGuard", "TrainingDivergedError", "elastic",
           "CheckpointReshardError", "ElasticTrainer", "elastic_restore",
           "current_devices"]
