"""Trace spans: one context manager, three outputs, the port's copy of
``apex_tpu/observe/spans.py``.

``span("ckpt.save")`` emits (a) a structured ``span`` event and a
``span.<name>_ms`` histogram sample into the metrics registry, (b) an NVTX
range where CUDA is present, so the region shows on the card's timeline
in any NVTX-aware tool, and (c) while a ``torch.profiler`` session is
recording, a ``record_function(name)`` range, so host events and the
profiler's trace line up by name.  These take the place of the JAX
package's ``jax.profiler.TraceAnnotation``.  The profiler range is opened
only while a profiler is on: with none on, ``record_function`` still costs
a handle on every span (PERF.md gives its cost beside the span's), and
the range would go nowhere.  Where neither CUDA nor a profiler is there,
a span is log-only.

Spans are host-side instrumentation; nothing of a span runs inside a
captured CUDA graph (a replay runs no Python).  Thread-safe: the prefetch
worker and the async checkpoint writer open spans on their own threads,
and the watchdog reads ``last_span()`` from its thread.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Optional

import torch

from . import registry as _registry

_state_lock = threading.Lock()
_last_span: Optional[Dict[str, Any]] = None

_nvtx = [None]          # torch.cuda.nvtx where CUDA is present, else False


def _nvtx_module():
    """``torch.cuda.nvtx`` where CUDA is present, else None (probed once:
    a CPU build of torch has no NVTX functions)."""
    if _nvtx[0] is None:
        _nvtx[0] = torch.cuda.nvtx if torch.cuda.is_available() else False
    return _nvtx[0] or None


def _profiling() -> bool:
    return bool(torch.autograd.profiler._is_profiler_enabled)


def last_span() -> Optional[Dict[str, Any]]:
    """Most recently *started* span (it may still be open): the stall
    watchdog reports this as "where the runtime was last seen"."""
    with _state_lock:
        return dict(_last_span) if _last_span else None


@contextlib.contextmanager
def span(name: str, **fields: Any):
    """Time a region; emit a ``span`` event and a ``span.<name>_ms``
    histogram sample on exit, inside an NVTX range (CUDA) and a profiler
    range (while a profiler records)."""
    global _last_span
    t0 = time.monotonic()
    with _state_lock:
        _last_span = {"span": name, "started_ms": t0 * 1e3, **fields}
    nvtx = _nvtx_module()
    cm = torch.profiler.record_function(name) if _profiling() \
        else contextlib.nullcontext()
    if nvtx is not None:
        nvtx.range_push(name)
    try:
        with cm:
            yield
    finally:
        if nvtx is not None:
            nvtx.range_pop()
        dur_ms = (time.monotonic() - t0) * 1e3
        _registry.histogram(f"span.{name}_ms").observe(dur_ms)
        _registry.event("span", span=name, dur_ms=dur_ms, **fields)
