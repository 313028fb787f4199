"""apex_tpu_torch.pyprof: profiling and op-level performance analysis, the
PyTorch counterpart of ``apex_tpu/pyprof`` (reference: apex/pyprof).

The reference's three stages, on the card:

1. ``pyprof.nvtx.init()`` + ``pyprof.capture()``: record each op the port
   runs (annotate.py), with shapes, dtypes, params, scope and call site, in
   a ``pp<seq>_<op>`` ``torch.profiler`` range while a profiler records.
2. ``python -m apex_tpu_torch.pyprof.parse run.jsonl [--trace TRACE] >
   net.dict``: enrich the op log (stable seq ids, the backward rows
   synthesised) and, with ``--trace``, join a ``torch.profiler`` Chrome
   trace's kernel times onto the rows (parse/trace.py).
3. ``python -m apex_tpu_torch.pyprof.prof net.dict``: per-op FLOPs, bytes,
   arithmetic intensity, tensor-core eligibility (the ``mxu`` column) and a
   roofline estimate against the H100's published peaks (prof/).

One call does all three over one step: :func:`profile_step`.
"""
from __future__ import annotations

import contextlib
import json

from . import annotate
from . import nvtx  # noqa: F401


@contextlib.contextmanager
def capture(clear: bool = True):
    """Enable recording for a scope; yields the (live) event list."""
    annotate.init()
    if clear:
        annotate.clear()
    annotate.set_enabled(True)
    try:
        yield annotate.events()
    finally:
        annotate.set_enabled(False)


def save(path: str, events=None):
    """Write captured events as JSON lines (the input of
    ``python -m apex_tpu_torch.pyprof.parse``)."""
    events = events if events is not None else annotate.events()
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return path


def profile_step(fn, *args, trace_dir=None, executions: int = 3,
                 with_backward: bool = True, analyze_output: bool = True):
    """Measured profile of one eager step: record its ops, run it
    ``executions`` times under ``torch.profiler``, join the card's kernels
    to the ops (parse/trace.py) and apply the prof-stage models.

    Returns ``(rows, report)``: rows carry the analytic columns and the
    measured ``meas_us``; report holds the join's statistics (matched and
    unattributed time, the unattributed time by name, dropped launches,
    the kernel wrappers' launch counts)."""
    from .parse.trace import profile_step as _ps
    rows, report = _ps(fn, *args, trace_dir=trace_dir,
                       executions=executions, with_backward=with_backward)
    if analyze_output:
        from .prof.prof import analyze_rows
        rows = analyze_rows(rows)
    return rows, report


def analyze(events=None, with_backward: bool = True):
    """events -> analyzed rows (parse + prof stages fused, in process)."""
    from .parse.parse import enrich
    from .prof.prof import analyze_rows
    events = events if events is not None else annotate.events()
    return analyze_rows(enrich(events, with_backward=with_backward))


_thunk_capability = None


def thunk_events_available() -> bool:
    """Whether ``torch.profiler`` gives device kernel events here (the JAX
    probe's name, kept): True on the card where CUPTI traces, False on the
    CPU.  Probed once (a small product under the profiler) and cached;
    any failure counts as "not available"."""
    global _thunk_capability
    if _thunk_capability is None:
        _thunk_capability = _probe_kernel_events()
    return _thunk_capability


def _probe_kernel_events() -> bool:
    import torch
    if not torch.cuda.is_available():
        return False
    from torch.profiler import ProfilerActivity, profile
    try:
        x = torch.ones((64, 64), device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (x @ x).sum()
            torch.cuda.synchronize()
        return any(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.events())
    except RuntimeError:
        return False


__all__ = ["annotate", "nvtx", "capture", "save", "analyze",
           "thunk_events_available", "profile_step"]
