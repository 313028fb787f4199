"""apex_tpu_torch.observe: the port's unified trace and metrics runtime,
the PyTorch counterpart of ``apex_tpu/observe/``.

- :mod:`registry`: thread-safe counters, gauges, histograms and a
  structured JSONL event log (schema-versioned, monotonic timestamps).
- :mod:`spans`: ``span("ckpt.save")``, emitting the event log, an NVTX
  range on the card and a ``torch.profiler`` range while one records.
- :mod:`telemetry`: the on-device step accumulator carried in
  ``StepState.telem``, pure torch ops that a CUDA graph captures.
- :mod:`watchdog`: a heartbeat thread firing a typed stall diagnostic.
- :mod:`catalog`: the documented name -> meaning table.

Everything except :mod:`telemetry` is host-side only and never runs
inside a captured graph.
"""
from .catalog import CATALOG, describe
from .catalog import names as catalog_names
from .registry import (SCHEMA_VERSION, Counter, Gauge, Histogram,
                       MetricsRegistry, counter, event, events, gauge,
                       get_registry, histogram)
from .spans import last_span, span
from .telemetry import StepTelemetry, accumulate, init_telemetry
from .watchdog import STALL_HINT, StallWatchdog, heartbeat, last_heartbeat

__all__ = [
    "SCHEMA_VERSION", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "event", "events", "get_registry",
    "span", "last_span",
    "StepTelemetry", "init_telemetry", "accumulate",
    "StallWatchdog", "heartbeat", "last_heartbeat", "STALL_HINT",
    "CATALOG", "describe", "catalog_names",
]
