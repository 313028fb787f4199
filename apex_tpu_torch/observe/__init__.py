"""apex_tpu_torch.observe: the metrics registry and event log
(:mod:`.registry`), the port's copy of ``apex_tpu/observe/registry.py``.

The JAX package's other observe modules (``spans``, the on-device
``telemetry`` carry, the stall ``watchdog`` and the metric ``catalog``)
are ROADMAP A8: their names are here and refuse.
"""
from .._unported import refuse
from .registry import (SCHEMA_VERSION, Counter, Gauge, Histogram,
                       MetricsRegistry, counter, event, events, gauge,
                       get_registry, histogram)

A8 = "ROADMAP A8, observe/"


def _refused(name, module):
    def call(*args, **kwargs):
        refuse(f"observe.{name} ({module})", A8)
    call.__name__ = call.__qualname__ = name
    return call


span = _refused("span", "spans")
last_span = _refused("last_span", "spans")
StepTelemetry = _refused("StepTelemetry", "telemetry")
init_telemetry = _refused("init_telemetry", "telemetry")
accumulate = _refused("accumulate", "telemetry")
StallWatchdog = _refused("StallWatchdog", "watchdog")
heartbeat = _refused("heartbeat", "watchdog")
last_heartbeat = _refused("last_heartbeat", "watchdog")
describe = _refused("describe", "catalog")
catalog_names = _refused("catalog_names", "catalog")

_CONSTANTS = {"CATALOG": "catalog", "STALL_HINT": "watchdog"}


def __getattr__(name):
    if name in _CONSTANTS:
        refuse(f"observe.{name} ({_CONSTANTS[name]})", A8)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "SCHEMA_VERSION", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "event", "events", "get_registry",
    "span", "last_span",
    "StepTelemetry", "init_telemetry", "accumulate",
    "StallWatchdog", "heartbeat", "last_heartbeat",
    "describe", "catalog_names",
]
