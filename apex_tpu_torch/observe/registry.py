"""Metrics registry + structured event log, the port's copy of
``apex_tpu/observe/registry.py`` (the same names, metric kinds, event
records and ``snapshot()`` schema; host-only, no JAX in it).

One process-global choke point for the numbers the port reports: the
serve engine's request lifecycle events, its gauges (queue depth, pool
occupancy, prefix-cache and speculative rates) and its latency
histograms, the step cache's counters, the chaos firings, spans, the
train step's drained telemetry and the kernels' dispatch decisions.

Design constraints:

- **Thread-safe.** Writers on other threads (a prefetch worker, an async
  checkpoint writer) may emit concurrently.
- **Host-side only.** Nothing here may run inside a captured CUDA graph:
  every entry point touches a lock and Python containers, which a replay
  would never run.
- **Cheap.** A counter bump is a dict lookup + integer add under an
  RLock; no I/O unless a JSONL sink is attached.
- **Monotonic timestamps.** Event records carry `ts_ms` from
  `time.monotonic()` so ordering survives wall-clock steps (NTP slew
  on long runs); sinks that need wall time can add their own.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

_EVENT_BUFFER_MAX = 4096


class Counter:
    """Monotonically increasing integer metric."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar metric."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        return self._value


class Histogram:
    """Streaming summary: count / total / min / max / last.

    Full per-sample retention belongs in the event log (attach a JSONL
    sink); the in-memory histogram keeps O(1) state so hot paths like
    per-step latencies never grow memory.
    """

    __slots__ = ("name", "count", "total", "min", "max", "last", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.last: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            self.last = value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"count": self.count, "total": self.total,
                    "mean": self.mean, "min": self.min, "max": self.max,
                    "last": self.last}


class MetricsRegistry:
    """Named metrics plus a bounded structured event log.

    Events are dicts `{"schema": 1, "ts_ms": <monotonic ms>,
    "event": <name>, ...fields}`; the newest `_EVENT_BUFFER_MAX` are
    kept in memory and every event is appended to any attached JSONL
    sinks as one line.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._events: collections.deque = collections.deque(
            maxlen=_EVENT_BUFFER_MAX)
        self._sinks: Dict[str, Any] = {}   # path -> open file handle

    # -- metric accessors (create-on-first-use) ---------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    # -- events ------------------------------------------------------------

    def event(self, name: str, **fields: Any) -> Dict[str, Any]:
        rec = {"schema": SCHEMA_VERSION,
               "ts_ms": time.monotonic() * 1e3,
               "event": name}
        rec.update(fields)
        with self._lock:
            self._events.append(rec)
            sinks = list(self._sinks.values())
        for fh in sinks:
            try:
                fh.write(json.dumps(rec, default=str) + "\n")
                fh.flush()
            except (OSError, ValueError):
                pass   # a dead sink must never take down the serve loop
        return rec

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if name is None:
            return evs
        return [e for e in evs if e["event"] == name]

    def add_jsonl_sink(self, path: str) -> None:
        with self._lock:
            if path not in self._sinks:
                self._sinks[path] = open(path, "a")

    def remove_jsonl_sink(self, path: str) -> None:
        with self._lock:
            fh = self._sinks.pop(path, None)
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    # -- introspection / reset ---------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of every metric (events excluded — use
        ``events()``)."""
        with self._lock:
            return {
                "schema": SCHEMA_VERSION,
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }

    def remove(self, prefix: str) -> None:
        """Drop every metric whose name starts with ``prefix``.

        Lets a subsystem reset its slice (``step_cache.reset_stats()``)
        without clobbering unrelated metrics.
        """
        with self._lock:
            for table in (self._counters, self._gauges, self._histograms):
                for name in [n for n in table if n.startswith(prefix)]:
                    del table[name]

    def clear_events(self) -> None:
        with self._lock:
            self._events.clear()

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._events.clear()


# -- process-global default registry ---------------------------------------

_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default


def counter(name: str) -> Counter:
    return _default.counter(name)


def gauge(name: str) -> Gauge:
    return _default.gauge(name)


def histogram(name: str) -> Histogram:
    return _default.histogram(name)


def event(name: str, **fields: Any) -> Dict[str, Any]:
    return _default.event(name, **fields)


def events(name: Optional[str] = None) -> List[Dict[str, Any]]:
    return _default.events(name)
