"""The step-program cache and its counters, the PyTorch counterpart of
``apex_tpu/runtime/step_cache.py``.

A key is ``(kind, static_key, signature(args))``: the signature is each
tensor leaf's shape, dtype, device and strides (so a new memory format is a
new entry) and every other leaf's value.  Where the JAX package compiles
one XLA program a key, the port captures one CUDA graph a key
(:mod:`.executor`): a "compile" is the first call of a key, after which the
card captures the step on its second call and replays it from then on.

An entry must not outlive the step that built it: a captured graph pins a
private memory pool holding a whole step's activations.  So the cache keeps
only a weak reference to each entry, which the program it was built for
holds (and with it the step); the LRU cap bounds the counters' keys, not
the card's memory.  The counters live in the observe registry under the
JAX names (``step_cache.<counter>``, ``step_cache.kind.<kind>.<counter>``);
:meth:`StepCache.stats` rebuilds the JAX dict from them.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict

import torch
from torch.utils._pytree import tree_flatten

from ..observe import registry as _obs

#: opt-in ``span("dispatch")`` around every dispatch of an eager kind (the
#: train, serve and rollout kinds always span).  Off by default: the eager
#: optimizer and amp dispatches are many small host calls, and a span
#: event each would be a measurable share of them; the counters always
#: flow through the registry.
_DISPATCH_SPANS = False


def set_dispatch_spans(enable: bool) -> None:
    """Enable/disable ``span("dispatch")`` around eager cache dispatches."""
    global _DISPATCH_SPANS
    _DISPATCH_SPANS = bool(enable)


def _leaf_sig(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, str(leaf.device),
                tuple(leaf.stride()))
    if isinstance(leaf, (int, float, bool, str, type(None))):
        return leaf
    return type(leaf).__name__


def signature(tree):
    """Hashable key of an argument tree: its structure and each leaf's
    shape, dtype, device and strides (a tensor) or value."""
    leaves, spec = tree_flatten(tree)
    return (str(spec), tuple(_leaf_sig(l) for l in leaves))


class StepCache:
    """Program cache with compile/dispatch counters: one entry per (kind,
    static config, argument signature), LRU-capped, each entry held
    weakly (see the module docstring)."""

    _TOP_COUNTERS = ("compiles", "cache_hits", "dispatches",
                     "multi_tensor_calls")
    _KIND_COUNTERS = ("compiles", "cache_hits", "dispatches")

    def __init__(self, cap: int = 128, metrics_prefix: str = "step_cache."):
        self._cap = cap
        self._prefix = metrics_prefix
        self._registry = _obs.get_registry()
        self._lock = threading.RLock()
        self._programs: OrderedDict = OrderedDict()
        self.reset_stats()

    def reset_stats(self):
        self._registry.remove(self._prefix)

    def _bump(self, name, kind=None):
        self._registry.counter(self._prefix + name).inc()
        if kind is not None:
            self._registry.counter(
                f"{self._prefix}kind.{kind}.{name}").inc()

    def stats(self) -> dict:
        """The JAX dict: ``compiles`` (a new key), ``cache_hits``,
        ``dispatches`` (one a step call), ``multi_tensor_calls`` (eager
        multi-tensor op calls), ``programs`` (live keys) and ``by_kind``,
        read from the registry's counters."""
        counters = self._registry.snapshot()["counters"]
        out = {n: counters.get(self._prefix + n, 0)
               for n in self._TOP_COUNTERS}
        by_kind: dict = {}
        kind_prefix = self._prefix + "kind."
        for full, value in counters.items():
            if not full.startswith(kind_prefix):
                continue
            kind, _, cname = full[len(kind_prefix):].rpartition(".")
            if kind and cname in self._KIND_COUNTERS:
                by_kind.setdefault(
                    kind, dict.fromkeys(self._KIND_COUNTERS, 0))[cname] = \
                    value
        with self._lock:
            out["programs"] = len(self._programs)
        out["by_kind"] = by_kind
        return out

    def program(self, kind: str, static_key, args, build):
        """The entry for ``args``: a hit where the key's entry is still
        alive, else ``build()`` (counted as a compile).  ``static_key``
        captures every Python value the program closes over; ``build``
        returns an object that its program keeps alive."""
        key = (kind, static_key, signature(args))
        with self._lock:
            ref = self._programs.pop(key, None)
            entry = None if ref is None else ref()
            if entry is not None:
                self._programs[key] = ref       # pop + reinsert = LRU
                self._bump("cache_hits", kind)
                return entry
        entry = build()
        with self._lock:
            while len(self._programs) >= self._cap:
                self._programs.popitem(last=False)
            self._programs[key] = weakref.ref(entry)
            self._bump("compiles", kind)
        return entry

    def entries(self):
        """The live entries, oldest first."""
        with self._lock:
            return [e for e in (r() for r in self._programs.values())
                    if e is not None]

    def clear(self):
        with self._lock:
            self._programs.clear()


#: process-global cache shared by every step
step_cache = StepCache()


def stats() -> dict:
    return step_cache.stats()


def kind_stats(kind: str) -> dict:
    """One kind's ``{compiles, cache_hits, dispatches}`` (zeros if the kind
    never dispatched)."""
    return stats()["by_kind"].get(
        kind, dict.fromkeys(StepCache._KIND_COUNTERS, 0))


def reset_stats():
    step_cache.reset_stats()


def clear():
    step_cache.clear()


def record_multi_tensor_call():
    step_cache._bump("multi_tensor_calls")
