"""The one measured train-to-serve weight-movement surface, the PyTorch
counterpart of ``apex_tpu/rollout/publish.py``.

A rollout loop republishes trainer weights into a live
:class:`~apex_tpu_torch.serve.engine.ServeEngine` every few steps.  In the
port both sides hold their tensors where they lie: the fused train step
updates its fp32 masters in place, and the serve engine's programs (on the
card, CUDA graphs captured per bucket) read the serve model's parameters
at their addresses.  So a publish must COPY, into those very parameters:
handing the serve side the masters themselves would serve the next,
unpublished step's values, and rebinding a parameter's ``.data`` would
leave the captured graphs reading the old memory.

Three jobs live here:

* :func:`master_leaves`: a fused train step's fp32 masters in
  ``model.parameters()`` order, without a host round-trip;
* the ``weight_publish`` program: one executor dispatch that copies every
  master into its serve parameter in place (one ``torch._foreach_copy_``,
  which casts where the serve dtype differs), spanned and heartbeat like any other
  forward-progress unit, and on the card captured as one CUDA graph and
  replayed from its third publish on;
* :class:`WeightPublisher`: ties the copy and the engine's epoch stamp
  together and emits the ``rollout.weight_sync`` event with per-leaf
  stats, so "how much did this sync cost" is a measurement.

The JAX publisher hands same-dtype masters to ``reshard_state`` for a
zero-copy alias unless buffer donation is on, and casts only under
donation.  The port's steps always donate (``runtime.executor.donation``),
which is the JAX package's own behaviour under donation: every publish
runs the dispatch (``cast_dispatch`` True), no leaf is zero-copy, and
``bytes_moved`` is the serve parameters' bytes.
"""
from __future__ import annotations

import itertools
import time
from typing import List, Optional

import torch

from .._unported import refuse
from ..observe import registry as _obs
from ..runtime import executor as _executor
from ..runtime.resilience import _flatten, reshard_state

__all__ = ["WeightPublisher", "master_leaves"]

#: per-publisher token in the program's static key: two publishers over
#: identically shaped models never share a cache entry
_PUBLISH_TOKENS = itertools.count()


def master_leaves(step) -> List:
    """A fused train step's fp32 master values, aligned with
    ``model.parameters()`` order: the step's own tensors (no copy), which
    its next call updates in place.  A flat-master step keeps one stack a
    (group, shape, dtype) bucket: each leaf is its row of the stack, a
    view (the JAX package slices the same rows).  A ZeRO step's sharded
    masters are this rank's rows, not the leaves, and are refused."""
    meta = getattr(step, "_flat_meta", None)
    if meta is not None:
        masters = step.state.master_params
        return [masters[bid][j] for bid, j in meta.pos]
    if getattr(step, "_checkpoint_state", None) is not None:
        refuse("rollout.master_leaves of a ZeRO step (its masters are "
               "sharded)", "ROADMAP A9, parallelism beyond single-process "
               "DP")
    return list(step.state.master_params)


def _copy_into(masters, targets):
    """The ``weight_publish`` program: every master into its target in
    place, cast to the target's dtype, as one multi-tensor copy."""
    with torch.no_grad():
        torch._foreach_copy_(targets, masters)


class WeightPublisher:
    """Publish train masters into a live serve engine, measured and
    versioned.

    One publisher per (engine, weight set): ``which="target"`` swaps the
    served model, ``which="draft"`` the speculative draft.  Each
    :meth:`publish` is one ``weight_publish`` executor dispatch that
    copies the masters into the serve parameters in place, then
    ``engine.publish_weights`` stamps the new weight epoch (and flushes
    the prefix cache): no serve program captures again, the graphs read
    the new values where they lie.  The new epoch is returned in the
    stats dict and every later admission is attributed to it."""

    def __init__(self, engine, *, which: str = "target"):
        if which == "draft" and not engine.spec:
            raise ValueError("WeightPublisher(which='draft') needs a "
                             "speculative engine (draft=...)")
        self.engine = engine
        self.which = which
        self._token = next(_PUBLISH_TOKENS)
        model = engine.draft if which == "draft" else engine.model
        self._tgt_params = list(model.parameters())
        self._names = [name for name, _ in _flatten(self._tgt_params)]
        self._program = None
        self._program_ptrs = None
        self.publishes = 0
        self.last_stats: dict = {}

    @property
    def epoch(self) -> int:
        """The weight epoch currently being served for this weight set."""
        return self.engine.weight_epochs[self.which]

    def _check(self, masters):
        if len(masters) != len(self._tgt_params):
            raise ValueError(
                f"publish({self.which!r}): {len(masters)} master leaves "
                f"for {len(self._tgt_params)} serve parameters — "
                f"different model config")
        for i, (m, p) in enumerate(zip(masters, self._tgt_params)):
            if tuple(m.shape) != tuple(p.shape):
                raise ValueError(
                    f"publish({self.which!r}): leaf {i} shape "
                    f"{tuple(m.shape)} != serving shape {tuple(p.shape)}")
            if m.device != p.device:
                raise ValueError(
                    f"publish({self.which!r}): leaf {i} lies on "
                    f"{m.device}, the serve parameter on {p.device}")

    def _publish_program(self, masters):
        """The program for these masters: its graph reads them where they
        lie, so other tensors take a program of their own."""
        ptrs = tuple(m.data_ptr() for m in masters)
        if self._program is None or ptrs != self._program_ptrs:
            dtypes = tuple(str(p.dtype) for p in self._tgt_params)
            self._program = _executor.Program(
                "weight_publish", ("weight_publish", self._token, dtypes,
                                   ptrs), _copy_into, donate_argnums=(0, 1))
            self._program_ptrs = ptrs
        return self._program

    def _stats(self, t0, ep, cast, mode):
        ms = (time.perf_counter() - t0) * 1e3
        n = len(self._tgt_params)
        moved = sum(p.numel() * p.element_size() for p in self._tgt_params)
        stats = {"which": self.which, "epoch": ep, "weight_sync_ms": ms,
                 "cast_dispatch": cast, "leaves": n, "zero_copy": 0,
                 "copied": n, "bytes_moved": moved, "zero_copy_frac": 0.0}
        _obs.event("rollout.weight_sync", **stats)
        _obs.histogram("rollout.weight_sync_ms").observe(ms)
        _obs.gauge("rollout.zero_copy_frac").set(0.0)
        _obs.counter("rollout.publishes").inc()
        stats["per_leaf"] = [(name, mode) for name in self._names]
        self.last_stats = stats
        return stats

    def publish(self, masters, *, epoch: Optional[int] = None) -> dict:
        """Copy the masters into the serve parameters (one
        ``weight_publish`` dispatch) and stamp the epoch.  Returns the
        stats dict (also kept as ``last_stats`` and emitted as a
        ``rollout.weight_sync`` event): epoch, ``weight_sync_ms`` (the
        host's: the copy is enqueued, not waited for), leaf counts, bytes
        moved, and that the dispatch ran."""
        t0 = time.perf_counter()
        masters = list(masters)
        self._check(masters)
        _executor.executor.submit(
            self._publish_program(masters), (masters, self._tgt_params),
            step=self.publishes + 1)
        ep = self.engine.publish_weights(self._tgt_params, which=self.which,
                                         epoch=epoch)
        self.publishes += 1
        return self._stats(t0, ep, True, "device_put")

    def restore(self, leaves, *, epoch: int) -> dict:
        """Republish checkpointed serve weights at their SAVED epoch: the
        resume half of a rollout checkpoint.  ``leaves`` were saved in
        the serve dtype, so nothing is cast: ``reshard_state`` copies
        them into the serve parameters in place (validating each leaf's
        shape and dtype) and the engine stamps the saved epoch."""
        t0 = time.perf_counter()
        reshard_state(list(leaves), self._tgt_params,
                      component=f"publish/{self.which}",
                      source="<checkpoint>")
        ep = self.engine.publish_weights(self._tgt_params, which=self.which,
                                         epoch=epoch)
        self.publishes += 1
        return self._stats(t0, ep, False, "host")
