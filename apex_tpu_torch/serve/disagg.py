"""DisaggregatedEngine: prefill/decode phase split over two engines, the
PyTorch counterpart of ``apex_tpu/serve/disagg.py``.

Prefill is one big compute-bound batched matmul over the prompt; decode
re-reads the whole KV cache per emitted token and is bound by memory
bandwidth.  A unified engine time-slices both on the same device, and a
long prompt's prefill chunk stretches every resident session's
inter-token latency.  Disaggregated serving (DistServe, Splitwise)
dedicates one engine per phase and moves each request's KV state from the
prefill engine's pool to the decode engine's pool exactly once, when its
first token is out.

This coordinator wires two :class:`~apex_tpu_torch.serve.engine.
ServeEngine` instances (``phase="prefill"``, which stops before the decode
stage, and ``phase="decode"``, whose prefill slot serves recompute
re-admissions after local preemption and draft catch-up in speculative
mode) through the schema-3 KV handoff of
:mod:`apex_tpu_torch.runtime.resilience`:

1. the prefill engine ingests prompt chunks and emits each request's
   first token (TTFT is measured there; the handoff is off its path);
2. :func:`~apex_tpu_torch.runtime.resilience.stream_kv_handoff` streams
   the finished session's KV blocks to per-block files (one block's bytes
   on the host at a time), manifest last;
3. the decode engine adopts the session
   (:meth:`~apex_tpu_torch.serve.engine.ServeEngine.ingest_handoff`),
   copying the streamed blocks into its own pool verbatim, so the
   handed-off continuation is the unified engine's.

A chaos-injected stream failure
(:class:`~apex_tpu_torch.runtime.chaos.ChaosInjectedFailure`) discards the
partial handoff directory and re-streams once (the blocks are still
resident on the prefill engine until ``release``);
:class:`~apex_tpu_torch.runtime.chaos.ChaosKilled` is never caught.  A
decode engine with no free slot/blocks leaves the handoff pending; the
coordinator retries ingest every tick while the prefill engine keeps
serving.  Both engines run on the model's device.
"""
from __future__ import annotations

import itertools
import os
import re
import tempfile
from typing import Dict, List, Sequence

from .._unported import refuse
from ..observe import registry as _obs
from ..runtime.chaos import ChaosInjectedFailure
from ..runtime.resilience import discard_kv_handoff, stream_kv_handoff
from .engine import ServeEngine, run_trace
from .scheduler import Request

__all__ = ["DisaggregatedEngine", "PendingHandoff"]


class PendingHandoff:
    """One streamed-but-not-yet-ingested session: everything the decode
    engine needs to adopt it, plus the shard directory holding its KV
    blocks."""

    __slots__ = ("request", "out", "pending_tok", "position", "dir",
                 "t_queued", "t_first", "hash_chain", "weight_epoch")

    def __init__(self, request, out, pending_tok, position, dir_path,
                 t_queued, t_first, hash_chain=(), weight_epoch=-1):
        self.request = request
        self.out = list(out)
        self.pending_tok = pending_tok
        self.position = position
        self.dir = dir_path
        self.t_queued = t_queued
        self.t_first = t_first
        self.hash_chain = list(hash_chain)
        self.weight_epoch = weight_epoch


class DisaggregatedEngine:
    """Two-engine prefill/decode deployment with streamed KV handoff.

    ``prefill_blocks`` / ``decode_blocks`` size each engine's pool
    (default: ``num_blocks`` each, disjoint pools; the JAX package's
    ``parallel.auto.plan_serve_phase_split``, which picks a device split,
    is ROADMAP A9).  Speculative decoding (``draft=...``) is a
    decode-engine mode: the prefill engine never sees the draft.
    ``handoff_dir`` hosts the per-session shard directories (a temp
    dir by default)."""

    def __init__(self, model, *, num_blocks, block_size=16, max_batch=8,
                 prefill_chunk=32, cache_dtype=None, window=None,
                 prefill_blocks=None, decode_blocks=None,
                 handoff_dir=None, draft=None, spec_k=4,
                 draft_cache_dtype="int8", spec_policy="on",
                 prefix_cache=True):
        if window is not None:
            raise NotImplementedError(
                "disaggregated serving + sliding window: handoff after "
                "block retirement would stream a table with NULL holes "
                "— serve windowed models unified for now")
        self.prefill = ServeEngine(
            model, num_blocks=prefill_blocks or num_blocks,
            block_size=block_size, max_batch=max_batch,
            prefill_chunk=prefill_chunk, cache_dtype=cache_dtype,
            phase="prefill", prefix_cache=prefix_cache)
        self.decode = ServeEngine(
            model, num_blocks=decode_blocks or num_blocks,
            block_size=block_size, max_batch=max_batch,
            prefill_chunk=prefill_chunk, cache_dtype=cache_dtype,
            phase="decode", draft=draft, spec_k=spec_k,
            draft_cache_dtype=draft_cache_dtype,
            spec_policy=spec_policy, prefix_cache=prefix_cache)
        self.spec = self.decode.spec
        if handoff_dir is None:
            handoff_dir = tempfile.mkdtemp(prefix="apex_kv_handoff_")
        self.handoff_dir = handoff_dir
        self.pending: List[PendingHandoff] = []
        self._tick = 0
        self._handoff_no = itertools.count()
        self._handoffs = 0
        self._handoff_retries = 0
        self._handoff_peak = 0

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Queue a request on the prefill engine.  Decode-side position
        budgets (speculative slack) are validated NOW — the prefill
        engine's own budget has no slack, and a request that can never
        land on the decode engine must be rejected at the door, not
        after its prefill is paid for."""
        need = len(request.prompt) + request.max_new_tokens \
            + self.decode.scheduler.pos_slack
        if need > self.decode.scheduler.max_positions:
            raise ValueError(
                f"request {request.rid}: {need} positions (incl. "
                f"speculative slack {self.decode.scheduler.pos_slack}) "
                f"exceed decode max_positions "
                f"{self.decode.scheduler.max_positions}")
        self.prefill.submit(request)

    # -- the tick ----------------------------------------------------------

    def _stream_out(self, s) -> PendingHandoff:
        tag = re.sub(r"[^A-Za-z0-9_.-]", "_", s.rid)
        d = os.path.join(self.handoff_dir,
                         f"h{next(self._handoff_no)}_{tag}")
        try:
            _meta, peak = stream_kv_handoff(
                d, self.prefill.pool, s.table, source=f"handoff:{s.rid}")
        except ChaosInjectedFailure:
            # recoverable stream fault: the blocks are still resident on
            # the prefill engine — drop the partial directory and
            # re-stream once (a second fault propagates)
            self._handoff_retries += 1
            _obs.counter("serve.handoff.retries").inc()
            discard_kv_handoff(d)
            _meta, peak = stream_kv_handoff(
                d, self.prefill.pool, s.table, source=f"handoff:{s.rid}")
        self._handoffs += 1
        self._handoff_peak = max(self._handoff_peak, peak)
        _obs.counter("serve.handoff.count").inc()
        _obs.gauge("serve.handoff.bytes_peak_host").set(
            self._handoff_peak)
        _obs.event("serve.request", rid=s.rid, phase="handoff",
                   tick=self._tick, blocks=len(s.table), peak_bytes=peak)
        return PendingHandoff(s.request, s.out, s.pending_tok,
                              s.position, d, s.t_queued, s.t_first,
                              hash_chain=s.hash_chain,
                              weight_epoch=s.weight_epoch)

    def step(self) -> bool:
        """One coordinator tick: prefill tick → stream completed
        prefills out → ingest pending handoffs into the decode engine
        (whatever fits; the rest stay pending) → decode tick.  Returns
        True while any engine or the handoff queue has work."""
        self._tick += 1
        self.prefill.step()
        for s in self.prefill.harvest_ready():
            self.pending.append(self._stream_out(s))
            self.prefill.release_handoff(s)
        still: List[PendingHandoff] = []
        for h in self.pending:
            sess = self.decode.ingest_handoff(
                h.request, out=h.out, pending_tok=h.pending_tok,
                position=h.position, handoff_dir=h.dir,
                t_queued=h.t_queued, t_first=h.t_first,
                hash_chain=h.hash_chain, weight_epoch=h.weight_epoch)
            if sess is None:
                still.append(h)      # decode engine full: retry next tick
            else:
                discard_kv_handoff(h.dir)
        self.pending = still
        _obs.gauge("serve.handoff.pending").set(len(self.pending))
        self.decode.step()
        return self.prefill.scheduler.has_work() or bool(self.pending) \
            or self.decode.scheduler.has_work()

    def run(self, requests: Sequence[Request], arrivals=None,
            watchdog_deadline_s=None, max_ticks=None):
        """Serve ``requests`` to completion; returns ``{rid: tokens}``
        merged from both engines (a request that finishes at its first
        token never leaves the prefill engine).  ``watchdog_deadline_s``
        is ROADMAP A8 and refused."""
        if watchdog_deadline_s is not None:
            refuse("DisaggregatedEngine.run(watchdog_deadline_s=...), the "
                   "stall watchdog", "ROADMAP A8, observe/")
        return run_trace(self, requests, arrivals, max_ticks)

    # -- introspection -----------------------------------------------------

    @property
    def tick(self) -> int:
        return self._tick

    @property
    def results(self) -> Dict[str, List[int]]:
        merged = dict(self.prefill.results)
        merged.update(self.decode.results)
        return merged

    def metrics(self) -> dict:
        return {
            "prefill": self.prefill.metrics(),
            "decode": self.decode.metrics(),
            "handoff": {
                "count": self._handoffs,
                "retries": self._handoff_retries,
                "pending": len(self.pending),
                "bytes_peak_host": self._handoff_peak,
            },
        }
