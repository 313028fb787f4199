"""ServeFleet: membership-backed elastic serving with live migration,
the PyTorch counterpart of ``apex_tpu/serve/elastic.py``.

A fleet of replicated :class:`~apex_tpu_torch.serve.engine.ServeEngine`
instances (each one's programs CUDA graphs a bucket on the card, all over
one shared model) registers in the cluster membership view: each replica
is a :class:`~apex_tpu_torch.cluster.membership.Member` heartbeating into
the shared KV store, one :class:`~apex_tpu_torch.cluster.coordinator.
Coordinator` condenses heartbeats into epoch-numbered views, and a
thin front-end routes, snapshots, and re-homes sessions so that a
replica dying mid-decode is a latency blip, not a lost request:

* **Session snapshots** (periodic, every ``snapshot_every`` fleet
  ticks): each live DECODE session's KV blocks stream to shared
  storage through the schema-3
  :func:`~apex_tpu_torch.runtime.resilience.stream_kv_handoff` path:
  one block's bytes on host at a time, CRC per file, manifest commits
  LAST.  A session's full blocks never change while it stays admitted,
  so a snapshot hard-links the blocks that were full at the session's
  previous committed snapshot (same replica, same admission, same
  physical ids) and writes only the rest; each snapshot directory is a
  complete handoff all the same.  The session's host state (generated
  tokens, pending token, position, SLO class) rides in the manifest's
  ``meta`` record, so a
  committed manifest is a complete, adoptable session and a
  mid-snapshot kill leaves only manifest-less debris the restore path
  rejects (:class:`~apex_tpu_torch.runtime.resilience.
  CheckpointCorruptError`) — never adopts.
* **Migration on ``host.loss``**: when the coordinator publishes a
  shrink epoch, the front-end re-homes every unfinished session of the
  lost replicas.  Latency-tier sessions restore from their newest
  committed snapshot into a survivor's pool
  (:meth:`~apex_tpu_torch.serve.engine.ServeEngine.ingest_handoff`: blocks
  land verbatim, so the continuation is BITWISE the uninterrupted
  engine's; greedy decode regenerates any tokens emitted after the
  snapshot identically).  Sessions whose snapshot is stale or
  debris-only fall back to the recompute-mode re-prefill path —
  ``prompt + out[:-1]`` with ``out[-1]`` pending — which the
  preemption tests already pin bitwise.  In speculative mode a
  migrated session's draft cache starts empty and catches up through
  the survivor's prefill slot.
* **SLO-aware shedding**: on capacity loss, batch-tier sessions are
  shed FIRST — re-queued at the front-end (never dropped), re-admitted
  in recompute mode when headroom returns — while latency-tier
  sessions migrate; a survivor with no room evicts its own newest
  batch-tier session to make room for an incoming latency migration.
  Backpressure (fleet queue depth, pending recovery, shed counters)
  is visible in :meth:`ServeFleet.metrics`.
* **Epoch-aware routing**: new submissions route to the live replica
  with the most pool headroom under the CURRENT membership epoch; a
  submission addressed to a stale epoch is refused
  (:class:`StaleEpochError`); when the coordinator publishes a new
  view the front-end re-homes its queue.  Re-homed and requeued
  sessions are inserted into the survivor's queue in original
  admission order (fleet-wide FIFO fairness).

Process-boundary rule (``cluster/runtime.py``): ``ChaosKilled`` is never
caught to continue the killed operation — a felled replica's engine is
closed (its pool dies with the process; blocks return so
``check_no_leaks`` stays meaningful) and only its durable snapshots
are read afterwards.  A felled coordinator is replaced by a successor
over the same KV store; recovery state lives in the front-end, so a
coordinator loss mid-migration is completed — or cleanly abandoned to
recompute — by the successor, never half-adopted.  Chaos hook points:
``serve.session_snapshot`` (before each session snapshot),
``serve.migrate`` (before each restore attempt), plus
``serve.kv_handoff`` inside the stream itself (runtime/chaos.py).
"""
from __future__ import annotations

import bisect
import itertools
import json
import os
import re
import shutil
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..cluster.coordinator import Coordinator
from ..cluster.kvstore import KVStore, MemoryKV
from ..cluster.membership import Member, MembershipView, current_view
from ..cluster.runtime import SimClock, beat_and_scan
from ..observe import registry as _obs
from ..runtime import chaos as _chaos
from ..runtime.resilience import (CheckpointCorruptError,
                                  CheckpointReshardError,
                                  discard_kv_handoff,
                                  read_kv_handoff_meta, stream_kv_handoff)
from .engine import ServeEngine
from .pool import blocks_for
from .scheduler import DECODE, Request, SLO_CLASSES

__all__ = ["ServeFleet", "FleetMember", "StaleEpochError", "SLO_CLASSES"]


class StaleEpochError(RuntimeError):
    """A submission addressed a membership epoch the fleet has moved
    past — the client's routing table predates a shrink/grow; it must
    re-resolve the current view and resubmit."""


class FleetMember:
    """One serve replica: a membership agent plus the engine it
    fronts.  ``closed`` means the replica's simulated process is gone —
    its engine was torn down (blocks returned) and only its durable
    snapshots may be read from here on."""

    __slots__ = ("member", "engine", "closed")

    def __init__(self, member: Member, engine: ServeEngine):
        self.member = member
        self.engine = engine
        self.closed = False

    @property
    def member_id(self) -> str:
        return self.member.member_id

    @property
    def alive(self) -> bool:
        return self.member.alive


class _Tracked:
    """Front-end record of one submission: routing seq (fleet-wide
    FIFO order), SLO class, current home, tokens generated as of the
    last durable observation (for recompute re-queues), and the
    session's snapshot directories, newest first — a dir is added
    BEFORE its stream starts, so a mid-snapshot kill's debris is
    found, rejected, and discarded by the restore path.  ``linkable``
    describes the newest committed snapshot for the next one's hard
    links: ``(admission, full block ids, directory, block records)``,
    the admission being ``(replica, scheduler seq)``."""

    __slots__ = ("request", "slo", "seq", "member", "out", "snaps",
                 "snap_no", "linkable")

    def __init__(self, request: Request, slo: str, seq: int):
        self.request = request
        self.slo = slo
        self.seq = seq
        self.member: Optional[str] = None
        self.out: List[int] = []
        self.snaps: List[str] = []
        self.snap_no = 0
        self.linkable = None


def _tag(rid: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", rid)


class ServeFleet:
    """A membership-backed fleet of replicated serve engines.

    ``n_engines`` replicas share one ``model`` (weights are read-only
    under serving); ``num_blocks`` is an int or a per-replica sequence
    (heterogeneous pools).  ``kv``/``clock`` default to the tier-1
    simulation substrate (:class:`MemoryKV` + :class:`SimClock`);
    ``deadline_s``/``miss_threshold`` parameterize the coordinator's
    consecutive-miss failure detector.  ``snapshot_every`` is the
    session-snapshot cadence in fleet ticks (0 disables — every lost
    session then recomputes); ``snapshot_max_age_ticks`` declares
    older snapshots stale (recompute fallback; None = never stale);
    ``migrate_per_tick`` bounds restores per tick (None = drain
    everything the tick the epoch lands)."""

    def __init__(self, model, *, n_engines, num_blocks, block_size=16,
                 max_batch=8, prefill_chunk=32, cache_dtype=None,
                 draft=None, spec_k=4, draft_cache_dtype="int8",
                 spec_policy="on", kv: Optional[KVStore] = None,
                 clock: Optional[SimClock] = None, deadline_s=0.25,
                 miss_threshold=2, snapshot_every=2, snapshot_dir=None,
                 snapshot_max_age_ticks=None, migrate_per_tick=None):
        if n_engines < 1:
            raise ValueError(f"n_engines must be >= 1, got {n_engines}")
        blocks = list(num_blocks) \
            if isinstance(num_blocks, (list, tuple)) \
            else [num_blocks] * n_engines
        if len(blocks) != n_engines:
            raise ValueError(
                f"num_blocks: {len(blocks)} entries for {n_engines} "
                f"engines")
        self.kv = kv if kv is not None else MemoryKV()
        self.clock = clock if clock is not None else SimClock()
        self.deadline_s = float(deadline_s)
        self.miss_threshold = int(miss_threshold)
        self.snapshot_every = int(snapshot_every)
        self.snapshot_max_age_ticks = snapshot_max_age_ticks
        self.migrate_per_tick = migrate_per_tick
        self.block_size = int(block_size)
        self.spec = draft is not None
        self._own_snapdir = snapshot_dir is None
        if snapshot_dir is None:
            snapshot_dir = tempfile.mkdtemp(prefix="apex_serve_fleet_")
        self.snapshot_dir = snapshot_dir
        self.members: Dict[str, FleetMember] = {}
        for i in range(n_engines):
            engine = ServeEngine(
                model, num_blocks=blocks[i], block_size=block_size,
                max_batch=max_batch, prefill_chunk=prefill_chunk,
                cache_dtype=cache_dtype, draft=draft, spec_k=spec_k,
                draft_cache_dtype=draft_cache_dtype,
                spec_policy=spec_policy)
            member = Member(
                self.kv, f"serve{i}", clock=self.clock,
                spec=json.dumps({"chip": "serve",
                                 "n_blocks": int(blocks[i])}))
            self.members[member.member_id] = FleetMember(member, engine)
        self.coordinator = self._make_coordinator()
        self.view: Optional[MembershipView] = None
        self.results: Dict[str, List[int]] = {}
        self.telemetry: dict = {}
        self._tick = 0
        self._seq = itertools.count()
        self._recs: Dict[str, _Tracked] = {}
        self._queue: List[str] = []        # rids awaiting routing, by seq
        self._recovery: deque = deque()    # rids awaiting re-homing
        self._migrated = 0
        self._shed_requeued = 0
        self._recomputed = 0
        self._debris_rejected = 0
        self._snapshot_peak = 0
        self._detect_ms = 0.0
        self._migrate_ms = 0.0
        self._death_wall: Optional[float] = None

    def _make_coordinator(self) -> Coordinator:
        return Coordinator(self.kv, deadline_s=self.deadline_s,
                           miss_threshold=self.miss_threshold,
                           clock=self.clock)

    # -- membership --------------------------------------------------------

    def join(self) -> MembershipView:
        """All replicas register + first-beat; the coordinator
        publishes epoch 1 and every replica acks it."""
        if self.view is not None:
            return self.view
        for m in self.members.values():
            m.member.join()
        view = self.coordinator.scan()
        for m in self.members.values():
            if m.alive:
                m.member.ack(view)
        self.view = view
        _obs.event("serve.fleet", phase="joined", epoch=view.epoch,
                   members=list(view.members))
        return view

    def _live_members(self) -> List[FleetMember]:
        return [m for m in self.members.values()
                if m.alive and not m.closed]

    def _targets(self) -> List[FleetMember]:
        """Routing candidates: replicas in the CURRENT view that also
        answer (a dead-but-undetected replica fails its headroom probe
        exactly like a refused connection), most PROJECTED free blocks
        first — pool headroom minus what the replica's own admission
        queue will claim, so one tick's routing spreads load instead
        of piling onto a single replica."""
        vm = set(self.view.members) if self.view else set()
        live = [m for m in self._live_members() if m.member_id in vm]
        live.sort(key=lambda m: (-self._projected_free(m), m.member_id))
        return live

    def _projected_free(self, m: FleetMember) -> int:
        free = m.engine.block_pool.free_count
        mult = 2 if self.spec else 1
        for s in m.engine.scheduler.queue:
            src = s.prefill_src if s.pending_tok is not None \
                else s.request.prompt
            free -= blocks_for(len(src) + 1, self.block_size) * mult
        return free

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request, *, slo: Optional[str] = None,
               epoch: Optional[int] = None) -> None:
        """Queue a request with the front-end.  ``slo`` overrides the
        request's own class (``"latency"`` migrates on shrink,
        ``"batch"`` sheds first, re-queued).  ``epoch`` asserts the
        membership epoch the client routed against — a stale epoch is
        refused with :class:`StaleEpochError` so clients re-resolve
        after a shrink instead of racing it."""
        if self.view is None:
            raise RuntimeError("join() the fleet before submitting")
        slo = slo if slo is not None else request.slo
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"request {request.rid}: slo must be one of "
                f"{SLO_CLASSES}, got {slo!r}")
        published = current_view(self.kv) or self.view
        if epoch is not None and int(epoch) != published.epoch:
            raise StaleEpochError(
                f"request {request.rid}: addressed to membership epoch "
                f"{epoch}; the fleet is at epoch {published.epoch} — "
                f"re-resolve the view and resubmit")
        if request.rid in self._recs:
            raise ValueError(f"request {request.rid}: duplicate rid")
        rec = _Tracked(request, slo, next(self._seq))
        self._recs[request.rid] = rec
        self._enqueue(request.rid)
        _obs.event("serve.fleet", phase="queued", rid=request.rid,
                   slo=slo, epoch=published.epoch)

    def _enqueue(self, rid: str) -> None:
        seqs = [self._recs[r].seq for r in self._queue]
        self._queue.insert(
            bisect.bisect_left(seqs, self._recs[rid].seq), rid)

    # -- the fleet tick ----------------------------------------------------

    def step(self, advance_s: Optional[float] = None) -> bool:
        """One fleet cycle: heartbeats + coordinator scan (chaos fells
        replicas/coordinators here), adopt a new epoch if one was
        published (re-homing the lost replicas' sessions), drain
        pending recovery, route the front-end queue by headroom, tick
        every live engine, and snapshot live sessions on cadence.
        Returns True while any work remains anywhere."""
        if self.view is None:
            raise RuntimeError("join() the fleet before stepping")
        if advance_s is None:
            advance_s = self.deadline_s / 2
        self._tick += 1
        view, self.coordinator, felled = beat_and_scan(
            self.kv, self.clock,
            [m.member for m in self.members.values()],
            self.coordinator, self._make_coordinator,
            advance_s=advance_s, fallback_view=self.view)
        for mid in felled:
            self._fell(mid)
        if view is not None and view.epoch != self.view.epoch:
            self._adopt_view(view)
        self._drain_recovery()
        self._route()
        for m in self._live_members():
            m.engine.step()
            self._harvest(m)
        if self.snapshot_every and \
                self._tick % self.snapshot_every == 0:
            self._snapshot_phase()
        return self.has_work()

    def run(self, requests: Sequence[Request], *, slos=None,
            arrivals=None, max_ticks: Optional[int] = None):
        """Serve ``requests`` to completion across the fleet; returns
        ``{rid: tokens}``.  ``slos`` optionally classes each request
        (else ``request.slo``); ``arrivals`` is the open-loop trace of
        submit ticks, as in :meth:`ServeEngine.run`."""
        pending = sorted(
            zip(arrivals if arrivals is not None
                else [0] * len(requests), range(len(requests))),
            key=lambda p: (p[0], p[1]))
        i = 0
        while True:
            while i < len(pending) and pending[i][0] <= self._tick:
                idx = pending[i][1]
                self.submit(requests[idx],
                            slo=slos[idx] if slos else None)
                i += 1
            more = self.step()
            if not more and i >= len(pending):
                break
            if max_ticks is not None and self._tick >= max_ticks:
                break
            if more and not self._live_members():
                raise RuntimeError(
                    "serve fleet has no live replicas but work remains")
        return dict(self.results)

    # -- failure handling --------------------------------------------------

    def _fell(self, mid: str) -> None:
        """Convert a ``ChaosKilled`` at the replica boundary: the
        process is gone.  Results it already produced were delivered
        (tokens stream out as they are emitted); its engine is closed
        — the pool's memory dies with the process — and from here on
        only its committed snapshots are read."""
        m = self.members[mid]
        m.member.alive = False
        if m.closed:
            return
        self._harvest(m)
        m.engine.close()
        m.closed = True
        if self._death_wall is None:
            self._death_wall = time.perf_counter()
        _obs.event("serve.fleet", phase="host_lost", member=mid,
                   tick=self._tick)

    def _adopt_view(self, view: MembershipView) -> None:
        """The agree + re-home half of the cycle: survivors ack the
        epoch, replicas the view dropped are fenced (their engine is
        treated as gone even if only partitioned — real fleets fence,
        they don't split-brain), and every unfinished session homed on
        a lost replica enters the recovery queue in fleet FIFO order."""
        for m in self.members.values():
            if m.alive and not m.closed and m.member_id in view.members:
                m.member.ack(view)
        if not self.coordinator.acked(view):
            missing = [mid for mid in view.members
                       if not (mid in self.members
                               and self.members[mid].alive)]
            raise RuntimeError(
                f"serve fleet epoch {view.epoch} not agreed: members "
                f"{missing} never acked")
        if self._death_wall is not None:
            self._detect_ms = \
                (time.perf_counter() - self._death_wall) * 1e3
            self._death_wall = None
        old = self.view
        self.view = view
        lost = [mid for mid in old.members if mid not in view.members]
        for mid in lost:
            if mid in self.members:
                self._fell(mid)
        plan = sorted(
            (rid for rid, rec in self._recs.items()
             if rec.member in lost and rid not in self.results),
            key=lambda rid: self._recs[rid].seq)
        for rid in plan:
            self._recs[rid].member = None
            self._recovery.append(rid)
        self.telemetry = {
            "epoch": view.epoch,
            "members": list(view.members),
            "lost": lost,
            "to_recover": len(plan),
            "detect_ms": round(self._detect_ms, 3),
        }
        _obs.event("serve.fleet", phase="epoch", epoch=view.epoch,
                   members=list(view.members), lost=lost,
                   to_recover=len(plan))

    def _drain_recovery(self) -> None:
        """Re-home lost sessions, oldest first: batch tier is shed
        (re-queued in recompute mode — never dropped), latency tier
        migrates via its newest committed snapshot.  The queue lives in
        the front-end, not the coordinator, so a coordinator felled
        mid-migration leaves the successor to finish the drain."""
        if not self._recovery:
            return
        budget = self.migrate_per_tick or len(self._recovery)
        t0 = time.perf_counter()
        while self._recovery and budget > 0:
            budget -= 1
            rid = self._recovery.popleft()
            if rid in self.results:
                continue
            rec = self._recs[rid]
            if rec.slo == "batch":
                snap = self._usable_snapshot(rec)
                out = list((snap[1].get("meta") or {}).get("out", [])) \
                    if snap else list(rec.out)
                self._requeue(rec, out, shed=True)
                continue
            self._migrate(rid, rec)
        self._migrate_ms += (time.perf_counter() - t0) * 1e3

    def _usable_snapshot(self, rec: _Tracked):
        """Newest snapshot with a COMMITTED manifest, or None.
        Manifest-less debris (a kill mid-snapshot) is rejected —
        :func:`read_kv_handoff_meta` raises
        :class:`CheckpointCorruptError` — discarded, and the next-older
        snapshot considered; it is never adopted."""
        for d in list(rec.snaps):
            try:
                manifest = read_kv_handoff_meta(d)
            except CheckpointCorruptError:
                self._debris_rejected += 1
                _obs.event("serve.fleet", phase="debris_rejected",
                           rid=rec.request.rid, dir=d)
                discard_kv_handoff(d)
                rec.snaps.remove(d)
                continue
            return d, manifest
        return None

    def _is_stale(self, manifest: dict) -> bool:
        if self.snapshot_max_age_ticks is None:
            return False
        at = int((manifest.get("meta") or {}).get("tick", 0))
        return (self._tick - at) > int(self.snapshot_max_age_ticks)

    def _requeue(self, rec: _Tracked, out, *, shed: bool) -> None:
        """Back to the front-end queue in recompute mode, keeping the
        session's fleet FIFO seat.  ``shed`` counts batch-tier
        shedding; otherwise this is a latency-tier recompute
        fallback."""
        rec.out = [int(t) for t in out]
        rec.member = None
        for d in rec.snaps:
            discard_kv_handoff(d)
        rec.snaps = []
        self._enqueue(rec.request.rid)
        if shed:
            self._shed_requeued += 1
        else:
            self._recomputed += 1
        _obs.event("serve.fleet",
                   phase="shed" if shed else "recompute",
                   rid=rec.request.rid, generated=len(rec.out))

    def _migrate(self, rid: str, rec: _Tracked) -> None:
        """Restore a latency-tier session into a survivor's pool from
        its newest committed snapshot; fall back to recompute when no
        usable snapshot exists, it is stale, or no survivor can take
        the blocks even after shedding its batch tier."""
        snap = self._usable_snapshot(rec)
        if snap is None:
            self._requeue(rec, rec.out, shed=False)
            return
        d, manifest = snap
        meta = manifest.get("meta") or {}
        if self._is_stale(manifest) or not meta:
            self._requeue(rec, meta.get("out", rec.out), shed=False)
            return
        for target in self._targets():
            try:
                if _chaos.active():
                    _chaos.hook("serve.migrate", rid=rid,
                                member=target.member_id, dir=d)
                sess = self._adopt_with_shedding(target, rec, d,
                                                 manifest, meta)
            except _chaos.ChaosKilled:
                # the ADOPTING replica died mid-migration; its pool is
                # gone but the snapshot is durable on shared storage —
                # recovery resumes next tick on whoever survives
                self._fell(target.member_id)
                self._recovery.appendleft(rid)
                return
            except _chaos.ChaosInjectedFailure:
                self._requeue(rec, meta.get("out", rec.out),
                              shed=False)
                return
            except (CheckpointCorruptError, CheckpointReshardError):
                self._debris_rejected += 1
                discard_kv_handoff(d)
                if d in rec.snaps:
                    rec.snaps.remove(d)
                self._requeue(rec, meta.get("out", rec.out),
                              shed=False)
                return
            if sess is not None:
                rec.member = target.member_id
                rec.out = [int(t) for t in meta["out"]]
                for dd in rec.snaps:
                    discard_kv_handoff(dd)
                rec.snaps = []
                self._migrated += 1
                _obs.event("serve.fleet", phase="migrated", rid=rid,
                           member=target.member_id,
                           blocks=int(manifest["n_blocks"]),
                           generated=len(rec.out))
                return
        self._requeue(rec, meta.get("out", rec.out), shed=False)

    def _adopt_with_shedding(self, target: FleetMember, rec: _Tracked,
                             d: str, manifest: dict, meta: dict):
        """Try the restore; when the target is out of slots/blocks,
        shed its newest batch-tier session (re-queued fleet-side) and
        retry — batch sheds first so latency migrates."""
        while True:
            sess = target.engine.ingest_handoff(
                rec.request, out=list(meta["out"]),
                pending_tok=int(meta["pending_tok"]),
                position=int(meta["position"]), handoff_dir=d,
                n_blocks=int(manifest["n_blocks"]),
                hash_chain=meta.get("hash_chain"),
                weight_epoch=meta.get("weight_epoch", -1))
            if sess is not None:
                return sess
            if not self._shed_batch_for_room(target):
                return None

    def _shed_batch_for_room(self, target: FleetMember) -> bool:
        """Evict the newest live batch-tier session from ``target``
        and re-queue it fleet-side (recompute mode, exact progress —
        the replica is alive, so no snapshot round-trip).  False when
        the replica holds no batch-tier sessions to shed."""
        batch = [s for s in target.engine.scheduler.sessions
                 if s.rid in self._recs
                 and self._recs[s.rid].slo == "batch"]
        if not batch:
            return False
        victim = max(batch, key=lambda s: self._recs[s.rid].seq)
        target.engine.evict_session(victim)
        self._requeue(self._recs[victim.rid], victim.out, shed=True)
        return True

    # -- routing -----------------------------------------------------------

    def _route(self) -> None:
        """Drain the front-end queue in fleet FIFO order.  Latency
        tier routes to the most-headroom replica unconditionally (its
        admission control paces it); batch tier routes only when the
        target has real block headroom and a batch slot — during a
        shrink that is the admission backpressure the metrics show."""
        routed = []
        for rid in self._queue:
            rec = self._recs[rid]
            target = self._pick_member(rec)
            if target is None:
                continue
            self._deliver(target, rec)
            routed.append(rid)
        for rid in routed:
            self._queue.remove(rid)

    def _pick_member(self, rec: _Tracked) -> Optional[FleetMember]:
        targets = self._targets()
        if not targets:
            return None
        best = targets[0]
        if rec.slo == "batch":
            src = len(rec.request.prompt) + max(0, len(rec.out) - 1)
            need = blocks_for(src + 1, self.block_size)
            if self.spec:
                need *= 2
            sched = best.engine.scheduler
            if self._projected_free(best) < need or \
                    len(sched.sessions) + len(sched.queue) \
                    >= sched.max_batch:
                return None
        return best

    def _deliver(self, target: FleetMember, rec: _Tracked) -> None:
        if rec.out:
            target.engine.submit_recompute(rec.request, rec.out)
        else:
            target.engine.submit(rec.request)
        rec.member = target.member_id
        self._reorder_queue(target.engine)
        _obs.event("serve.fleet", phase="routed", rid=rec.request.rid,
                   member=target.member_id, epoch=self.view.epoch,
                   slo=rec.slo)

    def _reorder_queue(self, engine: ServeEngine) -> None:
        """Keep an engine's admission queue in fleet FIFO order: a
        re-homed session with an older seat slots in AHEAD of the
        survivor's younger native entries (stable for ties)."""
        q = engine.scheduler.queue
        if len(q) < 2:
            return
        big = 1 << 62
        entries = sorted(
            q, key=lambda s: self._recs[s.rid].seq
            if s.rid in self._recs else big)
        q.clear()
        q.extend(entries)

    # -- snapshots ---------------------------------------------------------

    def _snapshot_phase(self) -> None:
        for m in self._live_members():
            try:
                for s in list(m.engine.scheduler.sessions):
                    if s.state != DECODE or s.position <= 0 \
                            or s.finished():
                        continue
                    self._snapshot_session(m, s)
            except _chaos.ChaosKilled:
                # the replica died mid-snapshot: debris (no manifest)
                # stays on shared storage for the restore path to
                # reject; the previous committed snapshot stands
                self._fell(m.member_id)

    def _snapshot_session(self, m: FleetMember, s) -> None:
        rec = self._recs[s.rid]
        rec.snap_no += 1
        d = os.path.join(self.snapshot_dir, _tag(s.rid),
                         f"snap{rec.snap_no}")
        n_blocks = blocks_for(s.position, self.block_size)
        admission = (m.member_id, s.seq)
        link_from = None
        if rec.linkable is not None and rec.linkable[0] == admission \
                and rec.linkable[2] in rec.snaps:
            ids, prev_dir, prev_blocks = rec.linkable[1:]
            n = 0
            while n < len(ids) and s.table[n] == ids[n]:
                n += 1
            link_from = (prev_dir, prev_blocks, n)
        # registered before the stream starts: a kill mid-stream leaves
        # this dir as findable, rejectable debris
        rec.snaps.insert(0, d)
        try:
            if _chaos.active():
                _chaos.hook("serve.session_snapshot", rid=s.rid,
                            member=m.member_id, dir=d, tick=self._tick)
            manifest, peak = stream_kv_handoff(
                d, m.engine.pool, s.table[:n_blocks],
                source=f"snapshot:{s.rid}", link_from=link_from,
                extra_meta={"rid": s.rid, "out": list(s.out),
                            "pending_tok": int(s.pending_tok),
                            "position": int(s.position),
                            "slo": rec.slo, "tick": self._tick,
                            "epoch": self.view.epoch,
                            "hash_chain": list(s.hash_chain),
                            "weight_epoch": int(s.weight_epoch)})
        except _chaos.ChaosInjectedFailure:
            # recoverable snapshot fault: skip this round cleanly, the
            # previous committed snapshot stays newest
            discard_kv_handoff(d)
            rec.snaps.remove(d)
            return
        self._snapshot_peak = max(self._snapshot_peak, peak)
        for old in rec.snaps[1:]:
            discard_kv_handoff(old)
        rec.snaps = [d]
        full = s.position // self.block_size
        rec.linkable = (admission, list(s.table[:full]), d,
                        manifest["blocks"])
        _obs.event("serve.fleet", phase="snapshot", rid=s.rid,
                   member=m.member_id, blocks=n_blocks,
                   peak_bytes=peak)

    # -- results / introspection -------------------------------------------

    def _harvest(self, m: FleetMember) -> None:
        for rid, toks in m.engine.results.items():
            if rid not in self.results:
                self.results[rid] = list(toks)
                rec = self._recs.get(rid)
                if rec is not None:
                    for d in rec.snaps:
                        discard_kv_handoff(d)
                    rec.snaps = []

    def has_work(self) -> bool:
        # every accepted request is tracked until its result lands —
        # including sessions homed on a replica that just died and
        # won't enter recovery until the coordinator publishes the
        # shrink epoch a few scans from now
        return len(self.results) < len(self._recs)

    @property
    def tick(self) -> int:
        return self._tick

    def assignments(self) -> Dict[str, Optional[str]]:
        """The front-end's routing table: ``{rid: member_id}`` (None
        while a request waits fleet-side)."""
        return {rid: rec.member for rid, rec in self._recs.items()}

    def slo_of(self, rid: str) -> str:
        return self._recs[rid].slo

    def metrics(self) -> dict:
        """Fleet SLO/backpressure snapshot: per-replica liveness and
        pool state plus the shrink counters the acceptance pins —
        shed/requeued vs migrated vs recomputed, snapshot peak bytes,
        detection and migration latency."""
        members = {}
        for mid, m in self.members.items():
            members[mid] = {
                "alive": bool(m.alive and not m.closed),
                "sessions": len(m.engine.scheduler.sessions),
                "queue_depth": len(m.engine.scheduler.queue),
                "free_blocks": m.engine.block_pool.free_count,
                "cached_blocks": m.engine.block_pool.cached_count,
                "pool_occupancy": m.engine.block_pool.occupancy,
            }
        return {
            "epoch": self.view.epoch if self.view else 0,
            "members": members,
            "queue_depth": len(self._queue),
            "pending_recovery": len(self._recovery),
            "sessions_migrated": self._migrated,
            "sessions_shed_requeued": self._shed_requeued,
            "sessions_recomputed": self._recomputed,
            "debris_rejected": self._debris_rejected,
            "snapshot_bytes_peak_host": self._snapshot_peak,
            "detect_ms": round(self._detect_ms, 3),
            "migrate_ms": round(self._migrate_ms, 3),
            "completed": len(self.results),
        }

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Tear down every replica still standing (returning all
        session blocks; ``check_no_leaks`` runs per engine) and remove
        the snapshot root if the fleet created it."""
        for m in self.members.values():
            if not m.closed:
                m.engine.close()
                m.closed = True
                m.member.alive = False
        if self._own_snapdir:
            shutil.rmtree(self.snapshot_dir, ignore_errors=True)

    def __enter__(self) -> "ServeFleet":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
