"""The cluster coordinator: heartbeat-driven failure detection and
epoch publication, the PyTorch counterpart of
``apex_tpu/cluster/coordinator.py``.

One coordinator scans the heartbeat table at a fixed cadence and
publishes a new :class:`~apex_tpu_torch.cluster.membership.MembershipView`
whenever the live set changes.  Two properties carry the protocol:

* **Consecutive-miss detection.**  A member is declared dead only after
  ``miss_threshold`` CONSECUTIVE scans find its heartbeat stale (older
  than ``deadline_s``).  A single delayed heartbeat — GC pause, slow
  NFS, the ``heartbeat.delay`` chaos action — resets to zero the moment
  a fresh beat lands, so transient skew never costs a member its seat
  (the false-positive guard tier-1 pins).
* **Epochs survive the coordinator.**  The epoch counter lives in the
  KV store, not in the coordinator object; a replacement coordinator
  built over the same store (the ``coordinator.loss`` recovery path)
  continues from the persisted value — epochs are monotonic across
  coordinator deaths, so "which epoch is newer" is always decidable.

The coordinator is deliberately soft-state otherwise: miss counters
rebuild from scratch after a coordinator loss (costing at worst
``miss_threshold`` extra scans of detection latency, never a wrong
answer).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from ..observe import registry as _obs
from ..runtime import chaos as _chaos
from .kvstore import KVStore
from .membership import PREFIX, MembershipView, current_epoch, current_view


def _older_epoch(key: str, epoch: int) -> bool:
    """True for the ``view/<e>`` and ``ack/<e>/...`` keys of an epoch
    ``e`` before ``epoch``."""
    for kind in ("view/", "ack/"):
        if key.startswith(PREFIX + kind):
            head = key[len(PREFIX + kind):].split("/", 1)[0]
            return head.isdigit() and int(head) < epoch
    return False


class Coordinator:
    """Failure detector + epoch publisher over a :class:`KVStore`.

    ``deadline_s`` is how stale a heartbeat may be before a scan counts
    a miss (typically 2× the members' beat interval); ``miss_threshold``
    is how many consecutive missing scans fell a member.  ``clock`` must
    be the same clock the members stamp heartbeats with (injectable for
    deterministic tests)."""

    def __init__(self, kv: KVStore, *, deadline_s: float = 1.0,
                 miss_threshold: int = 2, clock=time.monotonic):
        if miss_threshold < 1:
            raise ValueError(
                f"miss_threshold must be >= 1, got {miss_threshold}")
        self.kv = kv
        self.deadline_s = float(deadline_s)
        self.miss_threshold = int(miss_threshold)
        self.clock = clock
        #: consecutive stale-heartbeat scans per member (soft state)
        self.misses: Dict[str, int] = {}

    # -- detection ---------------------------------------------------------
    def registered(self) -> list:
        n = len(f"{PREFIX}members/")
        return sorted(k[n:] for k in self.kv.scan(f"{PREFIX}members/"))

    def scan(self) -> MembershipView:
        """One failure-detection pass: read every registered member's
        heartbeat, update consecutive-miss counters, and publish a new
        epoch iff the live set changed.  Returns the current (possibly
        fresh) view.  Chaos hook ``coordinator.loss`` fires first —
        ``"kill"`` is the coordinator dying mid-duty; the successor is a
        new :class:`Coordinator` over the same store."""
        if _chaos.active():
            _chaos.hook("coordinator.loss")
        now = self.clock()
        view = current_view(self.kv)
        alive = []
        for member in self.registered():
            raw = self.kv.get(f"{PREFIX}hb/{member}")
            fresh = raw is not None and \
                (now - float(raw)) <= self.deadline_s
            if fresh:
                self.misses[member] = 0
            elif member not in self.misses and view is not None \
                    and member not in view.members:
                # a successor coordinator starts with empty counters; a
                # registered-but-stale member the published view already
                # DROPPED stays presumed dead (only a fresh beat
                # readmits it) — otherwise every coordinator restart
                # would resurrect dead members for one bogus epoch
                self.misses[member] = self.miss_threshold
            else:
                self.misses[member] = self.misses.get(member, 0) + 1
            if self.misses[member] < self.miss_threshold:
                alive.append(member)
        if view is not None and tuple(alive) == view.members:
            return view
        return self._publish(alive, prev=view)

    def _publish(self, alive: list, prev: Optional[MembershipView]
                 ) -> MembershipView:
        epoch = current_epoch(self.kv) + 1
        view = MembershipView(epoch=epoch, members=tuple(alive))
        # counter first, view second: a coordinator killed between the
        # two burns an epoch number, which is harmless — monotonicity is
        # the invariant, density is not
        self.kv.set(f"{PREFIX}epoch", str(epoch))
        self.kv.set(f"{PREFIX}view/{epoch}", view.to_json())
        self.kv.set(f"{PREFIX}view/current", view.to_json())
        prune = getattr(self.kv, "prune", None)
        if prune is not None:
            # a store whose scan walks an index: older epochs' views and
            # acks leave it (nobody scans or sets them again; get still
            # reads them)
            prune(lambda key: _older_epoch(key, epoch))
        _obs.event("cluster.epoch", epoch=epoch, members=list(alive),
                   lost=sorted(set(prev.members) - set(alive))
                   if prev else [],
                   joined=sorted(set(alive) -
                                 set(prev.members if prev else ())))
        return view

    # -- agreement ---------------------------------------------------------
    def acked(self, view: MembershipView) -> bool:
        """True when every member of ``view`` has adopted it."""
        n = len(f"{PREFIX}ack/{view.epoch}/")
        got = {k[n:] for k in self.kv.scan(f"{PREFIX}ack/{view.epoch}/")}
        return set(view.members) <= got
