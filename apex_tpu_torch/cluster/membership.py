"""Cluster membership: presence, heartbeats, and epoch-numbered views,
the PyTorch counterpart of ``apex_tpu/cluster/membership.py`` (no change
to the protocol: the same keys, values and epochs as the JAX module).

``parallel.distributed``'s presence registry is this member table: each
rank joins as a :class:`Member` once its process group is up, so a
collective timeout can name missing peers.  Presence is CONTINUOUS:
each member re-asserts liveness by heartbeat, and the coordinator
condenses the heartbeat table into an **epoch-numbered membership
view**: an immutable ``(epoch, members)`` snapshot that only ever
advances.  Everything downstream (the serve fleet's routing, the
executor's dispatch tags) keys off the view's epoch, never off raw
process ids.

Key layout (all under ``apex_tpu/cluster/``):

====================================  ==================================
key                                   value
====================================  ==================================
``members/<id>``                      the member's registration record
                                      (host spec; opaque to the
                                      protocol)
``hb/<id>``                           last heartbeat timestamp (clock
                                      units of the deployment's shared
                                      clock)
``epoch``                             the monotonic epoch counter —
                                      PERSISTED here so a restarted
                                      coordinator continues, never
                                      rewinds
``view/current``                      JSON of the live
                                      :class:`MembershipView`
``view/<epoch>``                      history: the view each epoch
                                      introduced
``ack/<epoch>/<id>``                  member ``<id>`` has adopted epoch
                                      ``<epoch>`` (the agreement half of
                                      detect→agree→replan→reshard)
====================================  ==================================

Chaos hooks ``host.loss`` and ``heartbeat.delay`` fire in
:meth:`Member.beat` — a ``"kill"`` is the simulated host death
(the in-process simulation converts it at the member boundary into
"this member's process is gone"), and a numeric ``heartbeat.delay``
result skews the written timestamp backwards, which under the
coordinator's ``miss_threshold`` must NOT cost the member its seat.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Optional, Tuple

from ..runtime import chaos as _chaos
from .kvstore import KVStore

PREFIX = "apex_tpu/cluster/"


@dataclass(frozen=True)
class MembershipView:
    """One immutable epoch of cluster membership."""

    epoch: int
    members: Tuple[str, ...]

    def to_json(self) -> str:
        return json.dumps({"epoch": self.epoch,
                           "members": list(self.members)})

    @classmethod
    def from_json(cls, raw: str) -> "MembershipView":
        obj = json.loads(raw)
        return cls(epoch=int(obj["epoch"]),
                   members=tuple(obj["members"]))


def current_view(kv: KVStore) -> Optional[MembershipView]:
    raw = kv.get(f"{PREFIX}view/current")
    return MembershipView.from_json(raw) if raw else None


def current_epoch(kv: KVStore) -> int:
    """The persisted epoch counter (0 before any view is published)."""
    raw = kv.get(f"{PREFIX}epoch")
    return int(raw) if raw else 0


class Member:
    """One cluster member's presence agent.

    ``member_id`` is the stable identity ("host0", or a rank string);
    ``spec`` is an opaque registration record (e.g. the member's chip
    type and device count, which the JAX package's planner reads as fleet
    metadata).  ``clock`` is injectable so tier-1 tests advance
    time deterministically; production uses ``time.monotonic`` against
    a per-deployment shared KV.
    """

    def __init__(self, kv: KVStore, member_id: str, *, spec: str = "",
                 clock=time.monotonic):
        self.kv = kv
        self.member_id = str(member_id)
        self.spec = spec
        self.clock = clock
        self.alive = False

    # -- lifecycle ---------------------------------------------------------
    def join(self):
        """Register + first heartbeat: after this the next coordinator
        scan includes the member in the view."""
        self.kv.set(f"{PREFIX}members/{self.member_id}", self.spec or "{}")
        self.alive = True
        self.beat()
        return self

    def leave(self):
        """Graceful departure: deregister so the next scan drops the
        member without waiting out ``miss_threshold``."""
        self.alive = False
        self.kv.delete(f"{PREFIX}members/{self.member_id}")
        self.kv.delete(f"{PREFIX}hb/{self.member_id}")

    # -- heartbeat ---------------------------------------------------------
    def beat(self):
        """Write one heartbeat.  Chaos: ``host.loss`` (``"kill"`` = this
        host dies — the heartbeat never lands and the member must drop
        from the next epoch once ``miss_threshold`` scans miss it);
        ``heartbeat.delay`` (a numeric result — a callable action's
        return, or the controller's ``delay_s`` — skews the timestamp
        backwards, simulating a paused-but-alive host)."""
        if not self.alive:
            raise RuntimeError(
                f"member {self.member_id!r} is not joined/alive")
        skew = 0.0
        if _chaos.active():
            _chaos.hook("host.loss", member=self.member_id)
            res = _chaos.hook("heartbeat.delay", member=self.member_id)
            if isinstance(res, (int, float)) and not isinstance(res, bool):
                skew = float(res)
        self.kv.set(f"{PREFIX}hb/{self.member_id}",
                    repr(self.clock() - skew))

    # -- agreement ---------------------------------------------------------
    def ack(self, view: MembershipView):
        """Adopt ``view``: the member-side half of agree-on-surviving-
        topology.  The coordinator (or the cluster runtime) waits for
        every surviving member's ack before declaring the epoch agreed
        and replanning onto it."""
        self.kv.set(f"{PREFIX}ack/{view.epoch}/{self.member_id}", "1")

    def latest_view(self) -> Optional[MembershipView]:
        return current_view(self.kv)
