"""The multi-host elastic cycle's host half, the PyTorch counterpart of
``apex_tpu/cluster/runtime.py``: the deterministic clock, the simulated
host, one membership cycle (:func:`beat_and_scan`, which the serve fleet
runs every tick) and real member processes over a :class:`FileKV`.

The JAX module also lifts ``runtime.elastic``'s one-process recovery
across hosts: :class:`ClusterTrainer` re-plans the surviving fleet's
device union through the planner (:func:`fleet_for_members` builds that
planner's ``Fleet``) and streams the newest checkpoint into the new
layout.  The port has neither the planner nor elastic restore yet
(ROADMAP A9): those two names keep their signatures and refuse.

Process-boundary rule for :class:`~apex_tpu_torch.runtime.chaos.ChaosKilled`:
a kill is never caught to continue the killed operation; the simulation
converts it AT the process boundary instead.  A member felled in a cycle
stays dead (its agent never beats again); a felled coordinator is
replaced by a NEW ``Coordinator`` object over the same KV store, exactly
what a restarted coordinator process would construct.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, Optional

from .._unported import refuse
from ..runtime import chaos as _chaos
from .kvstore import KVStore
from .membership import Member, MembershipView, current_view

_A9 = "ROADMAP A9, the planner (parallel/auto.py) and elastic restore " \
      "(runtime/elastic.py) that the cluster trainer re-plans through"


class SimClock:
    """Deterministic time source shared by members and coordinator:
    call it for "now", :meth:`advance` to move time forward.  Tests
    drive heartbeat deadlines without ever sleeping."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, seconds: float) -> float:
        self._t += float(seconds)
        return self._t


class SimHost:
    """One simulated host: a membership agent plus the device slice it
    owns and the chip spec it registers (``chip`` a name of the JAX
    planner's ``CHIPS``; ``scale`` < 1 declares a straggler)."""

    def __init__(self, member: Member, devices, *, chip: str = "cpu",
                 scale: float = 1.0):
        self.member = member
        self.devices = list(devices)
        self.chip = chip
        self.scale = float(scale)

    @property
    def member_id(self) -> str:
        return self.member.member_id

    @property
    def alive(self) -> bool:
        return self.member.alive


def _host_spec(chip: str, scale: float, n_devices: int) -> str:
    return json.dumps({"chip": chip, "scale": scale,
                       "n_devices": n_devices})


def beat_and_scan(kv: KVStore, clock: SimClock, members, coordinator,
                  make_coordinator, *, advance_s: float,
                  fallback_view: Optional[MembershipView] = None):
    """One membership cycle (the serve fleet's every tick,
    :class:`apex_tpu_torch.serve.elastic.ServeFleet`): advance the clock,
    every live member beats, the coordinator scans.  ``ChaosKilled``
    converts at the process boundary, as the module docstring demands: a
    felled member is marked dead and reported (its agent never beats
    again); a felled coordinator is replaced by ``make_coordinator()``
    (what a restarted coordinator process would construct over the same
    store) and the previously published view stands until its first
    scan.  Returns ``(view, coordinator, felled_member_ids)``."""
    clock.advance(advance_s)
    felled = []
    for m in members:
        if not m.alive:
            continue
        try:
            m.beat()
        except _chaos.ChaosKilled:
            m.alive = False              # the host process is gone
            felled.append(m.member_id)
    try:
        view = coordinator.scan()
    except _chaos.ChaosKilled:
        coordinator = make_coordinator()
        view = current_view(kv) or fallback_view
    return view, coordinator, felled


def fleet_for_members(kv: KVStore, members) -> "object":
    """The JAX planner's ``Fleet`` from the REGISTERED specs of
    ``members``: refused, the port has no planner yet (ROADMAP A9)."""
    refuse("cluster.fleet_for_members (the planner's Fleet)", _A9)


class ClusterTrainer:
    """Multi-host elastic training over ``runtime.elastic``'s trainer and
    the planner's heterogeneous fleets: refused, the port has neither yet
    (ROADMAP A9).  The JAX signature is kept."""

    def __init__(self, manager, model, optimizer, loss_fn: Callable, *,
                 example_batch, n_hosts: int = 2, devices=None,
                 kv: Optional[KVStore] = None,
                 clock: Optional[SimClock] = None,
                 deadline_s: float = 0.25, miss_threshold: int = 2,
                 chip: str = "cpu", host_scales=None,
                 plan_options: Optional[dict] = None,
                 plan_filter: Optional[Callable] = None, **step_kwargs):
        refuse("cluster.ClusterTrainer (elastic training across hosts)",
               _A9)


def spawn_member_process(kv_dir: str, member_id: str, *,
                         interval_s: float = 0.05, beats: int = 100,
                         spec: str = "") -> subprocess.Popen:
    """Spawn a REAL OS process that joins membership over a
    :class:`~apex_tpu_torch.cluster.kvstore.FileKV` at ``kv_dir`` and
    heartbeats ``beats`` times at ``interval_s`` (a coordinator in the
    parent detects these children exactly as it detects simulated
    members).  The child imports only this package's ``cluster`` and
    exits cleanly after its beats run out, which a coordinator observes
    as host loss.  The caller owns the process: wait for it or kill it."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {root!r})\n"
        "from apex_tpu_torch.cluster.kvstore import FileKV\n"
        "from apex_tpu_torch.cluster.membership import Member\n"
        f"m = Member(FileKV({kv_dir!r}), {member_id!r}, spec={spec!r})\n"
        "m.join()\n"
        f"for _ in range({int(beats)}):\n"
        f"    time.sleep({float(interval_s)!r})\n"
        "    m.beat()\n")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
