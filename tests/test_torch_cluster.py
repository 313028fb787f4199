"""The port's cluster membership (``apex_tpu_torch.cluster``) against the
JAX package's, on the CPU: each protocol scenario of
``tests/test_cluster.py`` (join, ack, graceful leave, consecutive-miss
detection under the ``heartbeat.delay`` guard, a successor coordinator)
runs step by step under a ``SimClock`` through both packages, and every
view, epoch and the whole KV store must be equal (exactly: the protocol is
strings and floats).  Then the KV substrates (``FileKV`` across instances
and its tmp debris, ``JaxCoordinatorKV`` over a one-rank gloo group's
store, ``default_kv``'s order), a REAL member process detected lost, and
the presence registry that two gloo ranks join through
``init_distributed``, read by a ``Coordinator`` over the same store.
``ClusterTrainer`` and ``fleet_for_members`` (the JAX tests' elastic
training and planner cases) are ROADMAP A9 and refuse."""
import os
import socket
import subprocess
import sys
import time
import types

import pytest
import torch

import apex_tpu.cluster as jax_cluster
from apex_tpu.runtime import chaos as jax_chaos

import apex_tpu_torch.cluster as cluster
from apex_tpu_torch.cluster import (Coordinator, FileKV, JaxCoordinatorKV,
                                    Member, MemoryKV, PREFIX, SimClock,
                                    current_epoch, default_kv,
                                    spawn_member_process)
from apex_tpu_torch.runtime import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(c=jax_cluster, chaos=jax_chaos)
PORT = types.SimpleNamespace(c=cluster, chaos=chaos)


@pytest.fixture(autouse=True)
def _clean_chaos():
    yield
    chaos.uninstall()
    jax_chaos.uninstall()


def _both(scenario):
    """``scenario(ns, kv, clock) -> trace`` through each package over a
    fresh MemoryKV and SimClock; the traces and the final stores must be
    equal.  Returns the port's trace."""
    out = []
    for ns in (JAX, PORT):
        kv, clock = ns.c.MemoryKV(), ns.c.SimClock()
        out.append((scenario(ns, kv, clock), dict(kv._data)))
    assert out[0] == out[1]
    return out[1][0]


def _view(v):
    return (v.epoch, tuple(v.members))


# ---------------------------------------------------------------------------
# the protocol, step by step against the JAX package
# ---------------------------------------------------------------------------


def test_join_scan_publishes_epoch1_and_acks():
    def scenario(ns, kv, clock):
        members = [ns.c.Member(kv, f"h{i}", clock=clock).join()
                   for i in range(3)]
        coord = ns.c.Coordinator(kv, deadline_s=1.0, miss_threshold=2,
                                 clock=clock)
        view = coord.scan()
        trace = [_view(view), ns.c.current_epoch(kv), coord.acked(view)]
        for m in members:
            m.ack(view)
        trace.append(coord.acked(view))
        clock.advance(0.5)
        for m in members:
            m.beat()
        trace += [_view(coord.scan()), _view(members[0].latest_view())]
        return trace
    trace = _both(scenario)
    assert trace == [(1, ("h0", "h1", "h2")), 1, False, True,
                     (1, ("h0", "h1", "h2")), (1, ("h0", "h1", "h2"))]


def test_graceful_leave_drops_without_waiting_out_misses():
    def scenario(ns, kv, clock):
        members = [ns.c.Member(kv, f"h{i}", clock=clock).join()
                   for i in range(3)]
        coord = ns.c.Coordinator(kv, deadline_s=1.0, miss_threshold=5,
                                 clock=clock)
        trace = [_view(coord.scan())]
        members[1].leave()
        trace.append(_view(coord.scan()))
        return trace
    assert _both(scenario) == [(1, ("h0", "h1", "h2")), (2, ("h0", "h2"))]


def test_consecutive_miss_detection_and_heartbeat_delay_guard():
    def scenario(ns, kv, clock):
        m0 = ns.c.Member(kv, "h0", clock=clock).join()
        m1 = ns.c.Member(kv, "h1", clock=clock).join()
        coord = ns.c.Coordinator(kv, deadline_s=0.25, miss_threshold=2,
                                 clock=clock)
        trace = [_view(coord.scan())]
        clock.advance(0.3)              # one stale scan is not death
        m0.beat()
        trace.append(_view(coord.scan()))
        clock.advance(0.3)              # a fresh beat resets the counter
        m0.beat()
        m1.beat()
        trace.append(_view(coord.scan()))
        skewed = []

        def delay(ctx):
            # h1's next beat only lands 10 s in the past
            if ctx["member"] == "h1" and not skewed:
                skewed.append(ctx["member"])
                return 10.0
            return None
        with ns.chaos.session(seed=0) as c:
            c.on("heartbeat.delay", action=delay, times=-1)
            clock.advance(0.1)
            m0.beat()
            m1.beat()                   # lands skewed 10 s backwards
            trace.append((_view(coord.scan()), dict(coord.misses)))
            clock.advance(0.1)
            m0.beat()
            m1.beat()
            trace.append((_view(coord.scan()), dict(coord.misses)))
        for _ in range(2):              # two CONSECUTIVE stale scans
            clock.advance(0.3)
            m0.beat()
            trace.append(_view(coord.scan()))
        return trace
    trace = _both(scenario)
    assert trace[3] == ((1, ("h0", "h1")), {"h0": 0, "h1": 1})
    assert trace[-1] == (2, ("h0",))


def test_epoch_survives_coordinator_loss_without_resurrection():
    def scenario(ns, kv, clock):
        m0 = ns.c.Member(kv, "h0", clock=clock).join()
        ns.c.Member(kv, "h1", clock=clock).join()   # then silently dies
        coord = ns.c.Coordinator(kv, deadline_s=0.25, miss_threshold=2,
                                 clock=clock)
        trace = [_view(coord.scan())]
        for _ in range(2):
            clock.advance(0.3)
            m0.beat()
            trace.append(_view(coord.scan()))
        successor = ns.c.Coordinator(kv, deadline_s=0.25, miss_threshold=2,
                                     clock=clock)
        clock.advance(0.1)
        m0.beat()
        trace.append(_view(successor.scan()))
        m1b = ns.c.Member(kv, "h1", clock=clock)
        m1b.alive = True
        m1b.beat()                      # only a FRESH beat readmits h1
        trace.append(_view(successor.scan()))
        return trace
    trace = _both(scenario)
    assert trace[-3:] == [(2, ("h0",)), (2, ("h0",)), (3, ("h0", "h1"))]


def _kill(member_id, ns):
    def act(ctx):
        if ctx.get("member") == member_id:
            raise ns.chaos.ChaosKilled(f"{member_id} died")
    return act


def test_beat_and_scan_converts_kills_at_the_boundary():
    """The serve fleet's membership cycle: a host felled by ``host.loss``
    stays dead and drops out after ``miss_threshold`` scans; a coordinator
    felled by ``coordinator.loss`` is rebuilt over the same store, the
    published view standing until its first scan, epochs monotonic."""
    def scenario(ns, kv, clock):
        members = [ns.c.Member(kv, f"h{i}", clock=clock).join()
                   for i in range(3)]

        def make():
            return ns.c.Coordinator(kv, deadline_s=0.25, miss_threshold=2,
                                    clock=clock)
        coord = make()
        view = coord.scan()
        trace = [_view(view)]
        with ns.chaos.session(seed=0) as c:
            c.on("host.loss", action=_kill("h2", ns), times=-1)
            for _ in range(3):
                view, coord, felled = ns.c.beat_and_scan(
                    kv, clock, members, coord, make, advance_s=0.15,
                    fallback_view=view)
                trace.append((_view(view), felled))
        first = coord
        with ns.chaos.session(seed=0) as c:
            c.on("coordinator.loss", action="kill", at=0)
            view, coord, felled = ns.c.beat_and_scan(
                kv, clock, members, coord, make, advance_s=0.1,
                fallback_view=view)
        trace.append((_view(view), coord is not first, felled))
        view, coord, _ = ns.c.beat_and_scan(kv, clock, members, coord, make,
                                            advance_s=0.1)
        trace.append((_view(view), [m.alive for m in members]))
        return trace
    trace = _both(scenario)
    assert trace[1][1] == ["h2"] and trace[-1] == ((2, ("h0", "h1")),
                                                   [True, True, False])
    assert trace[-2][1] is True


def test_sim_host_and_refusals():
    kv, clock = MemoryKV(), SimClock(5.0)
    host = cluster.SimHost(Member(kv, "host0", clock=clock), ["d0", "d1"],
                           chip="cpu", scale=0.5)
    assert (host.member_id, host.alive, host.devices, host.scale) == \
        ("host0", False, ["d0", "d1"], 0.5)
    assert clock.advance(1.5) == 6.5 == clock()
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        cluster.fleet_for_members(kv, ["host0"])
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        cluster.ClusterTrainer("/nonexistent", None, None, None,
                               example_batch=None)
    with pytest.raises(ValueError, match="miss_threshold"):
        Coordinator(kv, miss_threshold=0)
    with pytest.raises(RuntimeError, match="not joined"):
        Member(kv, "x").beat()
    assert sorted(cluster.__all__) == sorted(jax_cluster.__all__)


# ---------------------------------------------------------------------------
# the KV substrates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make_kv", [lambda tmp: MemoryKV(),
                                     lambda tmp: FileKV(str(tmp / "kv"))],
                         ids=["memory", "file"])
def test_kvstore_roundtrip_and_scan(tmp_path, make_kv):
    kv = make_kv(tmp_path)
    assert kv.get("absent") is None
    kv.set(f"{PREFIX}hb/host0", "1.5")
    kv.set(f"{PREFIX}hb/host1", "2.5")
    kv.set(f"{PREFIX}epoch", 3)
    assert kv.get(f"{PREFIX}hb/host0") == "1.5"
    assert kv.get(f"{PREFIX}epoch") == "3"
    assert kv.scan(f"{PREFIX}hb/") == {f"{PREFIX}hb/host0": "1.5",
                                       f"{PREFIX}hb/host1": "2.5"}
    kv.delete(f"{PREFIX}hb/host0")
    assert kv.get(f"{PREFIX}hb/host0") is None
    assert set(kv.scan(f"{PREFIX}hb/")) == {f"{PREFIX}hb/host1"}
    kv.delete(f"{PREFIX}hb/host0")          # idempotent


def test_file_kv_crosses_instances_and_skips_tmp_debris(tmp_path):
    a = FileKV(str(tmp_path / "kv"))
    b = FileKV(str(tmp_path / "kv"))        # a second "process"
    a.set(f"{PREFIX}members/h0", '{"chip": "cpu"}')
    assert b.get(f"{PREFIX}members/h0") == '{"chip": "cpu"}'
    (tmp_path / "kv" / "whatever.tmp.123").write_text("partial")
    assert set(b.scan(PREFIX)) == {f"{PREFIX}members/h0"}
    # the JAX package's FileKV reads the same directory: one format
    j = jax_cluster.FileKV(str(tmp_path / "kv"))
    assert j.scan(PREFIX) == b.scan(PREFIX)


def test_coordinator_kv_over_a_store_matches_the_jax_semantics():
    """``JaxCoordinatorKV`` over a c10d store (a ``HashStore`` here): the
    index key backs ``scan``, ``delete`` is the JAX tombstone ``""``
    (``get`` returns it, ``scan`` skips it), a missing key is None, and
    the membership protocol runs over it exactly as over a MemoryKV."""
    kv = JaxCoordinatorKV(torch.distributed.HashStore())
    assert kv.get("absent") is None
    kv.set(f"{PREFIX}hb/a", 1.25)
    kv.set(f"{PREFIX}hb/b", "x")
    kv.set(f"{PREFIX}hb/a", "2.5")          # indexed once
    assert kv._index() == [f"{PREFIX}hb/a", f"{PREFIX}hb/b"]
    kv.delete(f"{PREFIX}hb/a")
    assert kv.get(f"{PREFIX}hb/a") == ""
    assert kv.scan(f"{PREFIX}hb/") == {f"{PREFIX}hb/b": "x"}
    clock, mem, mclock = SimClock(), MemoryKV(), SimClock()
    views = []
    for store, clk in ((kv, clock), (mem, mclock)):
        m = [Member(store, f"h{i}", clock=clk).join() for i in range(2)]
        coord = Coordinator(store, deadline_s=0.25, clock=clk)
        views.append([_view(coord.scan())])
        m[1].leave()
        views[-1].append(_view(coord.scan()))
    assert views[0] == views[1] == [(1, ("h0", "h1")), (2, ("h0",))]


class _CountingStore:
    """A c10d store whose calls are counted by method name."""

    def __init__(self, store):
        self.store, self.calls = store, {}

    def __getattr__(self, name):
        fn = getattr(self.store, name)

        def counted(*a):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a)
        return counted


def test_coordinator_kv_round_trips_and_pruned_index():
    """``JaxCoordinatorKV``'s store traffic: a key set once is set again
    with one ``set`` (a heartbeat reads no index), a scan is one index
    read (a ``check`` and a ``get``), then one ``check`` and one
    ``multi_get`` however many keys match, and
    each new epoch takes the older epochs' views and acks out of the
    index (their values stay readable by ``get``), while the views and
    epochs stay those of a MemoryKV run."""
    store = _CountingStore(torch.distributed.HashStore())
    kv = JaxCoordinatorKV(store)
    kv.set(f"{PREFIX}hb/a", "1.0")
    store.calls.clear()
    kv.set(f"{PREFIX}hb/a", "2.0")
    assert store.calls == {"set": 1}
    for i in range(5):
        kv.set(f"{PREFIX}hb/x{i}", str(i))
    store.calls.clear()
    assert kv.scan(f"{PREFIX}hb/x") == {f"{PREFIX}hb/x{i}": str(i)
                                        for i in range(5)}
    assert store.calls == {"check": 2, "get": 1, "multi_get": 1}
    views = []
    for store_kv in (kv, MemoryKV()):
        clock = SimClock()
        m = [Member(store_kv, f"h{i}", clock=clock).join() for i in range(3)]
        coord = Coordinator(store_kv, deadline_s=0.25, clock=clock)
        trace = []
        for leaver in (2, 1):
            v = coord.scan()
            for mm in m:
                if mm.member_id in v.members:
                    mm.ack(v)
            assert coord.acked(v)
            trace.append(_view(v))
            m[leaver].leave()
        trace.append(_view(coord.scan()))
        views.append(trace)
    assert views[0] == views[1] == [(1, ("h0", "h1", "h2")),
                                    (2, ("h0", "h1")), (3, ("h0",))]
    idx = kv._index()
    assert not [k for k in idx if k.startswith((f"{PREFIX}ack/1/",
                                                f"{PREFIX}ack/2/",
                                                f"{PREFIX}view/1",
                                                f"{PREFIX}view/2"))]
    assert f"{PREFIX}view/3" in idx and f"{PREFIX}view/current" in idx
    assert kv.get(f"{PREFIX}ack/1/h2") == "1"
    assert _view(cluster.MembershipView.from_json(
        kv.get(f"{PREFIX}view/1"))) == (1, ("h0", "h1", "h2"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_coordinator_kv_and_default_kv_over_a_one_rank_gloo_group(
        tmp_path, monkeypatch):
    """With no process group ``default_kv`` resolves the exported FileKV
    directory, else a fresh MemoryKV; once a (one-rank, gloo) group is up
    it resolves that group's store, which ``JaxCoordinatorKV.client``
    returns, and the protocol runs over it."""
    import torch.distributed as dist
    assert JaxCoordinatorKV.client() is None
    with pytest.raises(RuntimeError, match="init_distributed"):
        JaxCoordinatorKV()
    monkeypatch.delenv("APEX_TPU_CLUSTER_KV", raising=False)
    assert type(default_kv()) is MemoryKV
    monkeypatch.setenv("APEX_TPU_CLUSTER_KV", str(tmp_path / "kv"))
    fkv = default_kv()
    assert type(fkv) is FileKV and fkv.directory == str(tmp_path / "kv")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        kv = default_kv()
        assert type(kv) is JaxCoordinatorKV
        assert kv._client is JaxCoordinatorKV.client()
        m = Member(kv, "0", spec="here").join()
        coord = Coordinator(kv, deadline_s=60.0)
        assert _view(coord.scan()) == (1, ("0",))
        m.ack(coord.scan())
        assert coord.acked(cluster.current_view(kv))
        assert current_epoch(kv) == 1
    finally:
        dist.destroy_process_group()
    assert JaxCoordinatorKV.client() is None


# ---------------------------------------------------------------------------
# real processes
# ---------------------------------------------------------------------------


def test_spawned_member_process_joins_and_is_detected_lost(tmp_path):
    """spawn_member_process heartbeats over a FileKV from a REAL child
    (which imports only the port's ``cluster``); a coordinator here admits
    it, then detects the loss when the child's beats run out."""
    kv = FileKV(str(tmp_path / "kv"))
    proc = spawn_member_process(str(tmp_path / "kv"), "proc0",
                                interval_s=0.05, beats=20,
                                spec='{"chip": "cpu", "n_devices": 1}')
    try:
        coord = Coordinator(kv, deadline_s=0.5, miss_threshold=2)
        deadline = time.monotonic() + 60.0
        view = None
        while time.monotonic() < deadline:
            view = coord.scan()
            if "proc0" in view.members:
                break
            time.sleep(0.1)
        assert view is not None and "proc0" in view.members
        assert proc.wait(timeout=60.0) == 0     # beats run out, clean exit
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            view = coord.scan()
            if "proc0" not in view.members:
                break
            time.sleep(0.2)
        assert "proc0" not in view.members and view.epoch >= 2
        assert kv.get(f"{PREFIX}members/proc0") == \
            '{"chip": "cpu", "n_devices": 1}'
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


PRESENCE_WORKER = r'''
import os, sys
import torch
import torch.distributed as dist
from apex_tpu_torch import parallel
from apex_tpu_torch.cluster import Coordinator, JaxCoordinatorKV, PREFIX
from apex_tpu_torch.parallel import distributed as D

parallel.init_distributed(device="cpu")
r = parallel.rank()
dist.barrier()                  # both ranks have announced themselves
kv = JaxCoordinatorKV()
res = {"missing": D.missing_ranks(),
       "registered": sorted(kv.scan(f"{PREFIX}members/"))}
if r == 0:
    coord = Coordinator(kv, deadline_s=600.0, miss_threshold=2)
    view = coord.scan()
    res["view"] = (view.epoch, list(view.members))
dist.barrier()
torch.save(res, os.path.join(sys.argv[1], f"rank{r}.pt"))
dist.barrier()
dist.destroy_process_group()
'''


def test_presence_registry_is_the_cluster_member_table(tmp_path):
    """Two gloo ranks through the port's launcher: ``init_distributed``
    joins each rank as a cluster ``Member`` over the group's store, so
    ``missing_ranks`` finds none and a ``Coordinator`` over the same store
    publishes both ranks in its first view (one registry, two
    consumers)."""
    worker = tmp_path / "worker.py"
    worker.write_text(PRESENCE_WORKER)
    env = dict(os.environ, APEX_TPU_COORD_PORT=str(_free_port()),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    run = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc", "--nproc",
         "2", str(worker), str(tmp_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in range(2))
    want = [f"{PREFIX}members/0", f"{PREFIX}members/1"]
    assert r0["registered"] == r1["registered"] == want
    assert r0["missing"] == r1["missing"] == []
    assert r0["view"] == (1, ["0", "1"])
