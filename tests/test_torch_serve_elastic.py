"""The port's elastic serve fleet (``apex_tpu_torch/serve/elastic.py``)
against the JAX engine's tokens, on the CPU: the JAX serve tests' tiny GPT
(``torch_serve_refs``: the same weights in both packages) behind a
two- or three-replica ``ServeFleet`` over ``MemoryKV`` + ``SimClock``,
under the seeded chaos of ``tests/test_serve_elastic.py``.  Every fleet's
tokens equal the JAX unified engine's exactly (fp32 and int8 pools) with
and without a felled replica: live migration restores a session's blocks
verbatim, shedding re-queues the batch tier in recompute mode, a stale or
debris-only snapshot falls back to recompute.  Also: stale-epoch
submissions refused, a kill mid-snapshot leaving only rejected debris, an
adopter felled mid-migration, a successor coordinator mid-migration, the
delayed heartbeat that must not migrate, fleet-wide FIFO admission order,
and the port's snapshots, which hard-link the blocks that were full at a
session's previous snapshot instead of writing them again."""
import os
import zlib

import numpy as np
import pytest
import torch

from apex_tpu_torch.inference import make_self_draft
from apex_tpu_torch.runtime import chaos
from apex_tpu_torch.runtime.resilience import (CheckpointCorruptError,
                                               discard_kv_handoff,
                                               load_kv_handoff,
                                               read_kv_handoff_meta,
                                               stream_kv_handoff)
from apex_tpu_torch.serve import (Request, SLO_CLASSES, ServeEngine,
                                  ServeFleet, StaleEpochError)
from apex_tpu_torch.serve.pool import BlockPool, init_pool_buffer

import torch_serve_refs as refs

torch.set_num_threads(2)

SLOS = ["latency", "batch", "latency", "batch"]


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    """Empty the JAX step cache the JAX references filled."""
    from apex_tpu.runtime import step_cache
    yield
    step_cache.clear()


@pytest.fixture(autouse=True)
def _clean_chaos():
    yield
    chaos.uninstall()


@pytest.fixture(scope="module")
def model():
    return refs.models()[1]


@pytest.fixture(scope="module")
def base():
    """The JAX unified engine's tokens over the PROMPTS trace."""
    return refs.jax_refs()["prompts"]


def _reqs(max_new=refs.MAX_NEW, prefix="r"):
    return refs.prompt_reqs(Request, prefix, max_new=max_new)


def _fleet(model, tmp_path, **kw):
    kw.setdefault("n_engines", 2)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("snapshot_every", 2)
    kw.setdefault("miss_threshold", 2)
    kw.setdefault("snapshot_dir", str(tmp_path / "snaps"))
    return ServeFleet(model, **kw)


def _kill_member(member_id):
    def act(ctx):
        if ctx.get("member") == member_id:
            raise chaos.ChaosKilled(f"chaos: felled {member_id}")
    return act


def _assert_no_leaks(fleet):
    for m in fleet.members.values():
        if not m.closed:
            m.engine.block_pool.check_no_leaks()


# -- fleet basics ----------------------------------------------------------

def test_fleet_parity_no_chaos(model, base, tmp_path):
    with _fleet(model, tmp_path) as fleet:
        fleet.join()
        out = fleet.run(_reqs(), slos=SLOS)
        m = fleet.metrics()
        assert out == base
        assert m["epoch"] == 1 and m["completed"] == len(refs.PROMPTS)
        assert m["sessions_migrated"] == 0
        assert m["snapshot_bytes_peak_host"] > 0
        _assert_no_leaks(fleet)


def test_metrics_keys_and_surface_match_jax(model, tmp_path):
    """``metrics()`` carries the JAX fleet's keys (a JAX fleet built over
    the JAX model, never stepped), per member too."""
    from apex_tpu.serve import ServeFleet as JaxFleet
    jm = refs.models()[0]
    with JaxFleet(jm, n_engines=2, num_blocks=8, block_size=8) as jf, \
            _fleet(model, tmp_path, num_blocks=8) as tf:
        jf.join()
        tf.join()
        jmx, tmx = jf.metrics(), tf.metrics()
        assert sorted(tmx) == sorted(jmx)
        assert sorted(tmx["members"]["serve0"]) == \
            sorted(jmx["members"]["serve0"])
        assert {k: v for k, v in tmx.items() if k != "members"} == \
            {k: v for k, v in jmx.items() if k != "members"}
        assert tf.assignments() == {} and tf.tick == 0


def test_submit_validation(model, tmp_path):
    with _fleet(model, tmp_path) as fleet:
        with pytest.raises(RuntimeError, match="join"):
            fleet.submit(Request("x", (1, 2), 2))
        with pytest.raises(RuntimeError, match="join"):
            fleet.step()
        fleet.join()
        fleet.submit(Request("a", (1, 2), 2), slo="batch")
        with pytest.raises(ValueError, match="duplicate"):
            fleet.submit(Request("a", (1, 2), 2))
        with pytest.raises(ValueError, match="slo"):
            fleet.submit(Request("b", (1, 2), 2), slo="bulk")
        assert set(SLO_CLASSES) == {"latency", "batch"}
    with pytest.raises(ValueError, match="n_engines"):
        ServeFleet(model, n_engines=0, num_blocks=8)
    with pytest.raises(ValueError, match="entries"):
        ServeFleet(model, n_engines=2, num_blocks=[8, 8, 8])


def test_stale_epoch_refused(model, base, tmp_path):
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve0"), after=4, times=-1)
        with _fleet(model, tmp_path) as fleet:
            fleet.join()
            fleet.submit(Request("e1", (3, 4, 5), 3), epoch=1)
            while fleet.metrics()["epoch"] < 2:
                fleet.step()
            with pytest.raises(StaleEpochError):
                fleet.submit(Request("e2", (3, 4), 3), epoch=1)
            fleet.submit(Request("e3", (3, 4), 3), epoch=2)
            while fleet.has_work():
                fleet.step()
            assert set(fleet.results) == {"e1", "e3"}
            _assert_no_leaks(fleet)


# -- migration parity ------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", [None, "int8"],
                         ids=["fp32", "int8"])
def test_migration_bitwise_parity(model, tmp_path, cache_dtype):
    want = refs.jax_refs(cache_dtype)["prompts"]
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve0"), after=10, times=-1)
        with _fleet(model, tmp_path, cache_dtype=cache_dtype) as fleet:
            fleet.join()
            out = fleet.run(_reqs(), slos=SLOS)
            m = fleet.metrics()
    assert out == want
    assert m["epoch"] >= 2
    assert m["sessions_migrated"] >= 1
    assert m["detect_ms"] >= 0.0 and m["migrate_ms"] > 0.0
    assert not m["members"]["serve0"]["alive"]


def test_migration_mid_spec_decode(model, base, tmp_path):
    """A session migrated mid-speculative-decode restores its target KV
    verbatim, gets an EMPTY draft table, catches up through the
    survivor's prefill slot, and continues bit for bit; its first tokens
    are the JAX engine's (greedy speculation is lossless)."""
    draft = make_self_draft(model)
    eng = ServeEngine(model, num_blocks=64, block_size=8, max_batch=4,
                      prefill_chunk=4, draft=draft)
    want = eng.run(_reqs(16, "s"))
    eng.close()
    for i in range(len(refs.PROMPTS)):
        assert want[f"s{i}"][:refs.MAX_NEW] == base[f"r{i}"]
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve0"), after=6, times=-1)
        with _fleet(model, tmp_path, num_blocks=48, draft=draft) as fleet:
            fleet.join()
            out = fleet.run(_reqs(16, "s"), slos=SLOS)
            m = fleet.metrics()
    assert out == want
    assert m["sessions_migrated"] >= 1


def test_shrink_sheds_batch_tier_first(model, base, tmp_path):
    """Capacity loss: the batch tier is re-queued (NEVER dropped), the
    latency tier migrates; everyone still completes, bit for bit."""
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve1"), after=8, times=-1)
        with _fleet(model, tmp_path, num_blocks=24) as fleet:
            fleet.join()
            for r, s in zip(_reqs(), SLOS):
                fleet.submit(r, slo=s)
            shed_rids = set()
            while fleet.has_work():
                fleet.step()
                shed_rids |= {rid for rid, mid
                              in fleet.assignments().items()
                              if mid is None and rid in fleet._queue}
            out = dict(fleet.results)
            m = fleet.metrics()
    assert out == base
    assert m["completed"] == len(refs.PROMPTS)
    assert m["sessions_shed_requeued"] >= 1
    assert all(fleet.slo_of(rid) == "batch" for rid in shed_rids)


def test_stale_snapshot_falls_back_to_recompute(model, base, tmp_path):
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve0"), after=10, times=-1)
        with _fleet(model, tmp_path, snapshot_max_age_ticks=0) as fleet:
            fleet.join()
            out = fleet.run(_reqs(), slos=SLOS)
            m = fleet.metrics()
    assert out == base
    assert m["sessions_migrated"] == 0
    assert m["sessions_recomputed"] >= 1


# -- chaos durability ------------------------------------------------------

def test_kill_mid_snapshot_debris_rejected(model, base, tmp_path):
    """A replica killed half-way through a session snapshot leaves a
    manifest-less directory; recovery finds it, rejects it, and completes
    the session through an older snapshot or recompute, bit for bit."""
    with chaos.session(seed=0) as c:
        c.on("serve.kv_handoff", "kill", at=0)
        with _fleet(model, tmp_path) as fleet:
            fleet.join()
            out = fleet.run(_reqs(), slos=SLOS)
            m = fleet.metrics()
            assert any(p == "serve.kv_handoff" for p, _, _ in c.log)
    assert out == base
    assert m["epoch"] >= 2
    assert m["debris_rejected"] >= 1
    assert m["sessions_recomputed"] + m["sessions_migrated"] >= 1


def test_kill_mid_migrate_adopter_fells(model, base, tmp_path):
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve0"), after=15, times=-1)
        c.on("serve.migrate", "kill", at=0)
        with _fleet(model, tmp_path, n_engines=3, num_blocks=24) as fleet:
            fleet.join()
            out = fleet.run(_reqs(), slos=SLOS)
            m = fleet.metrics()
            felled = [mid for mid, mm in fleet.members.items()
                      if mm.closed]
    assert out == base
    assert len(felled) >= 2          # the victim AND the adopter died
    assert m["completed"] == len(refs.PROMPTS)


def test_migrate_fail_abandons_cleanly(model, base, tmp_path):
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve0"), after=10, times=-1)
        c.on("serve.migrate", "fail", at=0)
        with _fleet(model, tmp_path) as fleet:
            fleet.join()
            out = fleet.run(_reqs(), slos=SLOS)
            m = fleet.metrics()
    assert out == base
    assert m["sessions_recomputed"] >= 1


def test_coordinator_loss_mid_migration(model, base, tmp_path):
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve0"), after=10, times=-1)
        c.on("coordinator.loss", "kill", at=8)
        with _fleet(model, tmp_path, migrate_per_tick=1) as fleet:
            fleet.join()
            out = fleet.run(_reqs(), slos=SLOS)
            m = fleet.metrics()
            assert any(p == "coordinator.loss" for p, _, _ in c.log)
    assert out == base
    assert m["epoch"] >= 2
    assert m["completed"] == len(refs.PROMPTS)


def test_heartbeat_delay_never_migrates(model, base, tmp_path):
    with chaos.session(seed=0) as c:
        c.on("heartbeat.delay",
             lambda ctx: 0.3 if ctx.get("member") == "serve0" else None,
             at=4)
        with _fleet(model, tmp_path) as fleet:
            fleet.join()
            out = fleet.run(_reqs(), slos=SLOS)
            m = fleet.metrics()
            assert any(p == "heartbeat.delay" for p, _, _ in c.log)
    assert out == base
    assert m["epoch"] == 1
    assert m["sessions_migrated"] == 0 and m["sessions_recomputed"] == 0


# -- FIFO fairness ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_fifo_order_preserved_across_rehoming(model, tmp_path, seed):
    import random
    rng = random.Random(seed)
    n = 6
    reqs = [Request(f"p{i}", tuple(rng.randrange(1, 70)
                                   for _ in range(rng.randrange(2, 8))),
                    4) for i in range(n)]
    slos = [rng.choice(SLO_CLASSES) for _ in range(n)]
    kill_after = rng.randrange(6, 14)
    with chaos.session(seed=seed) as c:
        c.on("host.loss", _kill_member("serve1"), after=kill_after,
             times=-1)
        with _fleet(model, tmp_path, num_blocks=20, max_batch=2) as fleet:
            fleet.join()
            for r, s in zip(reqs, slos):
                fleet.submit(r, slo=s)
            seq_of = {rid: rec.seq for rid, rec in fleet._recs.items()}
            ticks = 0
            while fleet.has_work():
                fleet.step()
                ticks += 1
                assert ticks < 500, "fleet failed to converge"
                for m in fleet.members.values():
                    if m.closed:
                        continue
                    seqs = [seq_of[s.rid]
                            for s in m.engine.scheduler.queue]
                    assert seqs == sorted(seqs)
            assert set(fleet.results) == {r.rid for r in reqs}
            _assert_no_leaks(fleet)


# -- snapshots -------------------------------------------------------------

def test_kv_handoff_extra_meta_roundtrip(tmp_path):
    pool = init_pool_buffer(layers=1, heads=2, head_dim=4, num_blocks=8,
                            block_size=4, dtype=None, device="cpu")
    bp = BlockPool(8, 4)
    table = bp.alloc(2)
    d = str(tmp_path / "snap0")
    meta = {"rid": "r0", "out": [1, 2, 3], "pending_tok": 3,
            "position": 7, "slo": "latency", "tick": 4, "epoch": 2}
    manifest, _peak = stream_kv_handoff(d, pool, table,
                                        source="snapshot:r0",
                                        extra_meta=meta)
    assert manifest["meta"] == meta
    back = read_kv_handoff_meta(d)
    assert back["meta"] == meta and back["n_blocks"] == 2
    os.remove(os.path.join(d, "KV_MANIFEST.pkl"))
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        read_kv_handoff_meta(d)
    bp.free(table)
    bp.check_no_leaks()


@pytest.mark.parametrize("cache_dtype", [None, "int8"],
                         ids=["fp32", "int8"])
def test_linked_snapshot_is_a_complete_handoff(tmp_path, cache_dtype):
    """``stream_kv_handoff(link_from=...)`` hard-links the first n blocks'
    files from an earlier handoff and writes the rest (here a block
    changed in the pool since, and a new one): the manifest equals a full
    stream's, only the linked files share their inodes, and once the
    earlier directory is discarded the linked one still loads every block
    verbatim (CRC checked)."""
    g = torch.Generator().manual_seed(3)
    pool = init_pool_buffer(layers=2, heads=2, head_dim=4, num_blocks=8,
                            block_size=4, dtype=cache_dtype, device="cpu")
    for t in (pool.q, pool.scale) if cache_dtype else (pool,):
        t.copy_(torch.randint(-100, 100, t.shape, generator=g).to(t.dtype))
    table = [3, 5, 6]
    a, b, full = (str(tmp_path / n) for n in ("a", "b", "full"))
    ma, _ = stream_kv_handoff(a, pool, table[:2])
    for t in (pool.q, pool.scale) if cache_dtype else (pool,):
        t[:, :, table[1], 0] += 1          # the second block changes
    mb, peak_b = stream_kv_handoff(b, pool, table,
                                   link_from=(a, ma["blocks"], 1))
    mf, peak_f = stream_kv_handoff(full, pool, table)
    assert mb["blocks"] == mf["blocks"] and peak_b == peak_f
    for part in mb["blocks"][0]:
        name = mb["blocks"][0][part]["file"]
        assert os.stat(os.path.join(a, name)).st_ino == \
            os.stat(os.path.join(b, name)).st_ino
        name = mb["blocks"][1][part]["file"]
        assert os.stat(os.path.join(a, name)).st_ino != \
            os.stat(os.path.join(b, name)).st_ino
    discard_kv_handoff(a)
    fresh = init_pool_buffer(layers=2, heads=2, head_dim=4, num_blocks=8,
                             block_size=4, dtype=cache_dtype, device="cpu")
    load_kv_handoff(b, fresh, [1, 2, 4])
    for src, dst in zip(table, [1, 2, 4]):
        for p, q in ((pool.q, fresh.q), (pool.scale, fresh.scale)) \
                if cache_dtype else ((pool, fresh),):
            assert torch.equal(p[:, :, src], q[:, :, dst])


def test_fleet_snapshots_link_full_blocks(model, base, tmp_path,
                                         monkeypatch):
    """In a fleet run every snapshot after a session's first re-uses the
    files of the blocks that were full at its previous snapshot (one inode,
    several snapshots), each such block's bytes in the pool still having
    the CRC32 its linked file records (the rule the links rest on: a full
    block does not change while its session stays admitted), and a
    session that migrates from such a snapshot continues bit for bit."""
    import apex_tpu_torch.serve.elastic as el
    seen = {}
    real = stream_kv_handoff

    def spy(d, pool, table, **kw):
        manifest, peak = real(d, pool, table, **kw)
        link = kw.get("link_from")
        for i in range(link[2] if link else 0):
            now = pool[:, :, int(table[i])].contiguous().numpy().tobytes()
            assert zlib.crc32(now) == manifest["blocks"][i]["kv"]["crc32"]
        seen.setdefault(kw["source"], []).append(
            (len(table), link[2] if link else 0,
             [os.stat(os.path.join(d, e["kv"]["file"])).st_ino
              for e in manifest["blocks"]]))
        return manifest, peak
    monkeypatch.setattr(el, "stream_kv_handoff", spy)
    long = [Request(f"L{i}", tuple(range(1 + i, 20 + i)), 20)
            for i in range(2)]
    with _fleet(model, tmp_path) as fleet:
        fleet.join()
        fleet.run(long)
    assert any(n > 0 for snaps in seen.values() for _, n, _ in snaps)
    for snaps in seen.values():
        for (_, _, prev), (nb, n, cur) in zip(snaps, snaps[1:]):
            assert cur[:n] == prev[:n] and n <= nb
    with chaos.session(seed=0) as c:
        c.on("host.loss", _kill_member("serve0"), after=10, times=-1)
        with _fleet(model, tmp_path / "k") as fleet:
            fleet.join()
            out = fleet.run(_reqs(), slos=SLOS)
            m = fleet.metrics()
    assert out == base and m["sessions_migrated"] >= 1
    assert np.isfinite(m["migrate_ms"])
