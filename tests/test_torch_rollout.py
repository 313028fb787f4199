"""The port's generate-then-train loop (``apex_tpu_torch/rollout``) against
``apex_tpu/rollout``, on the CPU, over the JAX rollout tests' tiny GPT
(vocab 73, hidden 32, 2 layers; the port's weights carried from the JAX
model by ``from_jax_state_dict``).

* The buffer draws the JAX buffer's windows (numpy's generator, the same
  draws: equal arrays), evicts, refuses and round-trips its state as the
  JAX buffer does, and either loads the other's state dict.
* A publish is one ``weight_publish`` executor dispatch that copies the
  masters INTO the serve parameters: after it every serve parameter
  equals its master bit for bit (cast where the serve dtype differs), the
  parameters are the same tensors (nothing rebound), and no serve program
  compiles again.  Its stats differ from the JAX package's on the CPU by
  design: the port always donates, so ``cast_dispatch`` is True,
  ``zero_copy`` 0 and ``bytes_moved`` the parameters' bytes, which is the
  JAX publisher's own behaviour under donation.
* Two rounds of the loop generate the JAX loop's tokens exactly and train
  to its losses within the train-step tests' tolerance (rtol 1e-4, atol
  1e-5: bf16 half copies on both sides, reductions in other orders); the
  rest pins the port's own loop: seeded trajectories equal bit for bit,
  staleness eviction, backpressure, no leaked block, cataloged metrics,
  the draft's acceptance rising over three distillation publishes, and a
  run killed by chaos and resumed from its checkpoint equal bit for bit
  to the uninterrupted run.

The JAX reference runs once a process and empties the JAX step cache
after it."""
import functools

import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.models.gpt import GptModel as JaxGpt

from apex_tpu_torch import nn
from apex_tpu_torch.inference.draft import make_self_draft
from apex_tpu_torch.models import GptModel, from_jax_state_dict
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.observe import registry as obs
from apex_tpu_torch.observe.catalog import CATALOG
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.rollout import (OnlineDistiller, RolloutBuffer,
                                    RolloutRuntime, RolloutSample,
                                    WeightPublisher, master_leaves)
from apex_tpu_torch.runtime import chaos
from apex_tpu_torch.runtime import executor as ex
from apex_tpu_torch.runtime import step_cache as sc
from apex_tpu_torch.runtime.resilience import CheckpointManager
from apex_tpu_torch.serve import Request, ServeEngine
from apex_tpu_torch.training import make_train_step

from torch_decode_pairs import sd

torch.set_num_threads(2)

V = 73
CFG = dict(vocab_size=V, hidden=32, layers=2, heads=4, max_positions=96,
           dropout=0.0, attn_dropout=0.0)
#: the train-step tests' tolerance for the port's losses against JAX's
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _clean_chaos():
    yield
    chaos.uninstall()


def _gpt(seed):
    """The port's copy of the JAX tests' ``_gpt(seed)``."""
    jnn.manual_seed(seed)
    jm = JaxGpt(**CFG)
    return from_jax_state_dict(GptModel(**CFG, device="cpu"), sd(jm))


def _lm_loss(logits, ids):
    flat = logits[:, :-1].reshape((-1, V))
    tgt = ids[:, 1:].reshape((-1,))
    return F.cross_entropy(flat, tgt)


def _train_step(model, lr=1e-3):
    opt = FusedAdam(list(model.parameters()), lr=lr)
    return make_train_step(model, opt, _lm_loss, loss_scale=1.0)


LOOP = dict(capacity=16, max_staleness=2, rollouts_per_round=4,
            train_batch=4, train_steps_per_round=2, publish_every=1,
            prompt_len=6, max_new_tokens=6, seq_len=16)


def _loop(*, distill=False, seed=0, num_blocks=64, **kw):
    """A fresh, seeded loop as the JAX tests build it: train model, its
    serve copy, engine, fused step, optional online distiller, runtime."""
    train_m = _gpt(6)
    serve_m = make_self_draft(train_m)
    draft = draft_master = None
    if distill:
        draft_master = _gpt(99)
        draft = make_self_draft(draft_master)
    eng = ServeEngine(serve_m, num_blocks=num_blocks, block_size=8,
                      max_batch=4, prefill_chunk=4, draft=draft,
                      spec_k=4, spec_policy="on")
    step = _train_step(train_m)
    dist = OnlineDistiller(eng, draft_master, lr=1e-3) if distill \
        else None
    rt = RolloutRuntime(eng, step, distiller=dist, seed=seed,
                        **{**LOOP, **kw})
    return eng, step, rt


@functools.cache
def jax_loop_refs():
    """The JAX loop (seed 11, the JAX trajectory test's) over 2 rounds:
    its round records, losses, buffer samples and masters, and the
    windows a JAX buffer draws; the JAX step cache emptied after."""
    from apex_tpu.inference.draft import make_self_draft as jax_self_draft
    from apex_tpu.nn import functional as JF
    from apex_tpu.optimizers.fused_adam import FusedAdam as JaxAdam
    from apex_tpu.rollout import RolloutRuntime as JaxRuntime
    from apex_tpu.runtime import step_cache
    from apex_tpu.serve.engine import ServeEngine as JaxEngine
    from apex_tpu.training.step import make_train_step as jax_step

    def loss(logits, ids):
        return JF.cross_entropy(logits[:, :-1].reshape((-1, V)),
                                ids[:, 1:].reshape((-1,)))
    jnn.manual_seed(6)
    train_m = JaxGpt(**CFG)
    eng = JaxEngine(jax_self_draft(train_m), num_blocks=64, block_size=8,
                    max_batch=4, prefill_chunk=4)
    step = jax_step(train_m, JaxAdam(list(train_m.parameters()), lr=1e-3),
                    loss, loss_scale=1.0)
    rt = JaxRuntime(eng, step, seed=11, **LOOP)
    recs = rt.run(2)
    out = dict(recs=recs, losses=list(rt.losses),
               samples=[(s.rid, s.tokens.copy(), s.weight_epoch)
                        for s in rt.buffer._samples],
               buffer=rt.buffer.state_dict(),
               masters=[np.asarray(m) for m in master_leaves(step)],
               epochs=dict(eng.weight_epochs))
    eng.close()
    step_cache.clear()
    return out


# ---------------------------------------------------------------------------
# buffer: staleness, backpressure, seeded replay, against the JAX buffer
# ---------------------------------------------------------------------------


def _sample(cls, rid, epoch, n=12):
    toks = np.arange(n, dtype=np.int32) % V
    return cls(rid=rid, tokens=toks, prompt_len=4, weight_epoch=epoch)


def test_buffer_staleness_eviction_matches_jax():
    from apex_tpu.rollout import buffer as jb

    from apex_tpu_torch.rollout import buffer as tb
    res = []
    for mod in (jb, tb):
        buf = mod.RolloutBuffer(8, max_staleness=2, seed=0)
        for i, ep in enumerate([0, 0, 1, 3, 4]):
            assert buf.push(_sample(mod.RolloutSample, f"s{i}", ep))
        got = [buf.evict_stale(4), len(buf), buf.evicted, buf.ages(4),
               buf.staleness_p50(4)]
        dbuf = mod.RolloutBuffer(8, max_staleness=1,
                                 staleness_policy="downweight",
                                 downweight=0.5, seed=0)
        for i, ep in enumerate([0, 3]):
            dbuf.push(_sample(mod.RolloutSample, f"d{i}", ep))
        got.append(dbuf.evict_stale(3))
        got.append(dbuf.sample_batch(8, 8, current_epoch=3))
        res.append(got)
    (a, b) = res
    assert a[:6] == b[:6] and a[0] == 3 and a[3] == [1, 0]
    for x, y in zip(a[6], b[6]):
        np.testing.assert_array_equal(x, y)
    _, w, ages = b[6]
    for wi, ai in zip(w, ages):
        assert wi == pytest.approx(0.5 ** max(ai - 1, 0))
    with pytest.raises(ValueError, match="staleness_policy"):
        RolloutBuffer(4, staleness_policy="keep")
    with pytest.raises(ValueError, match="capacity"):
        RolloutBuffer(0)


def test_buffer_full_refuses_and_counts():
    buf = RolloutBuffer(2, seed=0)
    assert buf.push(_sample(RolloutSample, "a", 0))
    assert buf.push(_sample(RolloutSample, "b", 0))
    assert buf.free_slots == 0
    assert not buf.push(_sample(RolloutSample, "c", 0))
    assert buf.rejects == 1 and len(buf) == 2
    with pytest.raises(ValueError, match="empty"):
        RolloutBuffer(2).sample_batch(1, 4, current_epoch=0)


def test_buffer_seeded_replay_and_state_dicts_cross_packages():
    """The port's windows are the JAX buffer's (same seed, same pushes);
    a state dict of either package continues in the other with the
    windows the original would draw next."""
    from apex_tpu.rollout import buffer as jb

    def fill(buf, cls):
        for i in range(6):
            buf.push(_sample(cls, f"s{i}", i % 3, n=10 + i))
        return buf
    a = fill(RolloutBuffer(8, seed=7), RolloutSample)
    j = fill(jb.RolloutBuffer(8, seed=7), jb.RolloutSample)
    for _ in range(3):
        xa, wa, ga = a.sample_batch(4, 8, current_epoch=3)
        xj, wj, gj = j.sample_batch(4, 8, current_epoch=3)
        for x, y in ((xa, xj), (wa, wj), (ga, gj)):
            np.testing.assert_array_equal(x, y)
        assert xa.dtype == np.int32
    sd_a, sd_j = a.state_dict(), j.state_dict()
    cont = [a.sample_batch(4, 8, current_epoch=3)[0] for _ in range(3)]
    for src in (sd_a, sd_j):
        c = RolloutBuffer(8, seed=0).load_state_dict(src)
        for want in cont:
            np.testing.assert_array_equal(
                c.sample_batch(4, 8, current_epoch=3)[0], want)
        cj = jb.RolloutBuffer(8, seed=0).load_state_dict(src)
        for want in cont:
            np.testing.assert_array_equal(
                cj.sample_batch(4, 8, current_epoch=3)[0], want)
    assert c.pushed == 6 and c.draws == 6
    with pytest.raises(ValueError, match="capacity"):
        RolloutBuffer(4, seed=0).load_state_dict(sd_a)


# ---------------------------------------------------------------------------
# weight publish: one dispatch, in place, bit for bit, no recompile
# ---------------------------------------------------------------------------


def test_publish_bitwise_in_place_no_recompile_and_epoch_attribution():
    eng, step, rt = _loop()
    params = list(eng.model.parameters())
    reqs = [Request(rid=f"w{i}", prompt=[1 + i, 2, 3, 4],
                    max_new_tokens=4) for i in range(3)]
    eng.run(reqs)                      # warm the bucketed programs
    compiles0 = sc.kind_stats("decode_step")["compiles"]
    entries0 = ex.graph_stats(eng.programs()["decode_step"])["entries"]
    for k in range(3):                 # three publish epochs, each pinned
        step(torch.ones((2, 8), dtype=torch.long),
             torch.ones((2, 8), dtype=torch.long))
        d0 = sc.kind_stats("weight_publish")["dispatches"]
        stats = rt.publisher.publish(master_leaves(step))
        assert sc.kind_stats("weight_publish")["dispatches"] == d0 + 1
        assert stats["epoch"] == k + 1 and stats["cast_dispatch"]
        n = len(params)
        assert (stats["leaves"], stats["copied"], stats["zero_copy"]) == \
            (n, n, 0)
        assert stats["bytes_moved"] == sum(p.numel() * 4 for p in params)
        assert [p is q for p, q in zip(params,
                                       eng.model.parameters())] == [True] * n
        for p, mv in zip(eng.model.parameters(), master_leaves(step)):
            assert p.data_ptr() != mv.data_ptr()
            assert torch.equal(p, mv)
        # generation proceeds under the new weights without recompiling
        eng.run([Request(rid=f"w{k}b", prompt=[5, 6, 7], max_new_tokens=4)])
        assert eng.result_meta[f"w{k}b"]["weight_epoch"] == k + 1
    assert sc.kind_stats("decode_step")["compiles"] == compiles0
    assert ex.graph_stats(eng.programs()["decode_step"])["entries"] == \
        entries0
    ev = obs.events("rollout.weight_sync")
    assert len(ev) >= 3 and ev[-1]["zero_copy_frac"] == 0.0
    # the next train step moves the masters, never the served weights
    before = [p.detach().clone() for p in eng.model.parameters()]
    step(torch.ones((2, 8), dtype=torch.long),
         torch.ones((2, 8), dtype=torch.long))
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 eng.model.parameters()))
    assert not all(torch.equal(a, m) for a, m in zip(before,
                                                     master_leaves(step)))
    eng.close()


def test_publish_casts_once_through_executor():
    train_m = _gpt(6)
    serve_m = make_self_draft(train_m)
    for p in serve_m.parameters():
        p.data = p.data.to(torch.bfloat16)
    eng = ServeEngine(serve_m, num_blocks=16, block_size=8)
    step = _train_step(train_m)
    step(torch.ones((2, 8), dtype=torch.long),
         torch.ones((2, 8), dtype=torch.long))
    d0 = sc.kind_stats("weight_publish")["dispatches"]
    pub = WeightPublisher(eng, which="target")
    stats = pub.publish(master_leaves(step))
    assert stats["cast_dispatch"]
    assert sc.kind_stats("weight_publish")["dispatches"] == d0 + 1
    assert stats["bytes_moved"] == sum(p.numel() * 2
                                       for p in serve_m.parameters())
    for p, mv in zip(serve_m.parameters(), master_leaves(step)):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, mv.to(torch.bfloat16))
    # a dtype mismatch is rejected at the engine seam (the cast is the
    # publisher's job, once), as are other shapes at the publisher's
    with pytest.raises(ValueError, match="dtype"):
        eng.publish_weights(master_leaves(step))
    with pytest.raises(ValueError, match="master leaves"):
        pub.publish(master_leaves(step)[:-1])
    with pytest.raises(ValueError, match="draft"):
        WeightPublisher(eng, which="draft")
    eng.close()


# ---------------------------------------------------------------------------
# the loop: against the JAX loop, then determinism, staleness, backpressure
# ---------------------------------------------------------------------------


def test_two_rounds_match_the_jax_loop():
    ref = jax_loop_refs()
    eng, step, rt = _loop(seed=11)
    recs = rt.run(2)
    assert [s.rid for s in rt.buffer._samples] == \
        [rid for rid, _, _ in ref["samples"]]
    for s, (_, toks, epoch) in zip(rt.buffer._samples, ref["samples"]):
        np.testing.assert_array_equal(s.tokens, toks)
        assert s.weight_epoch == epoch
    keys = ("round", "submitted", "evicted", "weight_epoch", "buffer_fill",
            "staleness_p50", "accept_rate_window")
    assert [{k: r[k] for k in keys} for r in recs] == \
        [{k: r[k] for k in keys} for r in ref["recs"]]
    np.testing.assert_allclose(rt.losses, ref["losses"], rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(master_leaves(step), ref["masters"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert eng.weight_epochs == ref["epochs"]
    sd_t = rt.buffer.state_dict()
    assert sd_t["rng"] == ref["buffer"]["rng"]
    assert sd_t["counters"] == ref["buffer"]["counters"]
    eng.close()


def test_roundtrip_loss_trajectory_pinned():
    eng1, _, rt1 = _loop(seed=11)
    recs1 = rt1.run(4)
    eng1.close()
    eng2, _, rt2 = _loop(seed=11)
    rt2.run(4)
    eng2.close()
    assert rt1.losses == rt2.losses
    assert len(rt1.losses) == 8 and all(np.isfinite(rt1.losses))
    assert rt1.losses[-1] < rt1.losses[0]          # it actually learns
    assert [r["weight_epoch"] for r in recs1] == [1, 2, 3, 4]


def test_staleness_bound_evicts_in_loop():
    eng, _, rt = _loop(max_staleness=0, capacity=32)
    recs = rt.run(4)
    eng.close()
    assert sum(r["evicted"] for r in recs) > 0 and rt.buffer.evicted > 0
    ep = eng.weight_epochs["target"]
    rt.buffer.evict_stale(ep)
    assert all(a <= rt.buffer.max_staleness for a in rt.buffer.ages(ep))


def test_backpressure_throttles_generation_not_samples():
    eng, _, rt = _loop(capacity=6, publish_every=100)
    recs = rt.run(4)
    eng.close()
    assert rt.backpressure_rounds > 0
    assert any(r["submitted"] < rt.rollouts_per_round for r in recs)
    assert rt.buffer.rejects == 0      # reservation: never drop a rollout
    assert len(rt.buffer) <= rt.buffer.capacity
    assert any(e["event"] == "rollout.backpressure" for e in obs.events())


def test_zero_leaked_pool_blocks_and_metrics_cataloged():
    obs.get_registry().clear_events()
    eng, _, rt = _loop(distill=True)
    recs = rt.run(3)
    assert eng.block_pool.occupancy == 0
    eng.close()                         # asserts check_no_leaks
    assert all(r["distill_losses"] for r in recs)
    assert eng.weight_epochs == {"target": 3, "draft": 3}
    snap = obs.get_registry().snapshot()
    seen = set()
    for kind in ("counters", "gauges", "histograms"):
        seen |= {n for n in snap[kind] if n.startswith("rollout.")}
    seen |= {e["event"] for e in obs.events()
             if e["event"].startswith("rollout.")}
    assert {"rollout.round", "rollout.weight_sync",
            "rollout.distill_publish"} <= seen
    missing = {n for n in seen if n not in CATALOG}
    assert not missing, f"uncataloged rollout metrics: {missing}"


def test_accept_rate_strictly_improves_over_distill_publishes():
    train_m = _gpt(6)
    serve_m = make_self_draft(train_m)
    draft_master = _gpt(99)            # random-init draft: near-0 accept
    eng = ServeEngine(serve_m, num_blocks=64, block_size=8, max_batch=4,
                      prefill_chunk=4, draft=make_self_draft(draft_master),
                      spec_k=4, spec_policy="on")
    dist = OnlineDistiller(eng, draft_master, lr=1e-3)
    rng = np.random.default_rng(0)
    trace = [[int(t) for t in rng.integers(0, V, size=6)]
             for _ in range(6)]

    def accept_on_trace(tag):
        m0 = eng.metrics()["spec"]
        res = eng.run([Request(rid=f"{tag}.{i}", prompt=p,
                               max_new_tokens=10)
                       for i, p in enumerate(trace)])
        m1 = eng.metrics()["spec"]
        d_off = m1["offered"] - m0["offered"]
        assert d_off > 0
        rate = (m1["accepted"] - m0["accepted"]) / d_off
        seqs = [np.asarray(p + list(res[f"{tag}.{i}"]), np.int32)
                for i, p in enumerate(trace)]
        return rate, np.stack([np.resize(s, 16) for s in seqs])

    rate0, xs = accept_on_trace("base")
    rates = [rate0]
    for k in range(3):                 # >= 3 distillation publishes
        for _ in range(10):
            dist.train_on(xs)
        dist.publish(accept_rate=rates[-1])
        for p, m in zip(eng.draft.parameters(),
                        master_leaves(dist.dstep.step)):
            assert torch.equal(p, m)
        rate, xs = accept_on_trace(f"pub{k}")
        rates.append(rate)
    assert all(b > a for a, b in zip(rates, rates[1:])), rates
    assert [r["epoch"] for r in dist.publish_log] == [1, 2, 3]
    eng.close()
    with pytest.raises(ValueError, match="speculative"):
        OnlineDistiller(ServeEngine(_gpt(6), num_blocks=8, block_size=8),
                        _gpt(99))


# ---------------------------------------------------------------------------
# chaos resume == uninterrupted trajectory
# ---------------------------------------------------------------------------


def test_resume_equals_uninterrupted_under_train_kill(tmp_path):
    rounds = 6
    eng_u, step_u, rt_u = _loop(distill=True, seed=5)
    rt_u.run(rounds)
    eng_u.close()
    ref = rt_u.losses
    assert len(ref) == rounds * 2

    mgr = CheckpointManager(str(tmp_path / "ck"))
    eng_i, _, rt_i = _loop(distill=True, seed=5)
    with chaos.session(seed=0) as c:
        # train.step fires for target AND distill steps (3 a round):
        # index 9 is round 3's first target step, mid-round, after three
        # checkpointed round boundaries
        c.on("train.step", action="kill", at=(9,))
        with pytest.raises(chaos.ChaosKilled):
            rt_i.run(rounds, manager=mgr, save_every=1)
    eng_i.close()
    assert mgr.latest_step() == 3

    obs.get_registry().clear_events()
    eng_r, step_r, rt_r = _loop(distill=True, seed=5)
    assert rt_r.restore(mgr) == 3 and rt_r.round == 3
    assert rt_r.losses == ref[:6]      # the checkpointed prefix matches
    assert [e["round"] for e in obs.events("rollout.restore")] == [3]
    rt_r.run(rounds - rt_r.round)
    eng_r.close()
    # the FULL trajectory is the uninterrupted one bit for bit
    assert rt_r.losses == ref
    assert rt_r.distiller.losses == rt_u.distiller.losses
    assert rt_r.engine.weight_epochs == rt_u.engine.weight_epochs
    for a, b in zip(master_leaves(step_r), master_leaves(step_u)):
        assert torch.equal(a, b)
    for a, b in zip(eng_r.model.parameters(), eng_u.model.parameters()):
        assert torch.equal(a, b)
    assert RolloutRuntime(eng_r, step_r).restore(
        CheckpointManager(str(tmp_path / "empty"))) is None
