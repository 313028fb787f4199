"""The port's serve engine (``apex_tpu_torch.serve``) against the JAX
package's, on the CPU: the paged pool's alloc/free/leak invariants, the
scheduler's decisions on a seeded Poisson trace equal to the JAX
scheduler's, the engine's greedy tokens (fp32 and int8 pools, a dry pool
that preempts, a sliding window, ``spec_policy="auto"``) and
PagedSession's logits against the JAX engine on the same weights, the
lifecycle events and the registry's schema, recompile-free decode through
the step cache, ``publish_weights`` in place, and the null block that
stays zero.  The JAX references run once a process (torch_serve_refs)."""
import numpy as np
import pytest
import torch

from apex_tpu.observe import registry as jax_obs
from apex_tpu.serve import Scheduler as JaxScheduler
from apex_tpu.serve import BlockPool as JaxBlockPool
from apex_tpu.serve import Request as JaxRequest

from apex_tpu_torch.inference import DecodeSession, PagedSession
from apex_tpu_torch.inference.rolling import window_retired_blocks
from apex_tpu_torch.observe import registry as obs
from apex_tpu_torch.runtime import step_cache as sc
from apex_tpu_torch.serve import (BlockPool, NULL_BLOCK, Request, Scheduler,
                                  ServeEngine, blocks_for, bucket)
from apex_tpu_torch.serve.scheduler import DECODE

import torch_serve_refs as refs

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    """The JAX engines leave their programs in the JAX package's step cache
    (an LRU of 128): empty it after the module, so the files run after this
    one in the process find it as the module found it."""
    from apex_tpu.runtime import step_cache
    yield
    step_cache.clear()


@pytest.fixture(scope="module")
def model():
    return refs.models()[1]


def _session_tokens(model, prompt, n, cache_dtype=None):
    s = DecodeSession(model, batch=1, cache_dtype=cache_dtype)
    s.append(torch.tensor([prompt]))
    return s.generate(n)[0].tolist()


# ---------------------------------------------------------------------------
# host-side units: buckets, pool accounting
# ---------------------------------------------------------------------------


def test_bucket_and_blocks_for():
    from apex_tpu import serve as jax_serve
    assert [bucket(n) for n in (1, 2, 3, 4, 5, 9)] == [1, 2, 4, 4, 8, 16]
    assert bucket(9, cap=8) == 8
    assert [blocks_for(n, 4) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]
    for n in range(40):
        assert bucket(n, 16) == jax_serve.bucket(n, 16)
        assert blocks_for(n, 8) == jax_serve.blocks_for(n, 8)


def test_pool_alloc_is_all_or_nothing():
    pool = BlockPool(num_blocks=8, block_size=4)
    ids = pool.alloc(7)
    assert ids is not None and len(ids) == 7
    assert NULL_BLOCK not in ids          # block 0 is never handed out
    assert pool.alloc(1) is None
    assert pool.in_use == 7 and pool.free_count == 0
    pool.free(ids[:3])
    assert pool.alloc(4) is None          # a shortfall takes nothing
    assert pool.free_count == 3
    got = pool.alloc(3)
    assert sorted(got) == sorted(ids[:3])
    pool.free(got)
    pool.free(ids[3:])
    pool.check_no_leaks()


def test_pool_double_free_and_foreign_free_raise():
    pool = BlockPool(num_blocks=8, block_size=4)
    ids = pool.alloc(2)
    pool.free(ids)
    with pytest.raises(ValueError):
        pool.free(ids)
    with pytest.raises(ValueError):
        pool.free([NULL_BLOCK])


# ---------------------------------------------------------------------------
# the scheduler: churn without leaks, decisions equal to the JAX package's
# ---------------------------------------------------------------------------


def _sim_tok(position):
    return (position * 7 + 3) % 70 + 1


def _sim_prefill_tick(sched):
    s = sched.next_prefill()
    if s is None:
        return
    s.position += min(sched.prefill_chunk, s.prefill_remaining)
    sched.note_commit(s)
    if s.prefill_remaining > 0:
        return
    s.state = DECODE
    if s.emit_on_prefill:
        tok = _sim_tok(s.position)
        s.out.append(tok)
        s.pending_tok = tok
        if s.finished():
            sched.finish(s)


def _sim_decode_tick(sched):
    preempted = []
    for s in list(sched.decode_sessions()):
        if s.state != DECODE:
            continue
        while not sched.grow(s, s.position + 1):
            victim = sched.preempt_for(s)
            preempted.append(victim.rid)
            if victim is s:
                break
    live = sched.decode_sessions()
    packed = sched.pack_decode(live) if live else None
    for s in list(live):
        s.position += 1
        tok = _sim_tok(s.position)
        s.out.append(tok)
        s.pending_tok = tok
        sched.note_commit(s)
        if s.finished():
            sched.finish(s)
    return preempted, packed


def _drive_trace(pool_cls, sched_cls, request_cls, seed, n=60, shared=False):
    """A host-only serve loop over a seeded Poisson arrival trace (half the
    prompts over shared templates when ``shared``), recording every
    scheduling decision: admissions with their prefix hits, forks and
    tables, preemptions, and the packed decode operands."""
    rng = np.random.default_rng(seed)
    pool = pool_cls(num_blocks=32, block_size=4)
    sched = sched_cls(pool, max_batch=4, prefill_chunk=8,
                      max_prefill_backlog=32, max_positions=96)
    templates = [[int(t) for t in rng.integers(1, 70, ln)]
                 for ln in (4, 8, 11)]
    prompts = []
    for _ in range(n):
        if shared and rng.random() < 0.5:
            prompts.append(templates[int(rng.integers(3))]
                           + [int(t) for t in rng.integers(1, 70, 2)])
        else:
            prompts.append([int(t) for t in
                            rng.integers(1, 70, int(rng.integers(1, 10)))])
    news = rng.integers(1, 6, n)
    arrive = np.cumsum(rng.poisson(1.0, n))
    decisions = []
    i = tick = 0
    while i < n or sched.has_work():
        assert tick < 50_000
        while i < n and arrive[i] <= tick:
            sched.submit(request_cls(f"r{i}", prompts[i], int(news[i])))
            i += 1
        admitted = sched.admit()
        for s in admitted:
            decisions.append(("admit", tick, s.rid, tuple(s.table),
                              s.position, tuple(s.cow_pending)))
            sched.complete_cow(s)
        _sim_prefill_tick(sched)
        preempted, packed = _sim_decode_tick(sched)
        if preempted:
            decisions.append(("preempt", tick, tuple(preempted)))
        if packed is not None:
            b, nb, toks, poss, tables = packed
            decisions.append(("pack", tick, b, nb, tuple(toks),
                              tuple(poss), tuple(map(tuple, tables))))
        tick += 1
    pool.check_no_leaks()
    return decisions, pool.cache_evictions


@pytest.mark.parametrize("shared", [False, True])
def test_scheduler_decisions_equal_the_jax_schedulers(shared):
    """The same seeded trace through both packages' pool and scheduler:
    every admission (table, start position, forks), preemption and packed
    decode operand equal, the replay deterministic, and the trace not
    degenerate."""
    ours, ev = _drive_trace(BlockPool, Scheduler, Request, 7, shared=shared)
    theirs, jev = _drive_trace(JaxBlockPool, JaxScheduler, JaxRequest, 7,
                               shared=shared)
    assert ours == theirs and ev == jev
    assert ours == _drive_trace(BlockPool, Scheduler, Request, 7,
                                shared=shared)[0]
    packs = [d for d in ours if d[0] == "pack"]
    assert packs and {d[2] for d in packs} >= {1, 2}
    if shared:
        assert any(d[0] == "admit" and d[4] > 0 for d in ours)


def test_scheduler_churn_500_requests_zero_leaks():
    """500 requests of random admit/finish/preempt churn with the prefix
    cache live: blocks shared, forked and evicted, and the books balance to
    zero leaks."""
    from collections import Counter
    rng = np.random.default_rng(0)
    pool = BlockPool(num_blocks=48, block_size=4)
    sched = Scheduler(pool, max_batch=8, prefill_chunk=8,
                      max_prefill_backlog=64, max_positions=96)
    n = 500
    templates = [[int(t) for t in rng.integers(1, 70, ln)]
                 for ln in (4, 8, 8, 11)]
    reqs = []
    for i in range(n):
        if rng.random() < 0.5:
            base = templates[int(rng.integers(len(templates)))]
            ext = [] if rng.random() < 0.3 else \
                [int(t) for t in rng.integers(1, 70, int(rng.integers(1, 4)))]
            prompt = base + ext
        else:
            prompt = [int(t) for t in
                      rng.integers(1, 70, int(rng.integers(1, 12)))]
        reqs.append(Request(f"r{i}", prompt, int(rng.integers(1, 9))))
    shared = cow = 0
    i = tick = 0
    while i < n or sched.has_work():
        tick += 1
        assert tick < 100_000
        for _ in range(int(rng.integers(0, 3))):
            if i < n:
                sched.submit(reqs[i])
                i += 1
        for s in sched.admit():
            shared += s.committed_blocks
            cow += sched.complete_cow(s)
        _sim_prefill_tick(sched)
        _sim_decode_tick(sched)
        if sched.sessions and rng.random() < 0.05:
            sched.preempt_for(sched.sessions[0])
        if tick % 50 == 0:
            occ = Counter(b for s in sched.sessions
                          for b in s.table + s.draft_table
                          if b != NULL_BLOCK)
            assert all(pool.refcount(b) == k for b, k in occ.items())
            assert len(occ) == pool.in_use
    assert shared > 50 and cow > 0 and pool.cache_evictions > 0
    pool.check_no_leaks()
    assert pool.free_exact + pool.cached_count == pool.capacity


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_engine_tokens_equal_the_jax_engines(model, cache_dtype):
    ref = refs.jax_refs(cache_dtype)["prompts"]
    eng = ServeEngine(model, cache_dtype=cache_dtype, **refs.GEOM)
    assert eng.run(refs.prompt_reqs(Request)) == ref
    # the contiguous-cache session gives the same greedy tokens
    for i, p in enumerate(refs.PROMPTS):
        assert ref[f"r{i}"] == _session_tokens(model, p, refs.MAX_NEW,
                                                cache_dtype)
    # the null block is still all zeros: dead rows wrote zeros there
    for part in (eng.pool if cache_dtype else (eng.pool,)):
        assert not part[:, :, NULL_BLOCK].any()
    eng.close()


@pytest.mark.parametrize("cache_dtype,tol", [(None, 1e-5), ("int8", 1e-4)])
def test_paged_session_turns_equal_the_jax_sessions(model, cache_dtype, tol):
    """A PagedSession's multi-turn chat: each append's last logits within
    ``tol`` of the JAX PagedSession's, the generated tokens equal, and both
    equal to the contiguous-cache DecodeSession's."""
    ref = refs.jax_refs(cache_dtype)["turns"]
    eng = ServeEngine(model, cache_dtype=cache_dtype, **refs.GEOM)
    got = refs._paged(PagedSession, eng, refs.TURNS)
    ds = DecodeSession(model, batch=1, cache_dtype=cache_dtype)
    for (lg, toks), (jlg, jtoks), (prompt, n) in zip(got, ref, refs.TURNS):
        np.testing.assert_allclose(lg, jlg, rtol=0, atol=tol)
        assert toks == jtoks
        ds.append(torch.tensor([prompt]))
        assert toks == ds.generate(n)[0].tolist()
    eng.block_pool.check_no_leaks()


def test_preemption_recompute_equals_the_jax_engine(model):
    """A pool too small for the live set preempts; every request finishes
    with the JAX engine's tokens, and the drained pool holds nothing."""
    ref = refs.jax_dry_refs()
    assert ref["preempted"]
    p0 = obs.counter("serve.preemptions").value
    eng = ServeEngine(model, **refs.DRY)
    out = eng.run(refs.dry_reqs(Request, 3))
    assert obs.counter("serve.preemptions").value > p0
    assert out == {k: ref[k] for k in out}
    eng.block_pool.check_no_leaks()


def test_windowed_engine_equals_the_jax_engine(model):
    eng = ServeEngine(model, num_blocks=32, block_size=4, max_batch=2,
                      prefill_chunk=4, window=8)
    assert eng.run([Request("w", list(range(1, 20)), 10)]) == \
        refs.jax_window_refs()
    eng.block_pool.check_no_leaks()


def test_spec_policy_auto_gives_the_jax_tokens_by_plain_ticks(model):
    """``spec_policy="auto"`` on the CPU decides "xla" (the device's rule,
    as the JAX package decides with no Pallas backend): plain decode ticks
    (the draft catching up in the prefill slot), the JAX package's
    tokens."""
    from apex_tpu_torch.inference import make_self_draft
    eng = ServeEngine(model, num_blocks=128, block_size=8, max_batch=4,
                      prefill_chunk=4, draft=make_self_draft(model),
                      spec_k=3, spec_policy="auto")
    assert eng.run(refs.prompt_reqs(Request)) == \
        refs.jax_refs()["prompts"]
    assert eng.metrics()["spec"]["ticks"] == 0
    eng.block_pool.check_no_leaks()


def test_lifecycle_events_and_metrics_keys_equal_the_jax_engines(model):
    ref = refs.jax_refs()
    obs.get_registry().clear_events()
    eng = ServeEngine(model, **refs.GEOM)
    eng.run(refs.prompt_reqs(Request))
    assert refs._events(obs) == ref["events"]
    m = eng.metrics()
    assert {k: sorted(v) if isinstance(v, dict) else None
            for k, v in m.items()} == ref["metrics_keys"]
    assert m["pool_occupancy"] == 0.0 and m["queue_depth"] == 0
    for kind in ("decode", "prefill"):
        assert m[kind]["dispatches"] >= 1


def test_registry_snapshot_and_event_schema_equal_the_jax_registrys():
    def drive(mod):
        reg = mod.MetricsRegistry()
        reg.counter("c").inc(3)
        reg.gauge("g").set(2)
        for v in (1.0, 4.0):
            reg.histogram("h").observe(v)
        ev = reg.event("e", rid="x", tick=1)
        return reg.snapshot(), {k: v for k, v in ev.items()
                                if k != "ts_ms"}, sorted(ev)
    assert drive(obs) == drive(jax_obs)
    assert obs.SCHEMA_VERSION == jax_obs.SCHEMA_VERSION


# ---------------------------------------------------------------------------
# the engine alone: graphs per bucket, interleave, validation, teardown
# ---------------------------------------------------------------------------


def test_decode_recompile_free_after_warmup(model):
    sc.reset_stats()
    sc.clear()
    eng = ServeEngine(model, num_blocks=64, block_size=8, max_batch=4,
                      prefill_chunk=4)
    eng.run([Request(f"a{i}", [2 + i, 5, 7, 11], 6) for i in range(8)])
    warm = sc.kind_stats("decode_step")
    assert 1 <= warm["compiles"] <= 6
    eng.run([Request(f"b{i}", [3 + i, 9, 4, 2], 6) for i in range(8)])
    again = sc.kind_stats("decode_step")
    assert again["compiles"] == warm["compiles"]
    assert again["cache_hits"] > warm["cache_hits"]
    eng.block_pool.check_no_leaks()


def test_prefill_chunking_interleaves_decode(model):
    """A 32-token prompt prefilling 2 tokens a tick does not stall a short
    request's decode: one token a tick, done before the long prompt's
    first token."""
    obs.get_registry().clear_events()
    eng = ServeEngine(model, num_blocks=64, block_size=8, max_batch=4,
                      prefill_chunk=2, max_prefill_backlog=64)
    out = eng.run([Request("short", [5, 9], 6),
                   Request("long", list(range(1, 33)), 4)], arrivals=[0, 1])
    assert len(out["short"]) == 6 and len(out["long"]) == 4
    ticks = {(e["rid"], e["phase"]): e["tick"]
             for e in obs.events("serve.request")}
    assert ticks[("short", "done")] - ticks[("short", "first_token")] == 4
    assert ticks[("short", "done")] < ticks[("long", "first_token")]
    eng.block_pool.check_no_leaks()


def test_window_retired_blocks_and_retirement(model):
    assert [window_retired_blocks(t, 8, 4) for t in (0, 8, 12, 20)] == \
        [0, 0, 1, 3]
    assert window_retired_blocks(20, None, 4) == 0
    eng = ServeEngine(model, num_blocks=32, block_size=4, max_batch=2,
                      prefill_chunk=4, window=8)
    eng.submit(Request("w", list(range(1, 20)), 10))
    while eng.step():
        for s in eng.scheduler.sessions:
            n = window_retired_blocks(s.position, 8, 4)
            assert s.table[:n] == [NULL_BLOCK] * n
    eng.block_pool.check_no_leaks()


def test_submit_rejects_never_fit_requests(model):
    eng = ServeEngine(model, num_blocks=4, block_size=4, max_batch=2,
                      prefill_chunk=4)
    with pytest.raises(ValueError):
        eng.submit(Request("big", list(range(1, 30)), 8))
    with pytest.raises(ValueError):
        eng.submit(Request("long", [1] * 90, 20))
    assert not eng.scheduler.has_work()


def test_close_returns_all_live_blocks(model):
    from apex_tpu_torch.inference import make_self_draft
    eng = ServeEngine(model, num_blocks=48, block_size=8, max_batch=4,
                      prefill_chunk=4, draft=make_self_draft(model))
    for i, p in enumerate(refs.PROMPTS[:3]):
        eng.submit(Request(f"c{i}", p, 12))
    for _ in range(4):
        eng.step()
    assert eng.scheduler.sessions and eng.block_pool.in_use > 0
    eng.close()
    assert eng.block_pool.in_use == 0 and not eng.scheduler.has_work()
    with ServeEngine(model, num_blocks=32, block_size=8, max_batch=2,
                     prefill_chunk=4) as eng2:
        eng2.submit(Request("cm", [3, 4, 5], 8))
        eng2.step()
        eng2.step()
        assert eng2.block_pool.in_use > 0
    assert eng2.block_pool.in_use == 0


def test_publish_weights_copies_into_the_parameters():
    """publish_weights copies the new values into the parameter tensors
    the programs read (their addresses unchanged), so the next dispatch
    computes with them: the same tokens as an engine built on the new
    weights; a leaf of another shape or dtype is refused."""
    _, target = refs.gpt_tiny()
    _, other = refs.gpt_tiny(seed=9)
    eng = ServeEngine(target, **refs.GEOM)
    eng.run(refs.prompt_reqs(Request, "a"))
    ptrs = [p.data_ptr() for p in target.parameters()]
    assert eng.publish_weights([p.detach() for p in other.parameters()]) == 1
    assert [p.data_ptr() for p in target.parameters()] == ptrs
    got = {k: v for k, v in eng.run(refs.prompt_reqs(Request, "b")).items()
           if k[0] == "b"}
    fresh = ServeEngine(other, **refs.GEOM).run(refs.prompt_reqs(Request,
                                                                 "b"))
    assert got == fresh
    assert eng.result_meta["b0"]["weight_epoch"] == 1
    leaves = [p.detach() for p in other.parameters()]
    with pytest.raises(ValueError, match="shape"):
        eng.publish_weights(leaves[:-1] + [leaves[-1][:1]])
    with pytest.raises(ValueError, match="dtype"):
        eng.publish_weights(leaves[:-1] + [leaves[-1].double()])
    with pytest.raises(RuntimeError, match="draft"):
        eng.publish_weights(leaves, which="draft")


def test_rotary_models_are_refused():
    """A Llama lacks the GPT protocol's position table and is refused in
    both packages; a GPT-protocol model whose projection takes positions
    (rotary embeddings inside ``_chunk_qkv``) is refused as not ported,
    as the JAX engine refuses it."""
    import apex_tpu.models.llama as jax_llama
    from apex_tpu.serve import ServeEngine as JaxServeEngine
    from apex_tpu_torch.models import LlamaModel
    cfg = dict(vocab_size=32, hidden=16, layers=1, heads=2, kv_heads=1,
               intermediate=32, max_positions=16)
    with pytest.raises(ValueError, match="pos_emb"):
        ServeEngine(LlamaModel(**cfg, device="cpu"), num_blocks=8,
                    block_size=4)
    with pytest.raises(ValueError, match="pos_emb"):
        JaxServeEngine(jax_llama.LlamaModel(**cfg), num_blocks=8,
                       block_size=4)
    _, m = refs.gpt_tiny()
    blk = m.blocks[0]
    blk._chunk_qkv = lambda x, pos: type(blk)._chunk_qkv(blk, x)
    with pytest.raises(NotImplementedError, match="rotary"):
        ServeEngine(m, num_blocks=8, block_size=4)
