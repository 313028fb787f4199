"""The port's prefix cache (content-addressed KV block reuse) against the
JAX package's, on the CPU: chain keys equal to the JAX package's, the
pool's refcount / cached-tier / hash-index invariants, and warm-cache
continuations equal to the cold engine's and to the JAX engine's tokens
(fp32 and int8 pools, with and without speculative decoding, under
preemption, across a weight-epoch invalidation, through PagedSession and
the disaggregated engine), and a session migrated between engines through
the KV handoff, whose chain re-links into the survivor's index unless it
was built under another weight epoch."""
import numpy as np
import pytest
import torch

from apex_tpu.serve import pool as jax_pool

from apex_tpu_torch.inference import PagedSession, make_self_draft
from apex_tpu_torch.observe import registry as obs
from apex_tpu_torch.runtime import step_cache as sc
from apex_tpu_torch.serve import Request, ServeEngine
from apex_tpu_torch.serve.disagg import DisaggregatedEngine
from apex_tpu_torch.serve.pool import BlockPool, chain_key, chain_keys

import torch_serve_refs as refs
from torch_serve_refs import SHARED

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    """Empty the JAX step cache the JAX references filled (see
    test_torch_serve.py)."""
    from apex_tpu.runtime import step_cache
    yield
    step_cache.clear()


@pytest.fixture(scope="module")
def model():
    return refs.models()[1]


def _run(model, prefix_cache, **kw):
    eng = ServeEngine(model, prefix_cache=prefix_cache, **refs.GEOM, **kw)
    reqs, arrivals = refs.prefix_trace(Request)
    out = eng.run(reqs, arrivals=arrivals)
    m = eng.metrics()["prefix_cache"]
    eng.close()
    return out, m


# ---------------------------------------------------------------------------
# the rolling chain key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens,bs,tag", [
    ([1, 2, 3], 4, "t"), (list(range(1, 10)), 4, "t"),
    (SHARED + [20], 8, "float32:b8:wNone:e0"),
    (list(range(300, 340)), 16, "int8:b16:w8:e3"),
    ([0, 50256] * 24, 16, "bfloat16:b16:wNone:e0")])
def test_chain_keys_equal_the_jax_packages(tokens, bs, tag):
    assert chain_keys(tokens, bs, tag) == jax_pool.chain_keys(tokens, bs, tag)
    assert chain_key("ab", tokens[:bs], tag) == \
        jax_pool.chain_key("ab", tokens[:bs], tag)


def test_chain_keys_roll_over_full_blocks_only():
    assert chain_keys([1, 2, 3], 4, "t") == []
    k1 = chain_keys([1, 2, 3, 4], 4, "t")
    k2 = chain_keys([1, 2, 3, 4, 5, 6, 7, 8, 9], 4, "t")
    assert len(k1) == 1 and len(k2) == 2 and k2[0] == k1[0]
    assert chain_key("", [1, 2, 3, 4], "t") == k1[0]
    assert chain_key(k1[0], [5, 6, 7, 8], "t") == k2[1]
    assert chain_keys([1, 2, 3, 5], 4, "t") != k1
    assert chain_keys([1, 2, 3, 4], 4, "other") != k1


def test_engine_cache_tag_equals_the_jax_engines(model):
    from apex_tpu.serve import ServeEngine as JaxServeEngine
    jm = refs.models()[0]
    for kw in (dict(), dict(cache_dtype="int8"), dict(window=8)):
        assert ServeEngine(model, **refs.GEOM, **kw).scheduler.cache_tag \
            == JaxServeEngine(jm, **refs.GEOM, **kw).scheduler.cache_tag


# ---------------------------------------------------------------------------
# pool: refcounts, cached tier, LRU eviction, leak accounting
# ---------------------------------------------------------------------------


def test_pool_shared_refcounts_and_double_free_raises():
    pool = BlockPool(num_blocks=8, block_size=4)
    ids = pool.alloc(2)
    keys = chain_keys([1, 2, 3, 4, 5, 6, 7, 8], 4, "t")
    assert pool.commit(ids[0], keys[0]) and pool.commit(ids[1], keys[1])
    shared = pool.acquire_prefix(keys)
    assert shared == ids and pool.refcount(ids[0]) == 2
    assert pool.in_use == 2
    pool.free(shared)
    assert pool.refcount(ids[0]) == 1
    pool.free(ids)
    assert pool.in_use == 0 and pool.cached_count == 2
    with pytest.raises(ValueError):
        pool.free([ids[0]])
    pool.check_no_leaks()


def test_pool_partial_chain_walk_stops_at_first_miss():
    pool = BlockPool(num_blocks=8, block_size=4)
    ids = pool.alloc(2)
    keys = chain_keys(list(range(1, 13)), 4, "t")
    pool.commit(ids[0], keys[0])
    pool.commit(ids[1], keys[1])
    assert pool.acquire_prefix(keys) == ids
    pool.free(ids)
    other = chain_keys([1, 2, 3, 4, 9, 9, 9, 9], 4, "t")
    assert pool.acquire_prefix(other) == [ids[0]]
    pool.free([ids[0]])
    pool.free(ids)
    pool.check_no_leaks()


def test_pool_commit_first_writer_wins():
    pool = BlockPool(num_blocks=8, block_size=4)
    a, b = pool.alloc(2)
    assert pool.commit(a, "k")
    assert not pool.commit(b, "k")
    assert not pool.commit(a, "k2")
    assert not pool.commit(99, "k3")
    pool.free([a, b])
    assert pool.cached_count == 1
    pool.check_no_leaks()


def test_pool_lru_eviction_under_allocation_pressure():
    pool = BlockPool(num_blocks=6, block_size=4)
    ids = pool.alloc(5)
    for i, b in enumerate(ids):
        pool.commit(b, f"k{i}")
    pool.free(ids)
    assert pool.cached_count == 5 and pool.free_count == 5
    got = pool.alloc(2)
    assert pool.cache_evictions == 2
    assert pool.acquire_prefix(["k0"]) == []
    assert pool.acquire_prefix(["k2"]) == [ids[2]]
    pool.free([ids[2]])
    pool.free(got)
    pool.check_no_leaks()
    assert pool.alloc(6) is None


def test_pool_flush_cache_reclaims_and_invalidates():
    pool = BlockPool(num_blocks=6, block_size=4)
    ids = pool.alloc(2)
    pool.commit(ids[0], "k0")
    pool.free(ids)
    assert pool.cached_count == 1 and pool.flush_cache() == 1
    assert pool.cached_count == 0 and pool.free_exact == 5
    assert pool.acquire_prefix(["k0"]) == []
    pool.check_no_leaks()


# ---------------------------------------------------------------------------
# warm-cache continuations: equal to cold prefill and to the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp32", "int8", "speculative"])
def test_warm_cache_equals_cold_and_the_jax_engine(model, mode):
    kw = {"int8": dict(cache_dtype="int8"),
          "speculative": dict(draft=make_self_draft(model), spec_k=3)}.get(
              mode, {})
    warm, mw = _run(model, True, **kw)
    cold, mc = _run(model, False, **kw)
    assert warm == cold == refs.jax_refs(kw.get("cache_dtype"))["prefix"]
    assert mw["prefill_tokens_saved"] == 31      # 16 (partial) + 15 (full)
    assert mw["hit_rate"] > 0.5 and mw["cow_forks"] >= 1
    assert mc == {"hit_rate": 0.0, "prefill_tokens_saved": 0,
                  "cached_blocks": 0, "cow_forks": 0, "cache_evictions": 0}


def test_preemption_recompute_with_cache_equals_the_jax_engine(model):
    """A pool too small for the live set preempts; recompute re-admission
    walks the chain (often re-adopting its own retired blocks) and every
    continuation is the JAX engine's."""
    p0 = obs.counter("serve.preemptions").value
    small = ServeEngine(model, num_blocks=10, block_size=4, max_batch=4,
                        prefill_chunk=4)
    out = small.run(refs.dry_reqs(Request, 4))
    assert obs.counter("serve.preemptions").value > p0
    small.close()
    ref = refs.jax_dry_refs()
    assert out == {k: ref[k] for k in out}


def test_cache_eviction_pressure_no_leaks(model):
    eng = ServeEngine(model, num_blocks=12, block_size=4, max_batch=2,
                      prefill_chunk=8)
    out = eng.run([Request(f"e{i}", [10 + i, 20 + i, 30 + i, 40 + i, 5 + i],
                           4) for i in range(12)])
    assert len(out) == 12
    assert eng.metrics()["prefix_cache"]["cache_evictions"] > 0
    eng.close()


def test_epoch_invalidation_on_publish_weights(model):
    """publish_weights re-tags the chain keys and flushes the cached tier:
    a post-swap duplicate of a pre-swap prompt does not hit."""
    eng = ServeEngine(model, num_blocks=64, block_size=8, max_batch=2,
                      prefill_chunk=8)
    eng.run([Request("a", SHARED + [20], 4)])
    assert eng.block_pool.cached_count > 0
    saved0 = eng.metrics()["prefix_cache"]["prefill_tokens_saved"]
    tag0 = eng.scheduler.cache_tag
    # the same values: the parameters stay the model's
    eng.publish_weights([p.detach().clone() for p in model.parameters()])
    assert eng.scheduler.cache_tag != tag0
    assert eng.block_pool.cached_count == 0
    eng.run([Request("b", SHARED + [20], 4)])
    m = eng.metrics()["prefix_cache"]
    assert m["prefill_tokens_saved"] == saved0
    assert eng.block_pool.cached_count > 0
    eng.close()


def test_decode_stays_recompile_free_with_cache(model):
    sc.reset_stats()
    sc.clear()
    eng = ServeEngine(model, **refs.GEOM)
    reqs, arrivals = refs.prefix_trace(Request)
    eng.run(reqs, arrivals=arrivals)
    eng.run([Request(f"y{i}", SHARED + [40 + i], 5) for i in range(4)])
    assert sc.kind_stats("decode_step")["compiles"] <= 6
    eng.close()


# ---------------------------------------------------------------------------
# PagedSession and the disaggregated engine
# ---------------------------------------------------------------------------


def test_paged_session_replay_and_extension_hit(model):
    """A conversation replay is a full prefix hit (one re-ingested token,
    a fork), an extension a partial one; both continue with the JAX
    PagedSession's tokens, and their logits are within 1e-5 of its."""
    ref = refs.jax_refs()
    eng = ServeEngine(model, **refs.GEOM)
    with PagedSession(eng) as s1:
        s1.append(SHARED)
        assert s1.generate(6)[0].tolist() == ref["shared"][0][1]
    assert eng.block_pool.cached_count >= 2
    with PagedSession(eng) as s2:
        lg = s2.append(SHARED)
        assert s2.position == len(SHARED)
        np.testing.assert_allclose(np.asarray(lg), ref["shared"][0][0],
                                   rtol=0, atol=1e-5)
        assert s2.generate(6)[0].tolist() == ref["shared"][0][1]
    assert eng._cow_forks >= 1
    with PagedSession(eng) as s3:
        lg = s3.append(SHARED + [20, 21])
        np.testing.assert_allclose(np.asarray(lg), ref["extended"][0][0],
                                   rtol=0, atol=1e-5)
        assert s3.generate(4)[0].tolist() == ref["extended"][0][1]
    eng.block_pool.check_no_leaks()


def test_disagg_shared_prefix_equals_the_jax_engine(model, tmp_path):
    reqs, arrivals = refs.prefix_trace(Request)
    dis = DisaggregatedEngine(model, handoff_dir=str(tmp_path), **refs.GEOM)
    assert dis.run(reqs, arrivals=arrivals) == refs.jax_refs()["prefix"]
    assert dis.prefill.metrics()["prefix_cache"]["prefill_tokens_saved"] \
        == 31
    # handed-off chains re-link into the decode engine's index
    assert dis.decode.block_pool.cached_count > 0
    dis.prefill.close()
    dis.decode.close()


# ---------------------------------------------------------------------------
# migration: the chain re-links into the survivor's index
# ---------------------------------------------------------------------------


def _mid_decode(model, tmp_path, name):
    """A session of SHARED + [20], 8 new tokens, streamed off engine A
    mid-decode: its handoff directory and host state."""
    from apex_tpu_torch.runtime.resilience import stream_kv_handoff
    a = ServeEngine(model, num_blocks=64, block_size=8, prefill_chunk=8)
    a.submit(Request("m", SHARED + [20], 8))
    for _ in range(6):
        a.step()
    (s,) = a.scheduler.sessions
    assert s.committed_blocks >= 2 and 0 < len(s.out) < 8
    d = str(tmp_path / name)
    stream_kv_handoff(d, a.pool, s.table, source=f"test:{name}")
    state = dict(chain=list(s.hash_chain), epoch=s.weight_epoch,
                 out=list(s.out), pend=s.pending_tok, pos=s.position,
                 nb=len(s.table))
    a.close()
    return d, state


def test_migration_relinks_chain_into_survivor(model, tmp_path):
    """A mid-decode session streamed off engine A (its hash chain and
    weight epoch beside it) and adopted on engine B: the chain re-links
    into B's index, so B's next same-prefix admission hits, and the
    continuation is the uninterrupted engine's bit for bit, whose first
    tokens are the JAX engine's."""
    ref = ServeEngine(model, num_blocks=64, block_size=8,
                      prefix_cache=False)
    full = ref.run([Request("m", SHARED + [20], 8)])["m"]
    ref.close()
    assert full[:6] == refs.jax_refs()["prefix"]["x0"]
    d, st = _mid_decode(model, tmp_path, "mig")
    b = ServeEngine(model, num_blocks=64, block_size=8, prefill_chunk=8)
    sess = b.ingest_handoff(Request("m", SHARED + [20], 8), out=st["out"],
                            pending_tok=st["pend"], position=st["pos"],
                            handoff_dir=d, n_blocks=st["nb"],
                            hash_chain=st["chain"],
                            weight_epoch=st["epoch"])
    assert sess is not None and sess.cacheable
    assert sess.committed_blocks == len(st["chain"])
    while b.scheduler.has_work():
        b.step()
    assert b.results["m"] == full
    b.run([Request("m2", SHARED + [20], 4)])
    assert b.metrics()["prefix_cache"]["prefill_tokens_saved"] > 0
    b.close()


def test_migration_epoch_mismatch_never_cached(model, tmp_path):
    """An adopted session whose chain was built under ANOTHER target
    epoch keeps serving (mixed-weight semantics) but its blocks never
    enter the survivor's hash index."""
    d, st = _mid_decode(model, tmp_path, "mig2")
    b = ServeEngine(model, num_blocks=64, block_size=8, prefill_chunk=8)
    sess = b.ingest_handoff(Request("m", SHARED + [20], 8), out=st["out"],
                            pending_tok=st["pend"], position=st["pos"],
                            handoff_dir=d, n_blocks=st["nb"],
                            hash_chain=st["chain"], weight_epoch=7)
    assert sess is not None and not sess.cacheable
    while b.scheduler.has_work():
        b.step()
    assert b.block_pool.cached_count == 0     # nothing was published
    b.block_pool.check_no_leaks()
    b.close()
