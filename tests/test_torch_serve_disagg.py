"""The port's disaggregated prefill/decode and batched speculative decoding
against the JAX package's, on the CPU: the streamed KV handoff's
continuation equal to the JAX engine's tokens (fp32 and int8 pools, open
loop, forced preemption on the decode engine), the self-draft speculative
arm exact and committing >= 2 tokens a sequence a tick inside the bucket
grid, chaos mid-handoff (a retried failure, a kill's rejectable debris),
the handoff's error taxonomy, and handoffs that cross between the packages
bit for bit both ways (fp32 and int8).  The JAX package's phase-split
planner is ROADMAP A9 and stays out."""
import os

import numpy as np
import pytest
import torch

import apex_tpu.runtime.resilience as jax_res
from apex_tpu.serve import init_pool_buffer as jax_init_pool

from apex_tpu_torch.inference import make_self_draft
from apex_tpu_torch.inference.quant import QuantKV
from apex_tpu_torch.models import GptModel
from apex_tpu_torch.observe import registry as obs
from apex_tpu_torch.runtime import chaos
from apex_tpu_torch.runtime import step_cache as sc
from apex_tpu_torch.runtime.resilience import (CheckpointCorruptError,
                                               CheckpointReshardError,
                                               discard_kv_handoff,
                                               load_kv_handoff,
                                               read_kv_handoff_meta,
                                               stream_kv_handoff)
from apex_tpu_torch.serve import (DisaggregatedEngine, Request, ServeEngine,
                                  bucket, init_pool_buffer)

import torch_serve_refs as refs

torch.set_num_threads(2)

#: the handoff tests' pool geometry: 2 layers, 4 heads, D 8, 8 blocks of 8
GEOM = (2, 4, 8, 8, 8)
BLOCK_BYTES = 2 * 2 * 4 * 8 * 8 * 4           # one fp32 block


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    """Empty the JAX step cache the JAX references filled (see
    test_torch_serve.py)."""
    from apex_tpu.runtime import step_cache
    yield
    step_cache.clear()


@pytest.fixture(autouse=True)
def _no_leftover_controller():
    yield
    chaos.uninstall()


@pytest.fixture(scope="module")
def model():
    return refs.models()[1]


def _disagg(model, tmp_path, **kw):
    return DisaggregatedEngine(model, handoff_dir=str(tmp_path),
                               **{**refs.GEOM, **kw})


def _check_disagg(eng):
    eng.prefill.block_pool.check_no_leaks()
    eng.decode.block_pool.check_no_leaks()
    assert not eng.pending


# ---------------------------------------------------------------------------
# handoff parity: prefill on A -> streamed KV -> decode on B
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_dtype,peak", [(None, BLOCK_BYTES),
                                              ("int8", BLOCK_BYTES // 4)])
def test_disagg_equals_the_jax_engine(model, tmp_path, cache_dtype, peak):
    eng = _disagg(model, tmp_path, cache_dtype=cache_dtype)
    assert eng.run(refs.prompt_reqs(Request)) == \
        refs.jax_refs(cache_dtype)["prompts"]
    m = eng.metrics()["handoff"]
    assert m["count"] == len(refs.PROMPTS) and m["retries"] == 0
    # one block part's bytes: the host never holds a gathered pool
    assert m["bytes_peak_host"] == peak
    _check_disagg(eng)


def test_disagg_open_loop_arrivals_equal_the_jax_engine(model, tmp_path):
    eng = _disagg(model, tmp_path)
    assert eng.run(refs.prompt_reqs(Request), arrivals=[0, 2, 3, 7]) == \
        refs.jax_refs()["prompts"]
    _check_disagg(eng)


# ---------------------------------------------------------------------------
# speculative decoding: exact, recompile-free, >= 2 tokens a tick
# ---------------------------------------------------------------------------


def test_unified_spec_equals_the_jax_engine_and_recompile_free(model):
    sc.reset_stats()
    sc.clear()
    eng = ServeEngine(model, num_blocks=128, block_size=8, max_batch=4,
                      prefill_chunk=4, draft=make_self_draft(model),
                      spec_k=3, spec_policy="on")
    assert eng.run(refs.prompt_reqs(Request)) == refs.jax_refs()["prompts"]
    eng.block_pool.check_no_leaks()
    spec = eng.metrics()["spec"]
    assert spec["ticks"] > 0 and spec["accept_rate"] >= 0.5
    assert spec["committed_tokens"] / (spec["offered"] / 3) >= 2.0
    stats = sc.kind_stats("spec_verify_step")
    bound = (len({bucket(b, 4) for b in range(1, 5)})
             * len({bucket(t) for t in range(1, 5)}) ** 2)
    assert 1 <= stats["compiles"] <= bound
    assert stats["dispatches"] >= stats["compiles"]


def test_disagg_spec_int8_draft_equals_the_jax_engine(model, tmp_path):
    eng = _disagg(model, tmp_path, draft=make_self_draft(model), spec_k=3,
                  decode_blocks=128, draft_cache_dtype="int8")
    assert eng.run(refs.prompt_reqs(Request)) == refs.jax_refs()["prompts"]
    assert eng.decode.metrics()["spec"]["accept_rate"] >= 0.5
    assert eng.decode.dpool.q.dtype == torch.int8
    _check_disagg(eng)


def test_spec_telemetry_names(model):
    reg = obs.get_registry()
    hist0 = reg.histogram("serve.spec.accepted_tokens").count
    eng = ServeEngine(model, num_blocks=128, block_size=8, max_batch=4,
                      prefill_chunk=4, draft=make_self_draft(model),
                      spec_k=2, spec_policy="on")
    eng.run(refs.prompt_reqs(Request))
    assert reg.histogram("serve.spec.accepted_tokens").count > hist0
    rate = reg.gauge("serve.spec.accept_rate").value
    assert rate is not None and 0.0 <= rate <= 1.0
    eng.block_pool.check_no_leaks()


def test_divergent_draft_still_exact(model):
    """A draft that disagrees with the target can only slow decoding, never
    change the tokens."""
    torch.manual_seed(7)
    draft = GptModel(vocab_size=73, hidden=16, layers=1, heads=2,
                     max_positions=96, dropout=0.0, attn_dropout=0.0,
                     device="cpu").eval()
    eng = ServeEngine(model, num_blocks=128, block_size=8, max_batch=4,
                      prefill_chunk=4, draft=draft, spec_k=2,
                      spec_policy="on")
    assert eng.run(refs.prompt_reqs(Request)) == refs.jax_refs()["prompts"]
    assert eng.metrics()["spec"]["accept_rate"] < 1.0
    eng.block_pool.check_no_leaks()


# ---------------------------------------------------------------------------
# chaos mid-handoff, forced preemption
# ---------------------------------------------------------------------------


def test_chaos_mid_handoff_retries_then_parity(model, tmp_path):
    r0 = obs.counter("serve.handoff.retries").value
    with chaos.session(seed=0) as c:
        c.on("serve.kv_handoff", action="fail", at=1)
        eng = _disagg(model, tmp_path)
        out = eng.run(refs.prompt_reqs(Request))
        assert [p for p, _, _ in c.log] == ["serve.kv_handoff"]
    assert out == refs.jax_refs()["prompts"]
    assert obs.counter("serve.handoff.retries").value == r0 + 1
    assert eng.metrics()["handoff"]["retries"] == 1
    _check_disagg(eng)


def _filled_pool(dtype=None, seed=0):
    """A CPU pool at GEOM with blocks 1..3 random (fp32, or int8 payload
    and positive scales)."""
    g = torch.Generator().manual_seed(seed)
    pool = init_pool_buffer(*GEOM, dtype=dtype or torch.float32,
                            device="cpu")
    if isinstance(pool, QuantKV):
        pool.q[:, :, 1:4] = torch.randint(-127, 128, pool.q[:, :, 1:4].shape,
                                          generator=g, dtype=torch.int8)
        pool.scale[:, :, 1:4] = torch.rand(pool.scale[:, :, 1:4].shape,
                                           generator=g)
    else:
        pool[:, :, 1:4] = torch.randn(pool[:, :, 1:4].shape, generator=g)
    return pool


def test_chaos_kill_mid_handoff_leaves_rejectable_debris(tmp_path):
    d = str(tmp_path / "killed")
    with chaos.session(seed=0) as c:
        c.on("serve.kv_handoff", action="kill", at=2)
        with pytest.raises(chaos.ChaosKilled):
            stream_kv_handoff(d, _filled_pool(), [1, 2, 3])
    assert os.path.exists(d) and "KV_MANIFEST.pkl" not in os.listdir(d)
    with pytest.raises(CheckpointCorruptError):
        load_kv_handoff(d, init_pool_buffer(*GEOM, device="cpu"), [4, 5, 6])
    discard_kv_handoff(d)
    assert not os.path.exists(d)


def test_forced_preemption_on_decode_engine_equals_the_jax_engine(
        model, tmp_path):
    p0 = obs.counter("serve.preemptions").value
    eng = DisaggregatedEngine(model, num_blocks=64, block_size=4,
                              max_batch=4, prefill_chunk=4, decode_blocks=9,
                              handoff_dir=str(tmp_path))
    out = eng.run(refs.dry_reqs(Request, 3))
    assert obs.counter("serve.preemptions").value > p0
    ref = refs.jax_dry_refs()
    assert out == {k: ref[k] for k in out}
    _check_disagg(eng)


def test_disagg_refuses_window_and_never_fit(model, tmp_path):
    with pytest.raises(NotImplementedError, match="window"):
        _disagg(model, tmp_path, window=8)
    eng = _disagg(model, tmp_path, draft=make_self_draft(model), spec_k=4,
                  decode_blocks=128)
    with pytest.raises(ValueError):
        eng.submit(Request("big", list(range(1, 90)), 10))


# ---------------------------------------------------------------------------
# the handoff: error taxonomy, and both packages' files
# ---------------------------------------------------------------------------


def _as_np(part):
    return np.asarray(part)


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_kv_handoff_roundtrip_bitwise(tmp_path, dtype):
    pool = _filled_pool(dtype)
    d = str(tmp_path / "h")
    manifest, peak = stream_kv_handoff(d, pool, [1, 2, 3])
    assert manifest["n_blocks"] == 3 and manifest["quant"] == bool(dtype)
    assert read_kv_handoff_meta(d)["blocks"] == manifest["blocks"]
    assert peak == (BLOCK_BYTES // 4 if dtype else BLOCK_BYTES)
    dst = init_pool_buffer(*GEOM, dtype=dtype or torch.float32, device="cpu")
    got, peak2 = load_kv_handoff(d, dst, [5, 6, 7])
    assert got is dst and peak2 == peak
    for a, b in zip(pool if dtype else (pool,), dst if dtype else (dst,)):
        assert torch.equal(a[:, :, [1, 2, 3]], b[:, :, [5, 6, 7]])
        assert not b[:, :, [1, 2, 3]].any()


def test_kv_handoff_crc_failure_is_corrupt(tmp_path):
    d = str(tmp_path / "h")
    manifest, _ = stream_kv_handoff(d, _filled_pool(), [1, 2, 3])
    path = os.path.join(d, manifest["blocks"][1]["kv"]["file"])
    raw = bytearray(open(path, "rb").read())
    raw[0] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        load_kv_handoff(d, init_pool_buffer(*GEOM, device="cpu"), [4, 5, 6])


def test_kv_handoff_missing_block_or_manifest_is_corrupt(tmp_path):
    d = str(tmp_path / "h")
    manifest, _ = stream_kv_handoff(d, _filled_pool(), [1, 2, 3])
    os.remove(os.path.join(d, manifest["blocks"][2]["kv"]["file"]))
    with pytest.raises(CheckpointCorruptError):
        load_kv_handoff(d, init_pool_buffer(*GEOM, device="cpu"), [4, 5, 6])
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        load_kv_handoff(str(tmp_path / "nope"),
                        init_pool_buffer(*GEOM, device="cpu"), [1])


def test_kv_handoff_geometry_and_count_mismatch_is_reshard(tmp_path):
    d = str(tmp_path / "h")
    stream_kv_handoff(d, _filled_pool(), [1, 2, 3])
    with pytest.raises(CheckpointReshardError):
        load_kv_handoff(d, init_pool_buffer(*GEOM, dtype="int8",
                                            device="cpu"), [4, 5, 6])
    with pytest.raises(CheckpointReshardError):
        load_kv_handoff(d, init_pool_buffer(2, 4, 4, 8, 8, device="cpu"),
                        [4, 5, 6])
    with pytest.raises(CheckpointReshardError):
        load_kv_handoff(d, init_pool_buffer(*GEOM, device="cpu"), [4, 5])


@pytest.mark.parametrize("dtype", [None, "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_kv_handoff_crosses_the_packages_bitwise(tmp_path, writer, dtype):
    """A handoff that one package streams loads into the other package's
    pool, every byte of the payload (and of the int8 scales) equal."""
    ours = _filled_pool(dtype, seed=3)
    parts = list(ours) if dtype else [ours]
    theirs = jax_init_pool(*GEOM, dtype=dtype or np.float32)
    if dtype:
        theirs = type(theirs)(theirs.q.at[:].set(_as_np(parts[0])),
                              theirs.scale.at[:].set(_as_np(parts[1])))
    else:
        theirs = theirs.at[:].set(_as_np(parts[0]))
    d = str(tmp_path / "x")
    if writer == "jax":
        jax_res.stream_kv_handoff(d, theirs, [1, 2, 3], source="jax")
        dst = init_pool_buffer(*GEOM, dtype=dtype or torch.float32,
                               device="cpu")
        load_kv_handoff(d, dst, [5, 6, 7])
        got = [_as_np(p) for p in (dst if dtype else (dst,))]
    else:
        stream_kv_handoff(d, ours, [1, 2, 3], source="port")
        dst, _ = jax_res.load_kv_handoff(
            d, jax_init_pool(*GEOM, dtype=dtype or np.float32), [5, 6, 7])
        got = [_as_np(p) for p in (dst if dtype else (dst,))]
    for src, out in zip(parts, got):
        np.testing.assert_array_equal(_as_np(src)[:, :, [1, 2, 3]],
                                      out[:, :, [5, 6, 7]])
        assert not out[:, :, [1, 2, 3]].any()
