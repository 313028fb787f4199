"""Decode through the port's cached per-bucket programs
(``apex_tpu_torch/inference/decode.py``, ``utils/jit_cache.py``) against
the JAX package's compiled decode, on the CPU.

On the card each bucket's decode step is captured as a CUDA graph on its
second call and replayed (``chip_smoke.py`` holds every replay bit for bit
against the eager loop); here the same program runs eagerly on every
call.  These tests hold:

* the device-position decode protocol (a 0-d int64 tensor) equals the
  Python-int one bit for bit, for GPT and Llama, float and int8 caches;
* greedy ``generate`` and ``seq2seq_generate`` equal the JAX package's
  tokens, and the bucket's per-step logits its decode's within the JAX
  tests' tolerance; prompts of nearby lengths share one bucket;
* a sampled ``generate`` through the program draws what the eager loop
  draws from the same generator;
* ``compiled_run_cache`` keeps the JAX invariants (a hit, a miss on a
  parameter swap, a LoRA apply, a merge and ``quantize_int8``, the LRU at
  16, the pinned objects), drops an entry whose tensors moved and bounds
  the bytes its entries hold; buckets of one shape share their caches;
* with the CUDA calls stubbed, as ``test_torch_executor.py`` does, a
  decode program runs its warm-up, captures once and replays.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt as jax_gpt
from apex_tpu.models import seq2seq as jax_seq2seq
from apex_tpu.nn.modules import Ctx
from apex_tpu.utils.jit_cache import compiled_run_cache as jax_cache

from apex_tpu_torch.inference import decode
from apex_tpu_torch.inference.quant import quantize_int8
from apex_tpu_torch.models import from_jax_state_dict, generate, \
    make_sampler, seq2seq
from apex_tpu_torch.reparameterization import apply_lora, \
    remove_reparameterization
from apex_tpu_torch.reparameterization.lora import LoRA
from apex_tpu_torch.runtime import executor
from apex_tpu_torch.utils.jit_cache import compiled_run_cache
from torch_decode_pairs import ids, pair, sd

torch.set_num_threads(2)

FAMILIES = ("gpt", "llama")


@pytest.fixture(scope="module")
def pairs():
    return {f: pair(f) for f in FAMILIES}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("cache_dtype", [torch.float32, "int8"])
def test_device_positions_equal_python_ints_bit_for_bit(pairs, family,
                                                        cache_dtype):
    _, tm = pairs[family]
    prompt = torch.from_numpy(ids(1, 2, 6))
    runs = []
    for as_tensor in (False, True):
        pos = (lambda t: torch.tensor(t)) if as_tensor else (lambda t: t)
        caches = tm.init_caches(2, 16, dtype=cache_dtype)
        out = []
        with torch.no_grad():
            tm.prefill(prompt, caches)
            lg, caches = tm.decode_chunk(prompt[:, :3], caches, pos(6))
            out.append(lg)
            for t in range(9, 12):
                lg, caches = tm.decode_step(prompt[:, t - 9], caches, pos(t))
                out.append(lg)
        leaves = [c for kv in caches for c in kv]
        leaves = [x for c in leaves for x in (c if isinstance(c, tuple)
                                              else (c,))]
        runs.append(out + leaves)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("p", [1, 7])
def test_greedy_generate_equals_jax(pairs, family, p):
    jm, tm = pairs[family]
    prompt = ids(2, 2, p)
    want = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 9))
    got = generate(tm, torch.from_numpy(prompt), 9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", FAMILIES)
def test_bucket_logits_match_the_jax_decode(pairs, family):
    """The bucket's prefill logits and every step's logits, against the
    JAX model's prefill and decode steps over the same tokens, at the
    JAX tests' 1e-4."""
    jm, tm = pairs[family]
    prompt = torch.from_numpy(ids(3, 2, 5))
    graph = decode.DecodeGraph(tm, 2, 16, torch.float32,
                               lambda lg, g: torch.argmax(lg, -1), False)
    logits = []
    out = graph.generate(prompt, 6, logits=logits)
    ctx = Ctx(env={}, training=False)
    caches = jm.init_caches(2, 16)
    lg, caches = jm.prefill(ctx, jnp.asarray(prompt.numpy()), caches)
    want = [np.asarray(lg[:, -1])]
    for t in range(5, 10):
        lg, caches = jm.decode_step(ctx, jnp.asarray(out[:, t].numpy()),
                                    caches, t)
        want.append(np.asarray(lg))
    assert len(logits) == len(want) == 6
    for got, w in zip(logits, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4)


def test_nearby_prompts_share_one_bucket(pairs):
    jm, tm = pairs["gpt"]
    tm.__dict__.pop("_generate_jit_cache", None)
    for p in (5, 9):
        prompt = ids(4 + p, 2, p)
        want = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 4))
        got = generate(tm, torch.from_numpy(prompt), 4)
        np.testing.assert_array_equal(got.numpy(), want)
    (entry,) = tm._generate_jit_cache.values()
    graph = entry[-1]
    assert graph.capacity == 64 and graph.run.program.entries()[0].calls == 6
    assert decode.bucket_capacity(130, 1024) == 256
    assert decode.bucket_capacity(130, 200) == 200


@pytest.mark.parametrize("family", FAMILIES)
def test_sampled_generate_draws_what_the_eager_loop_draws(pairs, family):
    _, tm = pairs[family]
    prompt = torch.from_numpy(ids(5, 2, 4))
    sample = make_sampler(0.9, 20, 0.95, 96)
    outs = []
    for eager in (False, True):
        graph = decode.DecodeGraph(tm, 2, 16, torch.float32, sample, True)
        g = torch.Generator().manual_seed(11)
        outs.append(graph.generate(prompt, 8, g, eager=eager))
    assert torch.equal(outs[0], outs[1])
    g = torch.Generator().manual_seed(11)
    assert torch.equal(generate(tm, prompt, 8, temperature=0.9, top_k=20,
                                top_p=0.95, generator=g), outs[0])
    g = torch.Generator().manual_seed(12)
    assert not torch.equal(generate(tm, prompt, 8, temperature=0.9,
                                    top_k=20, top_p=0.95, generator=g),
                           outs[0])


def test_sample_probs_is_multinomials_draw():
    """The graph-safe draw is ``torch.multinomial``'s for one sample."""
    probs = torch.softmax(torch.randn(4, 50, generator=torch.Generator()
                                      .manual_seed(0)), -1)
    for seed in range(3):
        a = decode.sample_probs(probs, torch.Generator().manual_seed(seed))
        b = torch.multinomial(probs, 1, generator=torch.Generator()
                              .manual_seed(seed))[:, 0]
        assert torch.equal(a, b)


def test_seq2seq_generate_through_its_bucket_equals_jax():
    import apex_tpu.nn as jnn
    cfg = dict(vocab_size=64, hidden=32, enc_layers=2, dec_layers=2,
               heads=4, max_positions=16, dropout=0.0, attn_dropout=0.0)
    jnn.manual_seed(2)
    jm = jax_seq2seq.TransformerSeq2Seq(**cfg)
    jm.eval()
    tm = from_jax_state_dict(
        seq2seq.TransformerSeq2Seq(**cfg, device="cpu").eval(), sd(jm))
    src = ids(6, 2, 10, v=64)
    mask = np.ones_like(src)
    mask[1, 7:] = 0
    want = np.asarray(jax_seq2seq.seq2seq_generate(
        jm, jnp.asarray(src), 6, src_attention_mask=jnp.asarray(mask)))
    for _ in range(2):
        got = seq2seq.seq2seq_generate(tm, torch.from_numpy(src), 6,
                                       src_attention_mask=torch.from_numpy(
                                           mask))
        np.testing.assert_array_equal(got.numpy(), want)
    (entry,) = tm._s2s_gen_cache.values()
    assert entry[-1].run.program.entries()[0].calls == 12
    eager = entry[-1].generate(torch.from_numpy(src),
                               torch.from_numpy(mask) == 0, 6, 0, None,
                               eager=True)
    np.testing.assert_array_equal(eager.numpy(), want)


# -- compiled_run_cache ---------------------------------------------------


class _Obj:
    pass


def test_run_cache_hits_misses_and_pins_as_jaxs():
    for cache in (compiled_run_cache, jax_cache):
        m = _Obj()
        p1, p2 = object(), object()
        builds = []

        def build():
            builds.append(1)
            return object()
        f1 = cache(m, "_c", ("cfg",), [p1, p2], build)
        assert cache(m, "_c", ("cfg",), [p1, p2], build) is f1
        assert cache(m, "_c", ("cfg",), [p1, object()], build) is not f1
        assert cache(m, "_c", ("other",), [p1, p2], build) is not f1
        assert len(builds) == 3
        entry = next(iter(m._c.values()))
        assert entry[0][0] is p1            # the entry pins the objects


def test_run_cache_evicts_the_least_recent_at_16():
    for cache in (compiled_run_cache, jax_cache):
        m, p = _Obj(), object()
        first = [cache(m, "_c", (i,), [p], object) for i in range(16)]
        assert cache(m, "_c", (0,), [p], object) is first[0]   # refreshed
        cache(m, "_c", (99,), [p], object)
        assert len(m._c) == 16
        assert cache(m, "_c", (0,), [p], object) is first[0]
        assert cache(m, "_c", (1,), [p], object) is not first[1]


def test_run_cache_drops_an_entry_whose_tensors_moved():
    m, w = _Obj(), torch.nn.Parameter(torch.ones(3))
    a = compiled_run_cache(m, "_c", ("k",), [w], object)
    assert compiled_run_cache(m, "_c", ("k",), [w], object) is a
    w.data = torch.zeros(3)                 # as sync_to_objects does
    assert compiled_run_cache(m, "_c", ("k",), [w], object) is not a


class _Held:
    """A cached run that holds device state: ``run.held()``."""

    def __init__(self, held):
        self.run = type("R", (), {"held": lambda _: held})()


def test_run_cache_bounds_the_bytes_its_entries_hold(monkeypatch):
    from apex_tpu_torch.utils import jit_cache
    monkeypatch.setattr(jit_cache, "HELD_BYTES", 200)
    m, p = _Obj(), object()
    runs = [compiled_run_cache(m, "_c", (i,), [p],
                               lambda i=i: _Held({("own", i): 40,
                                                  "shared": 100}))
            for i in range(3)]
    # a shared storage counts once: 100 + 40 + 40, then a third 40 is over
    assert [e[-1] for e in m._c.values()] == runs[1:]
    assert jit_cache.held_bytes(m, "_c") == 180
    # the newest stays whatever it holds
    big = compiled_run_cache(m, "_c", (9,), [p], lambda: _Held({"big": 1000}))
    assert [e[-1] for e in m._c.values()] == [big]


def test_buckets_of_one_shape_share_their_caches(pairs):
    """Greedy and sampled buckets of one (batch, capacity, cache dtype)
    hold one set of caches; each still decodes as it does alone."""
    from apex_tpu_torch.utils.jit_cache import held_bytes
    _, tm = pairs["gpt"]
    tm.__dict__.pop("_generate_jit_cache", None)
    prompt = torch.from_numpy(ids(21, 2, 5))
    greedy = generate(tm, prompt, 6)
    g = torch.Generator().manual_seed(3)
    sampled = generate(tm, prompt, 6, temperature=0.9, generator=g)
    runs = [e[-1] for e in tm._generate_jit_cache.values()]
    assert len(runs) == 2 and runs[0].caches is runs[1].caches
    alone = sum(runs[0].run.held().values())
    caches = sum(t.untyped_storage().nbytes() for kv in runs[0].caches
                 for t in kv)
    # the caches count once (a CPU run has no graph pool)
    assert held_bytes(tm, "_generate_jit_cache") == 2 * alone - caches
    assert torch.equal(generate(tm, prompt, 6), greedy)
    g.manual_seed(3)
    assert torch.equal(generate(tm, prompt, 6, temperature=0.9,
                                generator=g), sampled)


def test_generate_misses_after_lora_merge_and_quantize():
    tm = pair("llama", seed=7)[1]
    prompt = torch.from_numpy(ids(8, 1, 4))
    tm.__dict__.pop("_generate_jit_cache", None)

    def graphs():
        return [e[-1] for e in tm._generate_jit_cache.values()]
    generate(tm, prompt, 3)
    g0 = graphs()
    generate(tm, prompt, 3)
    assert graphs() == g0                   # a hit
    apply_lora(tm, "blocks.0.q_proj.weight", r=2,
               generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tm.blocks[0].q_proj.weight_lora_b.normal_(0, 0.5)
    lora = generate(tm, prompt, 3)
    assert len(graphs()) == 2               # LoRA applied: a miss
    remove_reparameterization(tm, LoRA, remove_all=True)
    assert torch.equal(generate(tm, prompt, 3), lora)
    assert len(graphs()) == 3               # merged: a miss
    quantize_int8(tm, min_size=256)
    generate(tm, prompt, 3)
    assert len(graphs()) == 4               # quantized: a miss


# -- the card's path with the CUDA calls stubbed ---------------------------


class _FakeStream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


def test_a_decode_program_captures_once_and_replays(pairs, monkeypatch):
    """``executor``'s card path with the CUDA calls stubbed (its test's
    stubs): the bucket's first step runs eagerly (the warm-up), the second
    is captured once and replayed, and every later step is a replay, so
    the step's Python runs twice however long the decode."""
    _, tm = pairs["gpt"]
    captures = []

    class Graph:
        def __init__(self, keep_graph=False):
            pass

        def register_generator_state(self, g):
            pass

        def instantiate(self):
            pass

        def replay(self):
            pass

    @contextlib.contextmanager
    def graph_ctx(graph, pool=None):
        captures.append(graph)
        yield
    for name, value in (("current_stream", lambda *a: _FakeStream()),
                        ("Stream", lambda *a: _FakeStream()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("graph_pool_handle", lambda: None),
                        ("CUDAGraph", Graph), ("graph", graph_ctx),
                        ("synchronize", lambda *a: None),
                        ("memory_reserved", lambda *a: 0),
                        ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    real_init = executor._Entry.__init__

    def card_entry(self, program, args):
        real_init(self, program, args)
        self.cuda = True
    monkeypatch.setattr(executor._Entry, "__init__", card_entry)
    graph = decode.DecodeGraph(tm, 1, 16, torch.float32,
                               lambda lg, g: torch.argmax(lg, -1), False)
    calls = []
    real_step = graph._step

    def counted(state, generator):
        calls.append(1)
        return real_step(state, generator)
    graph.run._fn = counted
    graph.generate(torch.from_numpy(ids(9, 1, 4)), 7)
    stats = graph.run.stats()
    assert len(calls) == 2 and len(captures) == 1
    assert stats["captures"] == 1 and stats["replays"] == 5


def test_a_bucket_made_in_inference_mode_runs_outside_it(pairs):
    _, tm = pairs["llama"]
    prompt = torch.from_numpy(ids(10, 1, 3))
    tm.__dict__.pop("_generate_jit_cache", None)
    with torch.inference_mode():
        want = generate(tm, prompt, 4)
    assert torch.equal(generate(tm, prompt, 4), want)
