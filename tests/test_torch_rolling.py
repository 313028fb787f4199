"""The port's rolling sliding-window KV cache (``apex_tpu_torch/inference/
rolling.py``) and Llama's windowed decode against ``apex_tpu``'s, on the
CPU.

* ``rolling_slot_positions`` and ``window_retired_blocks`` equal the JAX
  functions exactly; ``rolling_kv_write`` stores the JAX function's values
  (float and int8 caches, single-slot and wrapping chunks, chunks longer
  than the cache, Python-int and device positions);
* a windowed model allocates ``window + ROLLING_SLACK`` slots; its prefill
  runs the flash band and its ``decode_chunk`` the closed-form mask, which
  match the JAX model's logits within the JAX tests' tolerances at any
  chunk schedule;
* greedy ``generate`` (far past the window), int8 and beam decode of a
  windowed model give the JAX package's tokens; an undersized cache
  refuses to wrap.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import beam_generate as jax_beam
from apex_tpu.inference import rolling as jr
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.nn.modules import Ctx

from apex_tpu_torch.inference import beam_generate, rolling
from apex_tpu_torch.models import generate
from torch_decode_pairs import ids, llama_pair

torch.set_num_threads(2)

W = 8


@pytest.fixture(scope="module")
def banded():
    return llama_pair(5, sliding_window=W, max_positions=96)


def test_slot_positions_and_retired_blocks_equal_jax():
    for n, t_hi in ((8, 0), (8, 3), (8, 8), (40, 57), (40, 200), (5, 11)):
        want = np.asarray(jr.rolling_slot_positions(n, t_hi))
        got = rolling.rolling_slot_positions(n, t_hi)
        np.testing.assert_array_equal(got.numpy(), want)
        got = rolling.rolling_slot_positions(n, torch.tensor(t_hi))
        np.testing.assert_array_equal(got.numpy(), want)
    for t_hi, window, bs in ((0, 8, 4), (30, 8, 4), (31, 16, 8), (100, None,
                                                                  4)):
        assert rolling.window_retired_blocks(t_hi, window, bs) == \
            jr.window_retired_blocks(t_hi, window, bs)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_rolling_writes_store_the_jax_values(cache_dtype):
    from apex_tpu.inference.quant import make_kv_cache as jax_make
    from apex_tpu_torch.inference.quant import QuantKV, make_kv_cache
    r = np.random.default_rng(0)
    shape = (1, 2, W + 3, 4)
    jc = jax_make(shape, jnp.int8 if cache_dtype == "int8" else jnp.float32)
    tc = make_kv_cache(shape, torch.int8 if cache_dtype == "int8"
                       else torch.float32, "cpu")
    t = 0
    for i, length in enumerate((3, 1, W, 5, 2, 1, 17, 4)):
        new = r.standard_normal((1, 2, length, 4)).astype(np.float32)
        jc = jr.rolling_kv_write(jc, jnp.asarray(new), t)
        pos = torch.tensor(t) if i % 2 else t
        tc = rolling.rolling_kv_write(tc, torch.from_numpy(new), pos)
        t += length
        for got, want in zip(tc if isinstance(tc, QuantKV) else (tc,),
                             jc if cache_dtype == "int8" else (jc,)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_windowed_caches_hold_window_plus_slack_slots(banded):
    _, tm = banded
    caches = tm.init_caches(1, 96)
    assert caches[0][0].shape[2] == W + rolling.ROLLING_SLACK
    assert tm._cache_capacity(caches) == 96
    small = tm.init_caches(1, 12)
    assert small[0][0].shape[2] == 12 and tm._cache_capacity(small) == 12


def test_prefill_and_chunk_schedules_match_jax(banded):
    jm, tm = banded
    toks = ids(7, 1, 45)
    ctx = Ctx(training=False)
    want = np.asarray(jm.forward(ctx, jnp.asarray(toks)))
    with torch.no_grad():
        caches = tm.init_caches(1, 96)
        got, caches = tm.prefill(torch.from_numpy(toks[:, :30]), caches)
        np.testing.assert_allclose(got.numpy(), want[:, :30], rtol=2e-4,
                                   atol=2e-4)
        t, outs = 30, []
        for c in (1, 5, 1, 8):
            lg, caches = tm.decode_chunk(torch.from_numpy(toks[:, t:t + c]),
                                         caches, torch.tensor(t))
            outs.append(lg.numpy())
            t += c
        np.testing.assert_allclose(np.concatenate(outs, 1), want[:, 30:],
                                   rtol=3e-4, atol=3e-4)
        # one chunk longer than the window and the slots
        caches = tm.init_caches(1, 96)
        got, _ = tm.decode_chunk(torch.from_numpy(toks), caches, 0)
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def test_windowed_generate_int8_and_beam_equal_jax(banded):
    jm, tm = banded
    prompt = ids(8, 2, 20)
    for kw in ({}, dict(cache_dtype="int8")):
        want = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 40,
                                           **kw))
        got = generate(tm, torch.from_numpy(prompt), 40, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax_beam(jm, jnp.asarray(prompt), 8, 3))
    got = beam_generate(tm, torch.from_numpy(prompt), 8, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_an_undersized_windowed_cache_refuses_to_wrap():
    _, wide = llama_pair(6, sliding_window=100, max_positions=64)
    caches = wide.init_caches(1, 12)
    toks = torch.from_numpy(ids(9, 1, 3))
    with torch.no_grad():
        wide.decode_chunk(toks, caches, 0)
        with pytest.raises(ValueError, match="cache capacity"):
            wide.decode_chunk(toks, caches, 12)
