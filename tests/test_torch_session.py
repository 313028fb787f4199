"""The port's ``DecodeSession`` (``apex_tpu_torch/inference/session.py``)
against ``apex_tpu.inference.DecodeSession``, on the CPU.

* a single turn, a multi-turn chat and back-to-back ``generate`` calls
  give the JAX session's tokens; ``append``'s logits match the JAX
  session's within the JAX tests' tolerance; a session equals one-shot
  ``generate`` on its history;
* a windowed (rolling-cache) model's session past the window, and an int8
  cache, give the JAX tokens;
* the session's graphs key on its capacity and its parameters (a LoRA
  apply mid-session misses); sampling follows the generator; the
  validation errors are the JAX package's, ``PagedSession``'s too (its
  parity with the JAX session is in test_torch_serve.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import DecodeSession as JaxSession

from apex_tpu_torch.inference import DecodeSession, PagedSession
from apex_tpu_torch.models import generate
from apex_tpu_torch.reparameterization import apply_lora
from torch_decode_pairs import ids, pair

torch.set_num_threads(2)


def _turns(jm, tm, turns, gens, capacity=48, batch=2, **kw):
    js = JaxSession(jm, batch=batch, capacity=capacity, **kw)
    ts = DecodeSession(tm, batch=batch, capacity=capacity, **kw)
    for i, (turn, n) in enumerate(zip(turns, gens)):
        jl = js.append(jnp.asarray(turn))
        tl = ts.append(torch.from_numpy(turn))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for _ in range(2 if i == 0 else 1):     # back to back once
            want = np.asarray(js.generate(n))
            got = ts.generate(n)
            np.testing.assert_array_equal(got.numpy(), want)
    assert ts.position == js.position
    return ts


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_chat_turns_equal_the_jax_session_and_one_shot(family):
    jm, tm = pair(family, seed=31)
    t1, t2 = ids(1, 2, 6), ids(2, 2, 3)
    _turns(jm, tm, (t1, t2), (4, 5))
    # the history as one prompt: one-shot generate continues the same
    s = DecodeSession(tm, batch=2, capacity=48)
    s.append(torch.from_numpy(t1))
    a = s.generate(4)
    s.append(torch.from_numpy(t2))
    b = s.generate(5)
    history = torch.cat([torch.from_numpy(t1), a, torch.from_numpy(t2)], 1)
    assert torch.equal(generate(tm, history, 5)[:, -5:], b)
    # the un-captured steps (the card's reference arm) give the same
    e = DecodeSession(tm, batch=2, capacity=48)
    e._eager = True
    e.append(torch.from_numpy(t1))
    assert torch.equal(e.generate(4), a)


def test_windowed_and_int8_sessions_equal_jax():
    jm, tm = pair("llama", seed=32, sliding_window=8, max_positions=96)
    _turns(jm, tm, (ids(3, 1, 12), ids(4, 1, 9)), (10, 12), capacity=96,
           batch=1)
    jm, tm = pair("gpt", seed=33)
    _turns(jm, tm, (ids(5, 2, 5), ids(6, 2, 2)), (3, 4),
           cache_dtype="int8")


def test_graphs_key_on_capacity_and_parameters_and_sampling():
    _, tm = pair("llama", seed=34)
    s = DecodeSession(tm, batch=1, capacity=32)
    s.append(torch.from_numpy(ids(7, 1, 4)))
    s.generate(2)
    s.generate(2)
    assert len(s._session_jit_cache) == 1
    (key,) = s._session_jit_cache
    assert key[:2] == (1, 32)
    apply_lora(tm, "blocks.0.q_proj.weight", r=2,
               generator=torch.Generator().manual_seed(0))
    s.generate(2)
    assert len(s._session_jit_cache) == 2           # a LoRA apply misses
    s.reset()
    assert s.position == 0
    s.append(torch.from_numpy(ids(7, 1, 4)))
    g1 = s.generate(5, temperature=0.8, top_k=10,
                    generator=torch.Generator().manual_seed(3))
    s.reset()
    s.append(torch.from_numpy(ids(7, 1, 4)))
    g2 = s.generate(5, temperature=0.8, top_k=10,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(g1, g2) and int(g1.max()) < 96


def test_session_validation_is_the_jax_packages():
    _, tm = pair("gpt", seed=35)
    with pytest.raises(ValueError, match="capacity"):
        DecodeSession(tm, capacity=0)
    with pytest.raises(ValueError, match="capacity"):
        DecodeSession(tm, capacity=65)
    s = DecodeSession(tm, batch=1, capacity=8)
    with pytest.raises(ValueError, match="empty session"):
        s.generate(2)
    with pytest.raises(ValueError, match="batch=1"):
        s.append(torch.zeros((2, 3), dtype=torch.long))
    s.append(torch.zeros((1, 6), dtype=torch.long))
    with pytest.raises(ValueError, match="exceeds"):
        s.generate(3)
    with pytest.raises(ValueError, match="max_new_tokens"):
        s.generate(0)
    with pytest.raises(ValueError, match="Generator"):
        s.generate(1, temperature=0.5)
    from apex_tpu_torch.serve import ServeEngine
    ps = PagedSession(ServeEngine(tm, num_blocks=16, block_size=8,
                                  prefill_chunk=4))
    with pytest.raises(ValueError, match="empty session"):
        ps.generate(2)
    with pytest.raises(ValueError, match="zero tokens"):
        ps.append([])
    ps.append([1, 2, 3])
    with pytest.raises(ValueError, match="max_new_tokens"):
        ps.generate(0)
    with pytest.raises(ValueError, match="exceed max_positions"):
        ps.append(list(range(70)))
    ps.close()
    ps = PagedSession(ServeEngine(tm, num_blocks=4, block_size=8,
                                  prefill_chunk=4))
    with pytest.raises(RuntimeError, match="exhausted"):
        ps.append(list(range(30)))
    ps.close()
    assert ps.position == 0 and ps.block_table == ()
