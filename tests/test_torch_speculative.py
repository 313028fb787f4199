"""The port's ``speculative_generate`` (``apex_tpu_torch/inference/
speculative.py``) against ``apex_tpu.inference.speculative_generate``, on
the CPU.

* greedy: the output equals ``generate(target)`` bit for bit and the JAX
  function's tokens, for a random draft at several ``k``, an int8 draft,
  a self-draft (every proposal accepted, the stats equal to JAX's) and a
  ``k`` past the tokens left; with a sliding-window target and draft whose
  rounds reject and whose rolling caches wrap;
* sampled (Leviathan, batch 1): the second token's distribution over many
  generators matches the target's exact two-step marginal;
* the validation errors are the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import speculative_generate as jax_spec

from apex_tpu_torch.inference import (make_self_draft, quantize_int8,
                                      speculative_generate)
from apex_tpu_torch.models import generate
from torch_decode_pairs import ids, pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jt, tt = pair("llama", seed=41)
    jd, td = pair("llama", seed=42, hidden=16, layers=1, heads=2,
                  kv_heads=1)
    return jt, tt, jd, td


@pytest.mark.parametrize("k", [1, 3, 5])
def test_greedy_equals_generate_and_jax(models, k):
    jt, tt, jd, td = models
    prompt = ids(1, 2, 5)
    want = generate(tt, torch.from_numpy(prompt), 8)
    got = speculative_generate(tt, td, torch.from_numpy(prompt), 8, k=k)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_spec(jt, jd, jnp.asarray(prompt), 8,
                                         k=k)))


def test_int8_draft_self_draft_and_stats(models):
    _, tt, _, _ = models
    prompt = torch.from_numpy(ids(2, 1, 4))
    want = generate(tt, prompt, 10)
    q = quantize_int8(pair("llama", seed=43)[1], min_size=1)
    assert torch.equal(speculative_generate(tt, q, prompt, 10, k=4), want)
    self_draft = make_self_draft(tt)
    assert self_draft is not tt and not self_draft.training
    assert all(a is not b for a, b in zip(self_draft.parameters(),
                                          tt.parameters()))
    # 9 new tokens: the prefill's and two rounds of k + 1 = 4
    got, stats = speculative_generate(tt, self_draft, prompt, 9, k=3,
                                      return_stats=True)
    assert torch.equal(got, want[:, :13])
    assert stats["rounds"] == 2 and stats["draft_acceptance"] == 1.0
    # k past the tokens left: the rounds overshoot into the slack
    assert torch.equal(speculative_generate(tt, self_draft, prompt[:, :3],
                                            3, k=8),
                       generate(tt, prompt[:, :3], 3))


def test_stats_equal_jax_for_a_self_draft():
    jt, tt = pair("gpt", seed=44)
    prompt = ids(3, 2, 4)
    _, want = jax_spec(jt, jt, jnp.asarray(prompt), 9, k=3,
                       return_stats=True)
    got, stats = speculative_generate(tt, make_self_draft(tt),
                                      torch.from_numpy(prompt), 9, k=3,
                                      return_stats=True)
    assert stats == want
    assert torch.equal(got, generate(tt, torch.from_numpy(prompt), 9))


def test_windowed_rounds_reject_and_wrap_as_jax():
    """Window 8: the rolling caches hold 8 + ROLLING_SLACK = 40 slots, so
    the 64 positions wrap them while rejected chunks rewind."""
    jt, tt = pair("llama", seed=45, sliding_window=8, max_positions=96)
    jd, td = pair("llama", seed=46, sliding_window=8, max_positions=96)
    prompt = ids(4, 2, 20)
    got, stats = speculative_generate(tt, td, torch.from_numpy(prompt), 40,
                                      k=4, return_stats=True)
    assert stats["draft_acceptance"] < 1.0          # rounds rejected
    assert torch.equal(got, generate(tt, torch.from_numpy(prompt), 40))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_spec(jt, jd, jnp.asarray(prompt), 40,
                                         k=4)))
    with pytest.raises(ValueError, match="ROLLING_SLACK"):
        speculative_generate(tt, td, torch.from_numpy(prompt), 4, k=32)


def test_sampled_matches_the_targets_two_step_marginal():
    _, target = pair("llama", seed=47, vocab_size=16, hidden=16, layers=1,
                     heads=2, kv_heads=1)
    _, draft = pair("llama", seed=48, vocab_size=16, hidden=16, layers=1,
                    heads=2, kv_heads=1)
    prompt = torch.from_numpy(ids(5, 1, 4, v=16))
    with torch.no_grad():
        base = torch.softmax(target(prompt)[0, -1].double(), -1)
        ext = torch.cat([prompt.repeat(16, 1), torch.arange(16)[:, None]], 1)
        p2 = torch.softmax(target(ext)[:, -1].double(), -1)
    marg = (base[:, None] * p2).sum(0).numpy()
    counts = np.zeros(16)
    n = 300
    for i in range(n):
        out = speculative_generate(target, draft, prompt, 2, k=2,
                                   temperature=1.0,
                                   generator=torch.Generator()
                                   .manual_seed(1000 + i))
        counts[int(out[0, 5])] += 1
    tv = 0.5 * np.abs(counts / n - marg).sum()
    assert tv < 0.12, tv


def test_validation_is_the_jax_packages(models):
    _, tt, _, td = models
    prompt = torch.from_numpy(ids(6, 2, 4))
    with pytest.raises(ValueError, match="Generator"):
        speculative_generate(tt, td, prompt, 4, temperature=0.8)
    with pytest.raises(ValueError, match="batch 1"):
        speculative_generate(tt, td, prompt, 4, temperature=0.8,
                             generator=torch.Generator())
    with pytest.raises(ValueError, match="temperature"):
        speculative_generate(tt, td, prompt[:1], 4, temperature=-1.0)
    with pytest.raises(ValueError, match="k must be"):
        speculative_generate(tt, td, prompt, 4, k=0)
    with pytest.raises(ValueError, match="slack"):
        speculative_generate(tt, td, prompt, 58, k=4)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        speculative_generate(tt, td, prompt, 4, mesh="a mesh")
