"""The port's draft construction and distillation (``apex_tpu_torch/
inference/draft.py``) against ``apex_tpu/inference/draft.py``, on the CPU.

* ``make_self_draft`` is an independent eval-mode copy that leaves the
  target's cached decode runs behind, and a speculative decode with it
  accepts every proposal;
* ``train_draft`` draws the JAX function's windows from
  ``numpy.random.default_rng(seed)``, labels them with the target's
  argmax and steps one ``FusedAdam`` train step: its losses match the JAX
  function's within the train-step tests' tolerance;
* ``make_distill_step`` keeps one optimizer and one step across calls,
  and its masters move as the JAX step's do.
"""
import numpy as np
import pytest
import torch

from apex_tpu.inference import draft as jax_draft

from apex_tpu_torch.inference import (make_self_draft, speculative_generate,
                                      train_draft)
from apex_tpu_torch.inference.draft import make_distill_step
from apex_tpu_torch.models import generate
from torch_decode_pairs import ids, pair

torch.set_num_threads(2)

SMALL = dict(hidden=16, layers=1, heads=2, kv_heads=1, intermediate=32)


def test_self_draft_is_an_independent_copy():
    _, tm = pair("llama", seed=61)
    prompt = torch.from_numpy(ids(1, 1, 4))
    want = generate(tm, prompt, 5)          # fills the target's run cache
    d = make_self_draft(tm)
    assert not d.training and not d.__dict__.get("_generate_jit_cache")
    assert tm._generate_jit_cache
    for a, b in zip(d.parameters(), tm.parameters()):
        assert a is not b and torch.equal(a, b)
    _, stats = speculative_generate(tm, d, prompt, 5, k=3,
                                    return_stats=True)
    assert stats["draft_acceptance"] == 1.0
    with torch.no_grad():
        next(d.parameters()).add_(1.0)
    assert torch.equal(generate(tm, prompt, 5), want)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_train_draft_losses_match_jax(family):
    jt, tt = pair(family, seed=62)
    kw = dict(SMALL) if family == "llama" else dict(
        hidden=16, layers=1, heads=2)
    jd, td = pair(family, seed=63, **kw)
    tokens = ids(2, 1, 300)[0]
    want = jax_draft.train_draft(jd, jt, tokens, steps=4, batch_size=2,
                                 seq_len=8, lr=1e-2, seed=3)
    got = train_draft(td, tt, tokens, steps=4, batch_size=2, seq_len=8,
                      lr=1e-2, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert not td.training
    with pytest.raises(ValueError, match="seq_len"):
        train_draft(td, tt, tokens[:8], seq_len=8)


def test_distill_step_persists_and_moves_its_masters():
    jt, tt = pair("llama", seed=64)
    jd, td = pair("llama", seed=65, **SMALL)
    jstep = jax_draft.make_distill_step(jd, jt, lr=1e-2)
    tstep = make_distill_step(td, tt, lr=1e-2)
    opt, step = tstep.optimizer, tstep.step
    r = np.random.default_rng(4)
    for _ in range(3):
        xs = r.integers(0, 96, (2, 8))
        np.testing.assert_allclose(tstep(xs), jstep(xs), rtol=1e-4,
                                   atol=1e-5)
    assert tstep.calls == 3 and tstep.optimizer is opt and tstep.step is step
    for got, want in zip(step.state.master_params,
                         jstep.step.state.master_params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
