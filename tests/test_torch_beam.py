"""The port's ``beam_generate`` (``apex_tpu_torch/inference/beam.py``)
against ``apex_tpu.inference.beam_generate``, on the CPU.

* ``num_beams=1`` equals greedy ``generate`` bit for bit;
* GPT and Llama beams, with ``eos_id`` freezing and the GNMT
  ``length_penalty``, and an int8 cache, give the JAX function's tokens;
* the eager (un-captured) step gives the program's tokens; the bucket is
  cached per model; the validation errors are the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import beam_generate as jax_beam

from apex_tpu_torch.inference import beam
from apex_tpu_torch.inference.beam import beam_generate
from apex_tpu_torch.models import generate
from torch_decode_pairs import ids, pair

torch.set_num_threads(2)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_beams_equal_jax_and_one_beam_is_greedy(family):
    jm, tm = pair(family, seed=51)
    prompt = ids(1, 2, 5)
    tp = torch.from_numpy(prompt)
    assert torch.equal(beam_generate(tm, tp, 7, 1), generate(tm, tp, 7))
    for kw in (dict(num_beams=3), dict(num_beams=4, eos_id=7,
                                       length_penalty=0.8),
               dict(num_beams=2, cache_dtype="int8")):
        want = np.asarray(jax_beam(jm, jnp.asarray(prompt), 6, **kw))
        got = beam_generate(tm, tp, 6, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))


def test_eos_freezes_and_the_eager_step_agrees():
    jm, tm = pair("gpt", seed=52, vocab_size=12)
    prompt = ids(2, 2, 3, v=12)
    # a small vocab, so beams reach eos and freeze
    for eos in (0, 3, 5):
        want = np.asarray(jax_beam(jm, jnp.asarray(prompt), 8, 3,
                                   eos_id=eos, length_penalty=1.0))
        got = beam_generate(tm, torch.from_numpy(prompt), 8, 3, eos_id=eos,
                            length_penalty=1.0)
        np.testing.assert_array_equal(got.numpy(), want)
    (entry,) = [e for e in tm._beam_jit_cache.values()][-1:]
    graph = entry[-1]
    eager = graph.generate(torch.from_numpy(prompt), 8, eager=True)
    np.testing.assert_array_equal(eager.numpy(), want)
    assert isinstance(graph, beam.BeamGraph)


def test_validation_is_the_jax_packages():
    _, tm = pair("llama", seed=53)
    p = torch.zeros((1, 4), dtype=torch.long)
    for kw, what in ((dict(num_beams=0), "num_beams"),
                     (dict(num_beams=97), "exceeds vocab"),
                     (dict(num_beams=2, eos_id=96), "eos_id"),
                     (dict(num_beams=2, length_penalty=-1.0),
                      "length_penalty")):
        with pytest.raises(ValueError, match=what):
            beam_generate(tm, p, 3, **kw)
    with pytest.raises(ValueError, match="max_new_tokens"):
        beam_generate(tm, p, 0, 2)
    with pytest.raises(ValueError, match="max_positions"):
        beam_generate(tm, p, 61, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        beam_generate(tm, p, 3, 2, mesh="a mesh")
