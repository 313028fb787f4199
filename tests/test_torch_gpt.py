"""The port's GPT (apex_tpu_torch.models.gpt) against the JAX package's, on
a tiny model whose weights are carried across by ``from_jax_state_dict``.

The JAX side runs its Pallas kernels in interpret mode where the path
reaches them (forward, prefill, decode); the port runs on CPU tensors, so
its kernel wrappers take their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.models import GptModel as JaxGpt
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.nn.modules import Ctx

from apex_tpu_torch.inference.quant import kv_write, make_kv_cache
from torch_products import value_products
from apex_tpu_torch.models import GptModel, from_jax_state_dict, generate, \
    nucleus_filter

torch.set_num_threads(2)

V, E, L, HEADS, MAXPOS = 128, 64, 2, 4, 32
CFG = dict(vocab_size=V, hidden=E, layers=L, heads=HEADS,
           max_positions=MAXPOS, dropout=0.0, attn_dropout=0.0)


def _sd(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def _pair(seed=5, **kw):
    """A JAX model from a seed and the port's copy of it (CPU, eval)."""
    cfg = {**CFG, **kw}
    jnn.manual_seed(seed)
    jm = JaxGpt(**cfg)
    jm.eval()
    tm = GptModel(**cfg, device="cpu").eval()
    return jm, from_jax_state_dict(tm, _sd(jm))


def _ids(seed, b, s, v=V):
    return np.random.default_rng(seed).integers(0, v, (b, s))


def _ctx():
    return Ctx(env={}, training=False)


@pytest.fixture(scope="module")
def models():
    return _pair()


def test_forward_matches_jax(models):
    jm, tm = models
    ids = _ids(1, 2, 12)
    with force_mode("interpret"):
        want = np.asarray(jm.forward(_ctx(), jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_forward_with_attention_biases_matches_jax():
    """attn_bias=True selects the materializing 'default' attention impl;
    non-zero biases make the interleaved bias layout count."""
    jm, _ = _pair(seed=7, attn_bias=True)
    sd = _sd(jm)
    r = np.random.default_rng(2)
    for k in sd:
        if k.endswith("proj_bias"):
            sd[k] = r.normal(0, 0.5, sd[k].shape).astype(np.float32)
    jm.load_state_dict(sd)
    tm = from_jax_state_dict(
        GptModel(**CFG, attn_bias=True, device="cpu").eval(), sd)
    ids = _ids(2, 2, 10)
    with force_mode("interpret"):
        want = np.asarray(jm.forward(_ctx(), jnp.asarray(ids)))
        caches = jm.init_caches(2, 12)
        want_pre, _ = jm.prefill(_ctx(), jnp.asarray(ids), caches)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
        got_pre, _ = tm.prefill(torch.from_numpy(ids), tm.init_caches(2, 12))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre),
                               rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_steps_match_jax(models):
    jm, tm = models
    ids = _ids(3, 2, 8)
    nxt = _ids(4, 2, 3)
    ctx = _ctx()
    with force_mode("interpret"):
        lj, cj = jm.prefill(ctx, jnp.asarray(ids), jm.init_caches(2, 12))
        want = [np.asarray(lj)]
        for i in range(3):
            lj, cj = jm.decode_step(ctx, jnp.asarray(nxt[:, i]), cj,
                                    jnp.asarray(8 + i))
            want.append(np.asarray(lj))
    with torch.inference_mode():
        lt, ct = tm.prefill(torch.from_numpy(ids), tm.init_caches(2, 12))
        got = [lt.numpy()]
        for i in range(3):
            lt, ct = tm.decode_step(torch.from_numpy(nxt[:, i]), ct, 8 + i)
            got.append(lt.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    # the caches hold the same keys and values
    np.testing.assert_allclose(ct[1][0].numpy()[:, :, :11],
                               np.asarray(cj[1][0])[:, :, :11],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", [5, 1])
def test_greedy_generate_equals_jax(models, p):
    """Both branches: prefill + decode steps (p > 1) and the
    teacher-forced decode loop (p == 1)."""
    jm, tm = models
    prompt = _ids(5, 2, p)
    want = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 7))
    got = generate(tm, torch.from_numpy(prompt), 7)
    assert got.shape == (2, p + 7) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_zero_new_tokens_returns_prompt(models):
    _, tm = models
    prompt = torch.from_numpy(_ids(6, 2, 4))
    assert torch.equal(generate(tm, prompt, 0), prompt)


def test_nucleus_filter_equals_jax():
    logits = np.random.default_rng(8).normal(0, 3, (4, 50)).astype(
        np.float32)
    for top_p in (0.3, 0.9, 1.0):
        want = np.asarray(jax_gpt.nucleus_filter(jnp.asarray(logits),
                                                 top_p))
        got = nucleus_filter(torch.from_numpy(logits), top_p).numpy()
        np.testing.assert_array_equal(got, want)


def test_pad_vocab_multiple_masks_pad_columns():
    jm, tm = _pair(seed=9, vocab_size=100, pad_vocab_multiple=64)
    assert tm.padded_vocab == 128 and tm.tok_emb.weight.shape[0] == 128
    ids = _ids(10, 2, 6, v=100)
    with force_mode("interpret"):
        want = np.asarray(jm.forward(_ctx(), jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert (got[..., 100:] == -1e30).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    out = generate(tm, torch.from_numpy(ids), 4)
    assert int(out.max()) < 100


def test_sampling_stays_in_vocab_and_follows_the_generator(models):
    _, tm = models
    prompt = torch.from_numpy(_ids(11, 2, 4))

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return generate(tm, prompt, 12, temperature=1.0, generator=g, **kw)

    s1, s2 = run(1), run(2)
    assert torch.equal(s1, run(1))
    assert not torch.equal(s1, s2)
    for s in (s1, s2, run(1, top_k=5), run(1, top_p=0.8)):
        assert s.shape == (2, 16)
        assert int(s.min()) >= 0 and int(s.max()) < V
        assert torch.equal(s[:, :4], prompt)


def test_out_of_range_positions_raise(models):
    _, tm = models
    caches = tm.init_caches(1, 16)
    tok = torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="max_positions"):
        generate(tm, torch.zeros(1, 30, dtype=torch.long), 5)
    with pytest.raises(ValueError, match="torch.Generator"):
        generate(tm, torch.zeros(1, 4, dtype=torch.long), 2, temperature=0.5)
    with pytest.raises(ValueError, match="out of range"):
        tm.decode_step(tok, caches, 16)           # past the cache
    with pytest.raises(ValueError, match="out of range"):
        tm.decode_step(tok, caches, -1)
    with pytest.raises(ValueError, match="out of range"):
        tm.decode_chunk(torch.zeros(1, 4, dtype=torch.long), caches, 14)
    with pytest.raises(ValueError, match="out of range"):
        tm.prefill(torch.zeros(1, 17, dtype=torch.long), caches)
    with pytest.raises(ValueError, match="max_positions"):
        tm(torch.zeros(1, MAXPOS + 1, dtype=torch.long))
    with pytest.raises(ValueError, match="does not fit"):
        kv_write(caches[0][0], torch.zeros(1, HEADS, 2, E // HEADS),
                 (0, 0, 15, 0))
    # the int8 cache is a QuantKV (values int8, one fp32 scale a position)
    q8 = make_kv_cache((1, 1, 4, 4), "int8", "cpu")
    assert q8.q.dtype == torch.int8 and q8.scale.shape == (1, 1, 4, 1)


def test_from_jax_state_dict_rejects_mismatches(models):
    jm, _ = models
    sd = _sd(jm)
    tm = GptModel(**CFG, device="cpu")
    before = tm.tok_emb.weight.detach().clone()
    missing = dict(sd)
    del missing["blocks.1.fc2.bias"]
    with pytest.raises(KeyError, match="blocks.1.fc2.bias"):
        from_jax_state_dict(tm, missing)
    extra = {**sd, "blocks.0.attn.in_proj_bias": np.zeros(3 * E, np.float32)}
    with pytest.raises(KeyError, match="in_proj_bias"):
        from_jax_state_dict(tm, extra)
    bad = {**sd, "ln_f.weight": np.ones(E + 1, np.float32)}
    with pytest.raises(ValueError, match="ln_f.weight"):
        from_jax_state_dict(tm, bad)
    # the refused calls copied nothing
    assert torch.equal(tm.tok_emb.weight.detach(), before)
    bf16 = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in sd.items()}
    from_jax_state_dict(tm, bf16)
    np.testing.assert_array_equal(
        tm.tok_emb.weight.detach().numpy(),
        np.asarray(jnp.asarray(sd["tok_emb.weight"], jnp.bfloat16)
                   .astype(jnp.float32)))


def test_backward_is_not_ported_yet(models):
    """The backward, attention dropout included.  A model at the default
    ``attn_dropout`` of 0.1 trains: its masks (the flash kernels' hash mask
    among them) come from the generator, so the same generator state gives
    the same logits and gradients.  Without dropout the backward (the
    LayerNorm and flash-attention backward kernels' plain versions on the
    CPU) gives the JAX package's gradients."""
    jm, tm = models
    ids = _ids(12, 2, 6)
    labels = _ids(13, 1, 12)[0]
    drop = GptModel(**{**CFG, "attn_dropout": 0.1}, device="cpu").train()
    assert drop.blocks[0].attn.dropout == 0.1
    runs = []
    with value_products():      # the runs' products alike
        for seed in (7, 7, 8):
            drop.zero_grad()
            logits = drop(torch.from_numpy(ids),
                          generator=torch.Generator().manual_seed(seed))
            torch.nn.functional.cross_entropy(
                logits.reshape(-1, V), torch.from_numpy(labels)).backward()
            runs.append((logits.detach(), drop.blocks[0].attn
                         .in_proj_weight.grad.clone()))
    assert torch.isfinite(runs[0][0]).all()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[2][0])
    jm.train()
    tm.train()
    try:
        with force_mode("interpret"):
            loss = jnn.CrossEntropyLoss()(
                jm(jnp.asarray(ids)).reshape((-1, V)), jnp.asarray(labels))
            loss.backward()
        tm.zero_grad()
        logits = tm(torch.from_numpy(ids))
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, V), torch.from_numpy(labels)).backward()
    finally:
        jm.eval()
        tm.eval()
    for (name, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert jax.devices()[0].platform == "cpu"
