"""The port's Llama family (apex_tpu_torch.models.llama) against the JAX
package's, on tiny models whose weights are carried across by
``from_jax_state_dict``.

The JAX side runs its Pallas kernels in interpret mode where the path
reaches them (flash attention, RMSNorm, the fused LM-head loss); the port
runs on CPU tensors, so its kernel wrappers take their plain versions.
Tolerances: logits 1e-4 (fp32, sums in another order), greedy tokens
exact, train-step losses 1e-5 in fp32 and 2e-2 in bf16 (the two frameworks
round bf16 activations at different places), as the GPT tests hold them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.models import LlamaModel as JaxLlama
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.models import llama as jax_llama
from apex_tpu.nn.modules import Ctx
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.kernels import counts, reset_counts
from apex_tpu_torch.models import (LlamaModel, apply_rope,
                                   from_jax_state_dict, generate, llama_tiny,
                                   rope_tables, to_numpy_state_dict)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step

torch.set_num_threads(2)

V, E, L, HEADS, MAXPOS = 131, 64, 2, 4, 32
CFG = dict(vocab_size=V, hidden=E, layers=L, heads=HEADS, intermediate=96,
           max_positions=MAXPOS)


def _sd(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def _pair(seed=5, **kw):
    """A JAX Llama from a seed and the port's copy of it (CPU)."""
    cfg = {**CFG, **kw}
    jnn.manual_seed(seed)
    jm = JaxLlama(**cfg)
    jm.eval()
    tm = LlamaModel(**cfg, device="cpu").eval()
    return jm, from_jax_state_dict(tm, _sd(jm))


def _ids(seed, b, s, v=V):
    return np.random.default_rng(seed).integers(0, v, (b, s))


def _ctx():
    return Ctx(env={}, training=False)


def test_parameter_names_and_shapes_are_the_jax_models():
    jnn.manual_seed(0)
    jm = JaxLlama(**CFG, kv_heads=2)
    tm = LlamaModel(**CFG, kv_heads=2, device="cpu")
    want = {k: tuple(np.shape(v)) for k, v in jm.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert "blocks.1.q_proj.weight" in got and "lm_head.weight" in got
    # the weights carry over unchanged, and back
    sd = _sd(jm)
    back = to_numpy_state_dict(from_jax_state_dict(tm, sd))
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])


def test_rope_tables_and_apply_rope_match_jax():
    pos = np.array([0, 1, 5, 17, 31])
    for d, theta in ((16, 10000.0), (64, 500000.0)):
        jc, js = jax_llama.rope_tables(jnp.asarray(pos), d, theta)
        tc, ts = rope_tables(torch.from_numpy(pos), d, theta)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-6)
        x = np.random.default_rng(d).normal(size=(2, 3, 5, d)) \
            .astype(np.float32)
        want = jax_llama.apply_rope(jnp.asarray(x), jc, js)
        got = apply_rope(torch.from_numpy(x), tc, ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        # bf16 in, bf16 out, the rotation in fp32
        xb = torch.from_numpy(x).bfloat16()
        got_b = apply_rope(xb, tc, ts)
        assert got_b.dtype == torch.bfloat16
        want_b = jax_llama.apply_rope(jnp.asarray(x, jnp.bfloat16), jc, js)
        np.testing.assert_allclose(got_b.float().numpy(),
                                   np.asarray(want_b, np.float32),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_gqa_repeats_each_kv_head_over_its_group(kv_heads):
    """Query head h reads K/V head h // (H / KVH), as ``jnp.repeat``
    does.  A model whose K/V heads differ greatly shows the wrong grouping
    (``Tensor.repeat`` tiles them instead); so does the expanded-MHA
    copy of the same weights, which must give the same logits."""
    jm, tm = _pair(seed=9, kv_heads=kv_heads)
    sd = _sd(jm)
    d = E // HEADS
    rep = HEADS // kv_heads
    r = np.random.default_rng(3)
    for i in range(L):
        for proj in ("k_proj", "v_proj"):
            w = sd[f"blocks.{i}.{proj}.weight"]
            # each K/V head gets a scale of its own
            scale = np.repeat(1.0 + 3.0 * np.arange(kv_heads), d)[:, None]
            sd[f"blocks.{i}.{proj}.weight"] = (w * scale).astype(np.float32)
    jm.load_state_dict(sd)
    from_jax_state_dict(tm, sd)
    mha = {k: v for k, v in sd.items()}
    for i in range(L):
        for proj in ("k_proj", "v_proj"):
            w = sd[f"blocks.{i}.{proj}.weight"].reshape(kv_heads, d, E)
            mha[f"blocks.{i}.{proj}.weight"] = np.repeat(
                w, rep, axis=0).reshape(HEADS * d, E)
    tm_mha = from_jax_state_dict(
        LlamaModel(**CFG, kv_heads=HEADS, device="cpu").eval(), mha)
    ids = torch.from_numpy(_ids(r.integers(1 << 30), 2, 12))
    with force_mode("interpret"):
        want = np.asarray(jm.forward(_ctx(), jnp.asarray(ids.numpy())))
    with torch.no_grad():
        got = tm(ids).numpy()
        got_mha = tm_mha(ids).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_mha, got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_heads,window", [(HEADS, None), (2, None),
                                             (1, None), (2, 5)])
def test_forward_logits_match_jax(kv_heads, window):
    jm, tm = _pair(seed=11, kv_heads=kv_heads, sliding_window=window)
    ids = _ids(1, 2, 20)
    with force_mode("interpret"):
        want = np.asarray(jm.forward(_ctx(), jnp.asarray(ids)))
    reset_counts()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # CPU tensors launch no kernel
    assert not any(counts().values())


def test_output_hidden_returns_hidden_and_untied_head():
    jm, tm = _pair(seed=12, kv_heads=2, output_hidden=True)
    ids = _ids(2, 2, 9)
    with force_mode("interpret"):
        jh, jw = jm.forward(_ctx(), jnp.asarray(ids))
    with torch.no_grad():
        th, tw = tm(torch.from_numpy(ids))
    assert tw is tm.lm_head.weight
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tw.detach().numpy(), np.asarray(jw))


def test_prefill_decode_chunk_and_decode_steps_match_jax():
    jm, tm = _pair(seed=13, kv_heads=2)
    ids = _ids(3, 2, 8)
    chunk = _ids(4, 2, 3)
    nxt = _ids(5, 2, 3)
    ctx = _ctx()
    with force_mode("interpret"):
        lj, cj = jm.prefill(ctx, jnp.asarray(ids), jm.init_caches(2, 16))
        want = [np.asarray(lj)]
        lj, cj = jm.decode_chunk(ctx, jnp.asarray(chunk), cj, 8)
        want.append(np.asarray(lj))
        for i in range(3):
            lj, cj = jm.decode_step(ctx, jnp.asarray(nxt[:, i]), cj,
                                    jnp.asarray(11 + i))
            want.append(np.asarray(lj))
    with torch.inference_mode():
        caches = tm.init_caches(2, 16)
        # the caches are KVH wide
        assert tuple(caches[0][0].shape) == (2, 2, 16, E // HEADS)
        lt, ct = tm.prefill(torch.from_numpy(ids), caches)
        got = [lt.numpy()]
        lt, ct = tm.decode_chunk(torch.from_numpy(chunk), ct, 8)
        got.append(lt.numpy())
        for i in range(3):
            lt, ct = tm.decode_step(torch.from_numpy(nxt[:, i]), ct, 11 + i)
            got.append(lt.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ct[1][0].numpy()[:, :, :14],
                               np.asarray(cj[1][0])[:, :, :14],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", [6, 1])
def test_greedy_generate_equals_jax(p):
    jm, tm = _pair(seed=14, kv_heads=2)
    prompt = _ids(6, 3, p)
    with force_mode("interpret"):
        want = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 9))
    got = generate(tm, torch.from_numpy(prompt), 9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_samples_within_the_vocabulary():
    _, tm = _pair(seed=15, kv_heads=1)
    g = torch.Generator().manual_seed(0)
    out = generate(tm, torch.from_numpy(_ids(7, 2, 4)), 6, temperature=1.0,
                   top_k=20, top_p=0.9, generator=g)
    assert out.shape == (2, 10)
    assert 0 <= int(out.min()) and int(out.max()) < V


def test_llama_tiny_and_ffn_default_match_jax():
    jnn.manual_seed(0)
    jm = jax_llama.llama_tiny()
    tm = llama_tiny(device="cpu")
    assert {k: tuple(np.shape(v)) for k, v in jm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    # 2/3 * 4E rounded up to 256
    m = LlamaModel(vocab_size=16, hidden=96, layers=1, heads=2,
                   device="cpu")
    assert m.blocks[0].gate_proj.weight.shape == (256, 96)


def test_unported_options_raise():
    small = dict(vocab_size=16, hidden=16, layers=1, heads=2,
                 max_positions=8, device="cpu")
    for kw, what in ((dict(tp_axis="model"), "tensor and sequence"),
                     (dict(sp_axis="seq"), "tensor and sequence"),
                     (dict(moe_axis="data"), "mixture of experts")):
        with pytest.raises(NotImplementedError, match=what):
            LlamaModel(**small, **kw)
    assert LlamaModel(**small, remat=True).remat     # ported: it builds
    banded = LlamaModel(**small, sliding_window=4)
    ids = torch.zeros((1, 3), dtype=torch.long)
    with torch.no_grad():
        assert banded(ids).shape == (1, 3, 16)   # the forward takes the band
    # cached decode with the band is ported: rolling caches of window +
    # ROLLING_SLACK slots at most (here the 8 asked for)
    assert banded.init_caches(1, 8)[0][0].shape == (1, 2, 8, 8)
    caches = banded.init_caches(1, 8)
    with torch.no_grad():
        assert banded.prefill(ids, caches)[0].shape == (1, 3, 16)
        assert banded.decode_chunk(ids[:, :2], caches, 3)[0].shape == \
            (1, 2, 16)
        assert banded.decode_step(ids[:, 0], caches, 5)[0].shape == (1, 16)
    assert generate(banded, ids, 2).shape == (1, 5)
    caches = LlamaModel(**small).init_caches(1, 8)
    with pytest.raises(ValueError, match="sliding_window"):
        LlamaModel(**small, sliding_window=0)
    with pytest.raises(ValueError, match="positions"):
        LlamaModel(**small).decode_step(ids[:, 0], caches, 8)


# -- training: the bench's Llama step in both of its loss modes -------------

TV, TS, TB = 301, 12, 2
TCFG = dict(vocab_size=TV, hidden=E, layers=L, heads=HEADS, kv_heads=2,
            intermediate=96, max_positions=TS, output_hidden=True)
LR, WD = 1e-3, 0.1


def _loss_fns(mode):
    """The JAX bench's ``_lm_head_loss(mode)`` (bench.py) and the port's."""
    if mode == "chunked":
        from apex_tpu.contrib.xentropy import make_chunked_lm_loss as jmcl
        from apex_tpu_torch.contrib.xentropy import make_chunked_lm_loss
        return (jmcl(vocab_size=TV, padding_idx=-1, chunk_rows=8),
                make_chunked_lm_loss(vocab_size=TV, padding_idx=-1,
                                     chunk_rows=8))
    from apex_tpu.ops.pallas.lm_head_xent import fused_lm_head_xent as jfx
    from apex_tpu_torch.kernels.lm_head_xent import fused_lm_head_xent

    def jax_loss(out, ids):
        hidden, table = out
        flat = hidden[:, :-1].reshape((-1, hidden.shape[-1]))
        return jnp.mean(jfx(flat, table, ids[:, 1:].reshape((-1,))))

    def port_loss(out, ids):
        hidden, table = out
        flat = hidden[:, :-1].reshape(-1, hidden.shape[-1])
        return fused_lm_head_xent(flat, table, ids[:, 1:].reshape(-1)).mean()
    return jax_loss, port_loss


@pytest.mark.parametrize("half", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["chunked", "kernel"])
def test_train_steps_match_jax(mode, half):
    jnn.manual_seed(21)
    jm = JaxLlama(**TCFG)
    tm = from_jax_state_dict(LlamaModel(**TCFG, device="cpu"), _sd(jm))
    jloss, tloss = _loss_fns(mode)
    hd = half == "bfloat16"
    jstep = jax_make_train_step(
        jm, JaxFusedAdam(list(jm.parameters()), lr=LR, weight_decay=WD),
        jloss, half_dtype=jnp.bfloat16 if hd else None, loss_scale=1.0)
    tstep = make_train_step(
        tm, FusedAdam(list(tm.parameters()), lr=LR, weight_decay=WD),
        tloss, half_dtype=torch.bfloat16 if hd else None, loss_scale=1.0)
    ids = _ids(22, TB, TS, TV)
    with force_mode("interpret"):
        want = [float(jstep(jnp.asarray(ids), jnp.asarray(ids)))
                for _ in range(4)]
    got = [float(tstep(torch.from_numpy(ids), torch.from_numpy(ids)))
           for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=2e-2 if hd else 1e-5)
    assert got[-1] < got[0]
    assert int(tstep.state.step) == 4
    if not hd:
        # Adam moves an element by about lr a step whatever its gradient,
        # so a near-zero gradient of the other sign may part the masters
        # by up to 2 lr a step; nearly all agree to fp32 rounding
        named = list(tm.named_parameters())
        tw = [m.numpy() for m in tstep.state.master_params]
        jw = [np.asarray(m) for m in jstep.state.master_params]
        assert len(tw) == len(jw) == len(named)
        diff = np.concatenate([np.abs(a - b).ravel()
                               for a, b in zip(tw, jw)])
        assert diff.max() <= 8 * LR
        assert (diff <= 1e-5).mean() >= 0.999


def test_loss_modes_agree_on_the_first_step():
    """The chunked and the kernel loss are the same function: equal losses
    and gradients on one model and batch (fp32)."""
    jnn.manual_seed(23)
    jm = JaxLlama(**TCFG)
    sd = _sd(jm)
    ids = torch.from_numpy(_ids(24, TB, TS, TV))
    grads = {}
    for mode in ("chunked", "kernel"):
        tm = from_jax_state_dict(LlamaModel(**TCFG, device="cpu"), sd)
        loss = _loss_fns(mode)[1](tm(ids), ids)
        loss.backward()
        grads[mode] = (float(loss.detach()), {n: p.grad.clone()
                                     for n, p in tm.named_parameters()})
    (lc, gc), (lk, gk) = grads["chunked"], grads["kernel"]
    assert abs(lc - lk) <= 1e-5 * abs(lc)
    for n in gc:
        np.testing.assert_allclose(gk[n].numpy(), gc[n].numpy(), rtol=1e-4,
                                   atol=1e-6)
