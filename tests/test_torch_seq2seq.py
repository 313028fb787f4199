"""The port's transformer encoder-decoder (``models.seq2seq``) against the
JAX package's, on a tiny model (2 + 2 layers, width 32, 4 heads,
vocabulary 89) whose weights are carried across by
``from_jax_state_dict``.

At dropout 0: the logits (plain and packed input, with a padded source),
``output_hidden``, and every gradient of a loss over the logits (the JAX
side under ``jax.grad`` with its Pallas kernels in interpret mode, the
port under autograd with its kernels' plain versions; fp32 within 1e-4;
the JAX side takes its Pallas kernels' plain references on the CPU, as
the JAX package's own seq2seq tests do, since the kernels themselves are
held against the Pallas kernels in interpret mode elsewhere);
the decoder's causality and the source padding's reach, as the JAX tests
pin them; three bf16 ``make_train_step`` steps with the bench's chunked
loss against the JAX step's losses (2e-2, the frameworks round bf16
activations at different places); ``seq2seq_generate``'s greedy tokens
equal to JAX's; the sampling surface's errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.contrib.xentropy import \
    chunked_lm_head_loss as jax_chunked_loss
from apex_tpu.models import TransformerSeq2Seq as JaxSeq2Seq
from apex_tpu.models import seq2seq_generate as jax_generate
from apex_tpu.nn.modules import Ctx
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.contrib.xentropy import chunked_lm_head_loss
from apex_tpu_torch.models import (TransformerSeq2Seq, from_jax_state_dict,
                                   seq2seq_generate, transformer_seq2seq)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step

torch.set_num_threads(2)

V, H, HEADS = 89, 32, 4
CFG = dict(vocab_size=V, hidden=H, enc_layers=2, dec_layers=2, heads=HEADS,
           intermediate=64, max_positions=32, dropout=0.0, attn_dropout=0.0)
B, S_SRC, S_TGT = 2, 12, 9


def _pair(**kw):
    cfg = {**CFG, **kw}
    jnn.manual_seed(4)
    jm = JaxSeq2Seq(**cfg)
    jm.eval()
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(TransformerSeq2Seq(**cfg, device="cpu"), sd)
    return jm, tm.eval()


def _data(seed=0):
    r = np.random.default_rng(seed)
    src = r.integers(1, V, (B, S_SRC))
    tgt = r.integers(1, V, (B, S_TGT))
    mask = np.ones((B, S_SRC), np.int32)
    mask[1, 8:] = 0                     # the second source is padded
    return src, tgt, mask


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err


def test_logits_and_gradients_match_jax():
    jm, tm = _pair()
    src, tgt, mask = _data()
    g = np.random.default_rng(1).normal(size=(B, S_TGT, V)) \
        .astype(np.float32)
    params = list(jm.parameters())
    names = [n for n, _ in jm.named_parameters()]

    def jloss(vals):
        ctx = Ctx(env={id(p): v for p, v in zip(params, vals)},
                  stats_out={}, training=False)
        logits = jm.forward(ctx, jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(mask))
        return jnp.sum(logits * jnp.asarray(g)), logits
    def junmasked():
        return jm.forward(Ctx(env={}, training=False), jnp.asarray(src),
                          jnp.asarray(tgt))
    ((_, jlogits), jgrads), jplain = jax.jit(lambda v: (
        jax.value_and_grad(jloss, has_aux=True)(v), junmasked()))(
            [p.data for p in params])
    t = [torch.from_numpy(a) for a in (src, tgt, mask)]
    logits = tm(*t)
    assert logits.shape == (B, S_TGT, V)
    _close(logits.detach().numpy(), jlogits)
    (logits * torch.from_numpy(g)).sum().backward()
    tp = dict(tm.named_parameters())
    assert set(tp) == set(names)
    for n, w in zip(names, jgrads):
        _close(tp[n].grad.numpy(), w)
    # the packed form is the same call
    with torch.no_grad():
        assert torch.equal(tm((t[0], t[1], t[2])), tm(*t))
        unmasked = tm(t[0], t[1])
    with pytest.raises(TypeError, match="src_ids, tgt_ids"):
        tm(t[0])
    _close(unmasked.numpy(), jplain)


def test_output_hidden_returns_the_decoder_states_and_the_tied_table():
    jm, tm = _pair(output_hidden=True)
    src, tgt, mask = _data(2)
    jh, jtab = jax.jit(lambda: jm.forward(
        Ctx(env={}, training=False), jnp.asarray(src), jnp.asarray(tgt),
        jnp.asarray(mask)))()
    with torch.no_grad():
        th, ttab = tm(*(torch.from_numpy(a) for a in (src, tgt, mask)))
    assert th.shape == (B, S_TGT, H) and ttab is tm.tok_emb.weight
    _close(th.numpy(), jh)
    _close(ttab.detach().numpy(), jtab, 0.0)


def test_decoder_causality_and_source_padding():
    """Logits at target position i see no target token after i but do see
    the source; padded source positions reach nothing, through the
    encoder's self-attention and the decoder's cross-attention."""
    _, tm = _pair()
    src, tgt, mask = _data(3)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        out1 = tm(t(src), t(tgt))
        tgt2 = tgt.copy()
        tgt2[:, 6:] = (tgt2[:, 6:] + 7) % V
        out2 = tm(t(src), t(tgt2))
        np.testing.assert_allclose(out1[:, :6].numpy(), out2[:, :6].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert (out1[:, 6:] - out2[:, 6:]).abs().max() > 1e-3
        assert (tm(t((src + 11) % V), t(tgt)) - out1).abs().max() > 1e-3
        masked = tm(t(src), t(tgt), t(mask))
        src2 = src.copy()
        src2[1, 8:] = (src2[1, 8:] + 31) % V
        np.testing.assert_allclose(tm(t(src2), t(tgt), t(mask)).numpy(),
                                   masked.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds max_positions"):
        tm(t(np.zeros((1, 33), np.int64)), t(tgt))


def test_bf16_train_steps_with_the_chunked_loss_match_jax():
    """The bench's seq2seq step in miniature: copy-task pairs, the packed
    (src, tgt_in) model input, bf16 half copies, static scale 1,
    FusedAdam, the chunked loss over the decoder states and the tied
    table; one layer each, to keep the JAX step's compile short."""
    jm, tm = _pair(output_hidden=True, enc_layers=1, dec_layers=1)
    jm.train()
    tm.train()
    src = np.random.default_rng(5).integers(1, V, (4, 10))
    tgt_in = np.concatenate([np.zeros((4, 1), src.dtype), src[:, :-1]], 1)

    def jloss(out, tgt_out):
        hidden, table = out
        return jnp.mean(jax_chunked_loss(hidden, table, tgt_out,
                                         padding_idx=-1))

    def tloss(out, tgt_out):
        hidden, table = out
        return chunked_lm_head_loss(hidden, table, tgt_out,
                                    padding_idx=-1).mean()
    jstep = jax_make_train_step(jm, JaxFusedAdam(list(jm.parameters()),
                                                 lr=3e-3),
                                jloss, half_dtype=jnp.bfloat16,
                                loss_scale=1.0)
    tstep = make_train_step(tm, FusedAdam(list(tm.parameters()), lr=3e-3),
                            tloss, half_dtype=torch.bfloat16, loss_scale=1.0)
    want = [float(jstep((jnp.asarray(src), jnp.asarray(tgt_in)),
                        jnp.asarray(src))) for _ in range(3)]
    got = [float(tstep((torch.from_numpy(src), torch.from_numpy(tgt_in)),
                       torch.from_numpy(src))) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0]


def test_greedy_generate_equals_jax():
    jm, tm = _pair()
    src, _, mask = _data(6)
    for m in (None, mask):
        want = np.asarray(jax_generate(
            jm, jnp.asarray(src), 6, bos_id=0,
            src_attention_mask=None if m is None else jnp.asarray(m)))
        got = seq2seq_generate(tm, torch.from_numpy(src), 6, bos_id=0,
                               src_attention_mask=None if m is None
                               else torch.from_numpy(m))
        assert got.shape == (B, 6) and got.dtype == torch.long
        np.testing.assert_array_equal(got.numpy(), want)
    # the model's training flag is kept; dropout is off while it decodes
    tm.train()
    again = seq2seq_generate(tm, torch.from_numpy(src), 6,
                             src_attention_mask=torch.from_numpy(mask))
    assert tm.training
    np.testing.assert_array_equal(again.numpy(), want)


def test_generate_sampling_surface():
    _, tm = _pair()
    src = torch.from_numpy(_data(7)[0])
    s1 = seq2seq_generate(tm, src, 5, temperature=1.0,
                          generator=torch.Generator().manual_seed(1))
    s2 = seq2seq_generate(tm, src, 5, temperature=1.0,
                          generator=torch.Generator().manual_seed(2))
    assert (s1 != s2).any() and 0 <= int(s1.min()) and int(s1.max()) < V
    s3 = seq2seq_generate(tm, src, 5, temperature=0.8, top_k=7,
                          generator=torch.Generator().manual_seed(1))
    assert s3.shape == (B, 5)
    with pytest.raises(ValueError, match="temperature"):
        seq2seq_generate(tm, src, 2, temperature=-0.5)
    with pytest.raises(ValueError, match="top_k"):
        seq2seq_generate(tm, src, 2, temperature=1.0, top_k=0,
                         generator=torch.Generator())
    with pytest.raises(ValueError, match="torch.Generator"):
        seq2seq_generate(tm, src, 2, temperature=0.5)
    with pytest.raises(ValueError, match="max_positions"):
        seq2seq_generate(tm, src, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        seq2seq_generate(tm, src, 2, mesh="a mesh")


def test_base_geometry_and_refusals():
    m = transformer_seq2seq(vocab_size=64, max_positions=8, device="cpu")
    assert (m.hidden, len(m.enc_layers), len(m.dec_layers)) == (512, 6, 6)
    assert m.dec_layers[0].self_attn.num_heads == 8
    assert m.dec_layers[0].fc1.weight.shape == (2048, 512)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        TransformerSeq2Seq(**CFG, tp_axis="model", device="cpu")
