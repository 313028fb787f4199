"""The port's BERT (``apex_tpu_torch.models.bert``) against the JAX
package's, on a tiny model (2 layers, width 64, 4 heads, vocabulary 128,
sequence 16) whose weights are carried across by ``from_jax_state_dict``.

At dropout 0: the MLM logits with a padding ``attention_mask`` and
``token_type_ids``, the gathered head over ``mlm_positions`` against the
full head, the loss and every gradient (the JAX side under ``jax.grad``
with its Pallas kernels in interpret mode, the port under autograd with
its kernels' plain versions), and three fused train steps with
``FusedLAMB`` in bf16 half copies.  At the original recipe's attention
dropout of 0.1, training runs and is reproducible from the generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss as jax_xent
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.models import BertForMaskedLM as JaxBert
from apex_tpu.nn.modules import Ctx
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.models import BertForMaskedLM, bert_base, \
    from_jax_state_dict
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.training import make_train_step
from torch_products import value_products

torch.set_num_threads(2)

V, E, L, HEADS, I, S, B, P = 128, 64, 2, 4, 128, 16, 2, 4
CFG = dict(vocab_size=V, hidden=E, layers=L, heads=HEADS, intermediate=I,
           max_positions=S, dropout=0.0, attn_dropout=0.0)


@pytest.fixture(scope="module")
def pair():
    jnn.manual_seed(3)
    jm = JaxBert(**CFG)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(BertForMaskedLM(**CFG, device="cpu"), sd)


def _batch(seed=0, b=B):
    r = np.random.default_rng(seed)
    ids = r.integers(0, V, (b, S))
    types = r.integers(0, 2, (b, S))
    mask = np.ones((b, S), np.int32)
    mask[1, 11:] = 0                   # the second sequence is padded
    pos = np.sort(np.stack([r.choice(11, P, replace=False)
                            for _ in range(b)]), axis=1)
    labels = r.integers(0, V, (b, P))
    return ids, types, mask, pos, labels


def test_logits_loss_and_gradients_match_jax(pair):
    jm, tm = pair
    ids, types, mask, pos, labels = _batch()
    params = list(jm.parameters())
    names = [n for n, _ in jm.named_parameters()]

    def jfwd(vals, positions=None):
        ctx = Ctx(env={id(p): v for p, v in zip(params, vals)},
                  stats_out={}, training=False)
        return jm.forward(ctx, jnp.asarray(ids), jnp.asarray(types),
                          jnp.asarray(mask), positions)

    def jloss(vals):
        logits = jfwd(vals, jnp.asarray(pos))
        return jnp.mean(jax_xent(logits.reshape((-1, V)),
                                 jnp.asarray(labels).reshape((-1,)), 0.0, -1,
                                 True))
    with force_mode("interpret"):
        vals = [p.data for p in params]
        full, (loss, grads) = jax.jit(lambda v: (
            jfwd(v), jax.value_and_grad(jloss)(v)))(vals)

    t = [torch.from_numpy(a) for a in (ids, types, mask, pos, labels)]
    tfull = tm(t[0], t[1], t[2])
    assert tfull.shape == (B, S, V)
    np.testing.assert_allclose(tfull.detach().numpy(), np.asarray(full),
                               rtol=1e-5, atol=1e-5)
    # the gathered head equals the full head gathered, and arrives either
    # as a keyword or inside the (ids, positions) model input
    with value_products():      # the two forwards' products alike
        gathered = tm((t[0], t[3]), t[1], t[2])
        again = tm(t[0], t[1], t[2], mlm_positions=t[3])
    assert torch.equal(gathered, again)
    want = torch.gather(tfull, 1, t[3][..., None].expand(-1, -1, V))
    np.testing.assert_allclose(gathered.detach().numpy(),
                               want.detach().numpy(), rtol=1e-5, atol=1e-6)
    tloss = softmax_cross_entropy_loss(gathered.reshape(-1, V),
                                       t[4].reshape(-1), 0.0, -1,
                                       True).mean()
    tm.zero_grad()
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss),
                               rtol=1e-5)
    tp = dict(tm.named_parameters())
    assert set(tp) == set(names)
    for n, g in zip(names, grads):
        g = np.asarray(g)
        err = np.abs(tp[n].grad.numpy() - g).max() / max(1.0, np.abs(g).max())
        assert err <= 1e-5, (n, err)
    # the padded keys change nothing at the real positions of sequence 2
    ids2 = ids.copy()
    ids2[1, 11:] = (ids2[1, 11:] + 7) % V
    other = tm(torch.from_numpy(ids2), t[1], t[2])
    np.testing.assert_allclose(other[1, :11].detach().numpy(),
                               tfull[1, :11].detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def _jax_mlm_loss(logits, labels):
    return jnp.mean(jax_xent(logits.reshape((-1, V)), labels.reshape((-1,)),
                             0.0, -1, True))


def _torch_mlm_loss(logits, labels):
    return softmax_cross_entropy_loss(logits.reshape(-1, V),
                                      labels.reshape(-1), 0.0, -1,
                                      True).mean()


def test_fused_lamb_train_steps_match_jax(pair):
    """The bench's BERT step in miniature: gathered MLM positions in the
    model input, bf16 half copies, static scale 1, FusedLAMB."""
    jm, _ = pair
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(BertForMaskedLM(**CFG, device="cpu"), sd)
    kw = dict(lr=1e-2, weight_decay=0.01)
    jstep = jax_make_train_step(jm, JaxFusedLAMB(list(jm.parameters()), **kw),
                                _jax_mlm_loss, half_dtype=jnp.bfloat16,
                                loss_scale=1.0)
    tstep = make_train_step(tm, FusedLAMB(list(tm.parameters()), **kw),
                            _torch_mlm_loss, half_dtype=torch.bfloat16,
                            loss_scale=1.0)
    ids, _, _, pos, labels = _batch(1)
    with force_mode("interpret"):
        want = [float(jstep((jnp.asarray(ids), jnp.asarray(pos)),
                            jnp.asarray(labels))) for _ in range(3)]
    got = [float(tstep((torch.from_numpy(ids), torch.from_numpy(pos)),
                       torch.from_numpy(labels))) for _ in range(3)]
    # bf16 activations, rounded at other places by the two frameworks
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0]
    names = [n for n, _ in tm.named_parameters()]
    jw = dict(zip([n for n, _ in jm.named_parameters()],
                  jstep.state.master_params))
    # LAMB's update is Adam's direction times a trust ratio, and a tensor of
    # zeros (LayerNorm biases, decoder_bias) takes the ratio lr: each of its
    # elements moves by about lr a step whatever the size of its gradient,
    # so a near-zero bf16 gradient whose sign differs between the two sides
    # parts them by up to 2 lr a step (6 lr over 3 steps bounds every
    # element); 99% of the elements agree within 2e-3
    diff = np.concatenate([np.abs(t.numpy() - np.asarray(jw[n])).ravel()
                           for n, t in zip(names, tstep.state.master_params)])
    assert diff.max() <= 6 * kw["lr"], diff.max()
    assert (diff <= 2e-3).mean() >= 0.99, (diff > 2e-3).sum()


def test_attention_dropout_training_is_reproducible():
    """The original recipe (attention, residual and embedding dropout 0.1)
    trains; the masks come from the generator alone."""
    torch.manual_seed(4)
    m = BertForMaskedLM(**{**CFG, "dropout": 0.1, "attn_dropout": 0.1},
                        device="cpu").train()
    ids, types, mask, pos, labels = (torch.from_numpy(a)
                                     for a in _batch(2))
    losses = []
    with value_products():      # the runs' products alike
        for seed in (9, 9, 10):
            m.zero_grad()
            out = m(ids, types, mask, mlm_positions=pos,
                    generator=torch.Generator().manual_seed(seed))
            loss = _torch_mlm_loss(out, labels)
            loss.backward()
            losses.append((float(loss.detach()),
                           m.bert.layers[0].attn.in_proj_weight
                           .grad.clone()))
    assert np.isfinite(losses[0][0])
    assert losses[0][0] == losses[1][0]
    assert torch.equal(losses[0][1], losses[1][1])
    assert losses[0][0] != losses[2][0]


def test_bert_base_shape_and_defaults():
    m = bert_base(max_positions=32, layers=1, device="cpu")
    assert m.bert.layers[0].attn.dropout == 0.1       # the original recipe
    assert m.bert.tok_emb.weight.shape == (30522, 768)
    assert abs(m.bert.tok_emb.weight.std().item() - 0.02) < 1e-3
    with pytest.raises(ValueError, match="max_positions"):
        m(torch.zeros((1, 33), dtype=torch.long))
