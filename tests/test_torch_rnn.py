"""The port's ``RNN`` (cells, ``RNNCell``, ``stackedRNN``,
``bidirectionalRNN`` and the factories) against the JAX package's, the
weights carried across by ``from_jax_state_dict``.

For the factories (LSTM, GRU, ReLU, mLSTM; Tanh differs from ReLU only in
its cell function, checked alone), stacked, bidirectional, without biases
and with the ``w_ho`` projection: the output, the final states and the
gradients of the weights and the input (``jax.grad`` of the pure forward
against autograd, fp32 within 1e-5 of the largest value).  The stored
state carried into the next call and reset, ``collect_hidden``, one cell
step, and every cell function alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.RNN as JRNN
import apex_tpu.nn as jnn
from apex_tpu.nn.modules import Ctx

from apex_tpu_torch import RNN
from apex_tpu_torch.models import from_jax_state_dict

torch.set_num_threads(2)

T, B, I, H = 5, 3, 4, 6
CASES = {  # name: (factory, args, keywords)
    "lstm2": ("LSTM", (I, H, 2), {}),
    "gru2": ("GRU", (I, H, 2), {}),
    "relu_nobias": ("ReLU", (I, H, 1), dict(bias=False)),
    "lstm_bidirectional": ("LSTM", (I, H, 2), dict(bidirectional=True)),
    "mlstm_bidirectional_projected": ("mLSTM", (I, H, 1),
                                      dict(bidirectional=True,
                                           output_size=5)),
}


def _pair(name):
    factory, args, kw = CASES[name]
    jnn.manual_seed(6)
    jm = getattr(JRNN, factory)(*args, **kw)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = getattr(RNN, factory)(*args, **kw, device="cpu")
    return jm, from_jax_state_dict(tm, sd)


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (T, B, I)).astype(np.float32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    err = np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err


def _loss(out, hiddens, sin, total):
    return total(sin(out)) + sum(total(sin(2 * h)) for h in hiddens)


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_final_states_and_gradients_match_jax(name):
    jm, tm = _pair(name)
    x = _x()
    params = list(jm.parameters())
    names = [n for n, _ in jm.named_parameters()]

    def jloss(vals, xj):
        ctx = Ctx(env={id(p): v for p, v in zip(params, vals)},
                  stats_out={}, training=True)
        out, hid = jm.forward(ctx, xj)
        return _loss(out, hid, jnp.sin, jnp.sum), (out, hid)
    (_, (jout, jhid)), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))([p.data for p in params],
                                              jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, hid = tm(tx)
    _close(out.detach().numpy(), jout)
    assert len(hid) == len(jhid)
    for h, jh in zip(hid, jhid):
        _close(h.detach().numpy(), jh)
    _loss(out, hid, torch.sin, torch.sum).backward()
    tp = dict(tm.named_parameters())
    assert set(tp) == set(names)
    for n, w in zip(names, jgrads):
        _close(tp[n].grad.numpy(), w)
    _close(tx.grad.numpy(), jdx)


@pytest.mark.parametrize("name", ["lstm2", "mlstm_bidirectional_projected"])
def test_state_is_carried_into_the_next_call_and_reset(name):
    """Each call starts from the stored (detached) final states of the
    last; ``reset_hidden`` starts over, ``detach_hidden`` keeps them."""
    jm, tm = _pair(name)
    xs = [_x(1), _x(2)]
    want = []
    for xi in xs:
        out, _ = jm.forward(Ctx(env={}, training=False), jnp.asarray(xi))
        want.append(np.asarray(out))
    got = [tm(torch.from_numpy(xi))[0] for xi in xs]
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)
    cells = list(tm.modules())
    stored = [c for c in cells if isinstance(c, RNN.RNNCell)]
    assert all(not h.requires_grad for c in stored for h in c.hidden)
    tm.detach_hidden()
    tm.reset_hidden(B)
    again = tm(torch.from_numpy(xs[0]))[0]
    _close(again.detach().numpy(), want[0])
    assert not np.allclose(again.detach().numpy(), want[1])
    with pytest.raises(RuntimeError, match="initialize hidden"):
        RNN.LSTM(I, H, 1, device="cpu").detach_hidden()


@pytest.mark.parametrize("name", ["gru2", "lstm_bidirectional"])
def test_collect_hidden_matches_jax(name):
    jm, tm = _pair(name)
    x = _x(3)
    _, jhid = jm.forward(Ctx(env={}, stats_out={}, training=False),
                         jnp.asarray(x), collect_hidden=True)
    with torch.no_grad():
        _, hid = tm(torch.from_numpy(x), collect_hidden=True)
    assert len(hid) == len(jhid)
    for steps, jsteps in zip(hid, jhid):
        assert len(steps) == len(jsteps) == T
        for h, jh in zip(steps, jsteps):
            _close(h.numpy(), jh)


def test_one_cell_step_and_the_cell_functions_match_jax():
    jnn.manual_seed(9)
    jc = JRNN.RNNCell(4, I, H, JRNN.cells.lstm_cell, 2, True, 5)
    sd = {k: np.asarray(v) for k, v in jc.state_dict().items()}
    tc = from_jax_state_dict(RNN.RNNCell(4, I, H, RNN.cells.lstm_cell, 2,
                                         True, 5, device="cpu"), sd)
    x = _x(4)[0]
    want = jc.forward(Ctx(env={}, training=False), jnp.asarray(x))
    got = tc(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)
    assert [tuple(h.shape) for h in tc.hidden] == [(B, 5), (B, H)]
    r = np.random.default_rng(5)
    w = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    h = (w(B, H), w(B, H))
    for fn, gates, args in (("gru_cell", 3, ()), ("rnn_relu_cell", 1, ()),
                            ("rnn_tanh_cell", 1, ()),
                            ("mlstm_cell", 4, (w(H, I), w(H, H)))):
        hid = h[:1] if gates != 4 else h
        ws = (w(gates * H, I), w(gates * H, H)) + args
        want = getattr(JRNN.cells, fn)(jnp.asarray(x),
                                       tuple(map(jnp.asarray, hid)),
                                       *map(jnp.asarray, ws))
        got = getattr(RNN.cells, fn)(torch.from_numpy(x),
                                     tuple(map(torch.from_numpy, hid)),
                                     *map(torch.from_numpy, ws))
        for g, wv in zip(got, want):
            _close(g.numpy(), wv)
