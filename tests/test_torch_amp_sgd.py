"""amp with FusedSGD: the port's eager loop against the JAX package's.

``amp.initialize(opt_level="O2")`` (fp16, dynamic scale capped at 2^10)
over a tiny GPT whose weights are carried across by
``from_jax_state_dict``, ``FusedSGD(lr, momentum 0.9, weight decay)``, 3
iterations of forward, ``scale_loss``, backward and ``step`` with a
non-finite gradient planted at iteration 2, with ``materialize_master_grads``
True (the half gradients unscaled into fp32 master gradients) and False
(the half gradients kept scaled and the scale folded into the SGD kernel's
``scale``).  The skip and scale history must be equal; the fp16 model copy,
which FusedSGD's depth-4 launch writes, is the fp32 masters rounded to
fp16 on both sides; the masters and momenta agree within the fp16
forward's rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu import amp as jamp
from apex_tpu.amp._amp_state import reset as jax_reset
from apex_tpu.models import GptModel as JaxGpt
from apex_tpu.nn import functional as jax_F
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD

from apex_tpu_torch import amp
from apex_tpu_torch.amp._amp_state import _amp_state
from apex_tpu_torch.amp._amp_state import reset as port_reset
from apex_tpu_torch.models import GptModel, from_jax_state_dict
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedSGD

torch.set_num_threads(2)

V, E, L, HEADS, S, B = 211, 32, 2, 4, 8, 2
CFG = dict(vocab_size=V, hidden=E, layers=L, heads=HEADS, max_positions=S,
           dropout=0.0, attn_dropout=0.0)
HYPER = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)


class _JaxLmLoss(jnn.Module):
    def forward(self, ctx, logits, ids):
        flat = logits[:, :-1].reshape((-1, logits.shape[-1]))
        return jax_F.cross_entropy(flat, ids[:, 1:].reshape((-1,)))


def _port_loss(logits, ids):
    flat = logits[:, :-1].reshape(-1, logits.shape[-1])
    return F.cross_entropy(flat, ids[:, 1:].reshape(-1))


def _ids():
    return np.random.default_rng(4).integers(0, V, (B, S))


def _jax_loop(materialize):
    jnn.manual_seed(7)
    jm = JaxGpt(**CFG)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    jax_reset()
    opt = JaxFusedSGD(list(jm.parameters()), **HYPER,
                      materialize_master_grads=materialize)
    jm, opt = jamp.initialize(jm, opt, opt_level="O2", verbosity=0,
                              max_loss_scale=2.0 ** 10)
    crit, ids = _JaxLmLoss(), jnp.asarray(_ids())
    hist = []
    for i in range(3):
        loss = crit(jm(ids), ids)
        with jamp.scale_loss(loss, opt) as scaled:
            scaled.backward()
            if i == 1:
                p16 = opt._amp_stash.all_fp16_params[0]
                p16.grad = p16.grad.at[(0,) * p16.grad.ndim].set(np.inf)
        skipped = opt._amp_stash.already_patched
        opt.step()
        opt.zero_grad()
        hist.append((bool(skipped),
                     jamp._amp_state.loss_scalers[0].loss_scale(),
                     float(loss)))
    return sd, opt, hist


def _port_loop(sd, materialize):
    tm = from_jax_state_dict(GptModel(**CFG, device="cpu"), sd)
    port_reset()
    opt = FusedSGD(list(tm.parameters()), **HYPER,
                   materialize_master_grads=materialize)
    tm, opt = amp.initialize(tm, opt, opt_level="O2", verbosity=0,
                             max_loss_scale=2.0 ** 10)
    ids = torch.from_numpy(_ids())
    hist = []
    for i in range(3):
        loss = _port_loss(tm(ids), ids)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
            if i == 1:
                p16 = opt._amp_stash.all_fp16_params[0]
                p16.grad[(0,) * p16.grad.dim()] = float("inf")
        skipped = opt._amp_stash.already_patched
        opt.step()
        opt.zero_grad()
        hist.append((bool(skipped), _amp_state.loss_scalers[0].loss_scale(),
                     loss.item()))
    return opt, hist


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("materialize", [True, False])
def test_amp_o2_fused_sgd_matches_jax(materialize):
    sd, jopt, jhist = _jax_loop(materialize)
    topt, thist = _port_loop(sd, materialize)
    # skipped, scale: equal; the losses within fp32 rounding of fp16 work
    assert [h[:2] for h in thist] == [h[:2] for h in jhist] == [
        (False, 1024.0), (True, 512.0), (False, 512.0)]
    for a, b in zip(thist, jhist):
        assert abs(a[2] - b[2]) <= 1e-3 * abs(b[2]), (thist, jhist)
    assert topt.most_recent_scale == 1.0 and not topt.scale_set_by_backward
    js, ts = jopt._amp_stash, topt._amp_stash
    assert len(ts.all_fp16_params) == len(js.all_fp16_params) > 0
    # the fp16 copy FusedSGD's depth-4 launch wrote is its fp32 master
    # rounded to fp16, bit for bit, on both sides
    for stash, conv in ((ts, _np), (js, lambda x: _np(x.data))):
        for half, master in zip(stash.all_fp16_params,
                                stash.all_fp32_from_fp16_params):
            np.testing.assert_array_equal(
                conv(half), conv(master).astype(np.float16).astype(np.float32))
    # fp16 activations round at other places in the two frameworks: the
    # masters stay within 1e-4 and the momenta (sums of the gradients)
    # within 2e-3 of max(1, |ref|)
    for a, b in zip(
            ts.all_fp32_from_fp16_params + ts.all_fp32_from_fp32_params,
            js.all_fp32_from_fp16_params + js.all_fp32_from_fp32_params):
        assert _rel(a, b.data) <= 1e-4
        assert _rel(topt.state[a]["momentum_buffer"],
                    jopt.state[b]["momentum_buffer"]) <= 2e-3


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())
