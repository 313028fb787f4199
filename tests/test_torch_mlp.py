"""The port's ``mlp.MLP`` and ``mlp.mlp_function`` against the JAX
package's.

The weights travel by ``from_jax_state_dict`` under the JAX package's
names (``weight_i``, ``bias_i``); the forward and every gradient are held
against the JAX MLP's at fp32 (1e-5, the same GEMMs summed in other
orders); amp O1 treats ``mlp_function`` as one half-precision op (the
``"mlp"`` entry of ``FP16_FUNCS``): the cast-policy trace of one forward is
the JAX package's, op for op, and the fp16 output meets the JAX one within
fp16's rounding (1e-2 of its largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.amp import policy as jax_policy
from apex_tpu.mlp import MLP as JaxMLP
from apex_tpu.nn.modules import Ctx

from apex_tpu_torch import amp
from apex_tpu_torch.amp import policy
from apex_tpu_torch.amp._amp_state import reset as reset_amp
from apex_tpu_torch.mlp import MLP, mlp_function
from apex_tpu_torch.models import from_jax_state_dict
from apex_tpu_torch.optimizers import FusedSGD

torch.set_num_threads(2)

SIZES = [[80, 96, 64, 1], [48, 128, 32]]


def _pair(sizes, seed=0):
    jnn.manual_seed(seed)
    jm = JaxMLP(sizes)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(MLP(sizes, device="cpu"), sd)


def test_creation_names_and_initial_distributions():
    jm, tm = _pair(SIZES[0])
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert tm.num_layers == 3 and tm.weights[1] is tm.weight_1
    assert "MLP sizes: [80, 96, 64, 1]" in repr(tm)
    torch.manual_seed(0)
    wide = MLP([512, 1024, 256], device="cpu")
    # std sqrt(2 / (out + in)) for weights, sqrt(1 / out) for biases
    np.testing.assert_allclose(float(wide.weight_0.detach().std()),
                               np.sqrt(2.0 / 1536), rtol=2e-2)
    np.testing.assert_allclose(float(wide.bias_0.detach().std()),
                               np.sqrt(1.0 / 1024), rtol=1e-1)
    for kw in (dict(bias=False), dict(relu=False)):
        with pytest.raises(TypeError, match="both true"):
            MLP(SIZES[0], device="cpu", **kw)


@pytest.mark.parametrize("sizes", SIZES, ids=["80-96-64-1", "48-128-32"])
def test_forward_and_gradients_match_jax(sizes):
    jm, tm = _pair(sizes, seed=1)
    x = np.random.default_rng(2).uniform(-1, 1, (32, sizes[0])) \
        .astype(np.float32)
    params = list(jm.parameters())

    def jloss(vals):
        ctx = Ctx(env={id(p): v for p, v in zip(params, vals)})
        return jnp.mean(jm.forward(ctx, jnp.asarray(x))) * 10.0
    jout = jm(jnp.asarray(x))
    jgrads = jax.grad(jloss)([p.data for p in params])
    tx = torch.from_numpy(x)
    out = tm(tx)
    assert out.shape == (32, sizes[-1])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    assert (out >= 0).all()                 # ReLU after the last layer too
    (out.mean() * 10.0).backward()
    for (name, p), g in zip(tm.named_parameters(), jgrads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # the functional form over the flat (weights, biases) list
    again = mlp_function(tx, *tm.weights, *tm.biases)
    np.testing.assert_allclose(again.detach().numpy(), out.detach().numpy(),
                               rtol=1e-6, atol=1e-7)


def _trace(monkeypatch, pol_cls):
    trace = []
    orig = pol_cls.cast_args

    def rec(self, op, args, kwargs=None):
        a, k = orig(self, op, args, kwargs)
        outs = sorted({str(x.dtype).replace("torch.", "")
                       for x in jax.tree_util.tree_leaves((a, k))
                       if hasattr(x, "dtype") and "float" in str(x.dtype)})
        trace.append((op, tuple(outs)))
        return a, k
    monkeypatch.setattr(pol_cls, "cast_args", rec)
    return trace


def test_o1_trace_and_output_match_jax(monkeypatch):
    """Under the half policy the whole MLP is one "mlp" op cast to fp16
    and its body casts nothing more; the same trace as the JAX package's,
    and the same output within fp16's rounding."""
    jm, tm = _pair(SIZES[0], seed=3)
    x = np.random.default_rng(4).uniform(-1, 1, (16, 80)).astype(np.float32)
    jtrace = _trace(monkeypatch, jax_policy.CastPolicy)
    ttrace = _trace(monkeypatch, policy.CastPolicy)
    with jax_policy.autocast(jax_policy.CastPolicy(half_dtype=jnp.float16)):
        jout = jm(jnp.asarray(x))
    with policy.autocast(policy.CastPolicy(half_dtype=torch.float16)):
        out = tm(torch.from_numpy(x))
    assert jout.dtype == jnp.float16 and out.dtype == torch.float16
    assert ttrace == jtrace == [("mlp", ("float16",))]
    w = np.asarray(jout, np.float32)
    assert np.abs(out.float().detach().numpy() - w).max() \
        <= 1e-2 * max(1.0, np.abs(w).max())


def test_amp_o1_loop_runs_the_mlp_in_half():
    """``amp.initialize(O1)``'s module hooks put the forward under the
    policy: fp16 output, fp32 weights with fp32 gradients, a step that
    moves them."""
    reset_amp()
    try:
        torch.manual_seed(5)
        model = MLP([32, 64, 8], device="cpu")
        opt = FusedSGD(list(model.parameters()), lr=0.1)
        model, opt = amp.initialize(model, opt, opt_level="O1", verbosity=0)
        x = torch.randn(16, 32)
        before = [p.detach().clone() for p in model.parameters()]
        out = model(x)
        assert out.dtype == torch.float16
        loss = out.float().square().mean()
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        assert all(p.grad.dtype == torch.float32
                   for p in model.parameters())
        opt.step()
        assert any(not torch.equal(a, b)
                   for a, b in zip(model.parameters(), before))
    finally:
        reset_amp()
