"""The port's NovoGrad (``ops.multi_tensor_novograd``,
``optimizers.FusedNovoGrad`` and the NovoGrad branch of
``make_train_step``) against the JAX package's.

NovoGrad is jnp in the JAX package and plain PyTorch in the port, so both
sides run the same per-tensor fp32 arithmetic on the same numpy-seeded
tensors (the port's L2 norms are ``torch._foreach_norm``'s, summed in
another order): both moment modes, both norm types, with and without
gradient averaging and bias correction, a step given as a number or as a
tensor, and non-finite gradients, which propagate.  Then the eager
optimizer over two groups (one with ``init_zero`` and the L-inf norm)
and two dtype buckets, and the fused train step on a bias-free model (a
bias that feeds nothing has an analytically zero gradient, which a
normalised update turns into O(lr) noise) whose weights are carried by
``from_jax_state_dict``, against the JAX step and the port's eager loop.
Tolerances: 1e-6 relative for one op call, 1e-5 for three fp32 steps,
1e-2 for bf16 storage.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.nn import functional as jax_F
from apex_tpu.nn.parameter import Parameter as JaxParameter
from apex_tpu.ops import multi_tensor as jax_ops
from apex_tpu.optimizers import FusedNovoGrad as JaxFusedNovoGrad
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch import ops
from apex_tpu_torch.models import from_jax_state_dict
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedNovoGrad
from apex_tpu_torch.training import make_train_step

torch.set_num_threads(2)

SHAPES = [(5, 3), (7,), (4, 4), (6,), (3, 2)]


def _lists(seed, nonfinite=False):
    """grads, params, exp_avgs (fp32 numpy) and one positive running norm
    a tensor; with ``nonfinite`` an inf and a NaN in two gradients."""
    r = np.random.default_rng(seed)
    out = [[r.normal(size=s).astype(np.float32) for s in SHAPES],
           [r.normal(size=s).astype(np.float32) for s in SHAPES],
           [(r.normal(size=s) * 0.1).astype(np.float32) for s in SHAPES],
           [np.float32(abs(r.normal()) + 0.5) for _ in SHAPES]]
    if nonfinite:
        out[0][1][2] = np.inf
        out[0][3][0] = np.nan
    return out


@pytest.mark.parametrize(
    "moment_mode,norm_type,grad_avg,bias_corr,tensor_step,nonfinite", [
        (1, 2, 1, True, False, False),
        (0, 2, 1, True, True, False),
        (1, 0, 1, True, True, False),
        (0, 0, 0, True, False, False),
        (1, 2, 0, False, False, False),
        (0, 0, 1, False, True, False),
        (1, 2, 1, True, False, True),
        (0, 0, 1, True, True, True),
    ])
def test_multi_tensor_novograd_matches_jax(moment_mode, norm_type, grad_avg,
                                           bias_corr, tensor_step,
                                           nonfinite):
    lists = _lists(11, nonfinite)
    jl = [[jnp.asarray(a) for a in lst] for lst in lists]
    tl = [[torch.from_numpy(np.array(a)) for a in lst] for lst in lists]
    step = 4
    args = (2e-2, 0.95, 0.98, 1e-8)
    want = jax_ops.multi_tensor_novograd(
        jnp.zeros((), jnp.int32), jl, *args,
        jnp.asarray(step, jnp.int32) if tensor_step else step, bias_corr,
        0.01, grad_avg, moment_mode, norm_type)
    flag = ops.zero_flag("cpu")
    got = ops.multi_tensor_novograd(
        flag, tl, *args, torch.tensor(step, dtype=torch.int32)
        if tensor_step else step, bias_corr, 0.01, grad_avg, moment_mode,
        norm_type)
    assert int(got[0]) == 0
    for g_list, w_list, old in zip(got[1:], want[1:], tl[1:]):
        for g, w, o in zip(g_list, w_list, old):
            assert g.dtype == o.dtype and g.shape == o.shape
            w = np.asarray(w)
            # the same non-finite entries on both sides
            np.testing.assert_array_equal(np.isfinite(g.numpy()),
                                          np.isfinite(w))
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    if nonfinite:
        assert not torch.isfinite(got[3][1]) and torch.isnan(got[1][3]).all()


def test_novograd_refuses_other_norms_and_amsgrad():
    tl = [[torch.ones(3)], [torch.ones(3)], [torch.zeros(3)],
          [torch.ones(())]]
    with pytest.raises(RuntimeError, match="norm"):
        ops.multi_tensor_novograd(ops.zero_flag("cpu"), tl, 1e-3, 0.9, 0.98,
                                  1e-8, 1, True, 0.0, 1, 1, 1)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad([torch.nn.Parameter(torch.ones(2))], amsgrad=True)


def _eager_pair(init, dts, groups, **kw):
    jp = [JaxParameter(jnp.asarray(a, jd)) for a, (jd, _) in zip(init, dts)]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(td))
          for a, (_, td) in zip(init, dts)]
    jopt = JaxFusedNovoGrad([{"params": jp[:2], **groups[0]},
                             {"params": jp[2:], **groups[1]}], **kw)
    topt = FusedNovoGrad([{"params": tp[:2], **groups[0]},
                          {"params": tp[2:], **groups[1]}], **kw)
    return jp, tp, jopt, topt


@pytest.mark.parametrize("reg_inside_moment", [False, True])
def test_eager_fused_novograd_matches_jax_over_groups_and_dtypes(
        reg_inside_moment):
    r = np.random.default_rng(9)
    shapes = [(5, 3), (7,), (4, 4), (6,)]
    init = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(r.normal(size=s) * 2).astype(np.float32) for s in shapes]
             for _ in range(3)]
    groups = [dict(lr=1e-2, weight_decay=0.01),
              dict(lr=3e-3, weight_decay=0.0, norm_type=0, init_zero=True,
                   grad_averaging=False)]
    # the second group holds an fp32 and a bf16 bucket
    dts = [(jnp.float32, torch.float32)] * 3 + [(jnp.bfloat16,
                                                  torch.bfloat16)]
    jp, tp, jopt, topt = _eager_pair(init, dts, groups, betas=(0.9, 0.98),
                                     reg_inside_moment=reg_inside_moment)
    assert topt.moment_mode == jopt.moment_mode == (
        0 if reg_inside_moment else 1)
    for gs in grads:
        for p, g, (jd, _) in zip(jp, gs, dts):
            p.grad = jnp.asarray(g, jd)
        for p, g, (_, td) in zip(tp, gs, dts):
            p.grad = torch.from_numpy(g).to(td)
        jopt.step()
        topt.step()
    assert [g["step"] for g in topt.param_groups] == [3, 3]
    for a, b, (_, td) in zip(tp, jp, dts):
        tol = 1e-5 if td == torch.float32 else 1e-2
        assert a.dtype == td
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b.data, np.float32),
                                   rtol=tol, atol=tol)
        st, jst = topt.state[a], jopt.state[b]
        assert st["exp_avg"].dtype == td
        assert st["exp_avg_sq"].shape == () and \
            st["exp_avg_sq"].dtype == torch.float32
        np.testing.assert_allclose(st["exp_avg"].float().numpy(),
                                   np.asarray(jst["exp_avg"], np.float32),
                                   rtol=tol, atol=1e-6)
        np.testing.assert_allclose(float(st["exp_avg_sq"]),
                                   float(jst["exp_avg_sq"]), rtol=1e-5)
    topt.zero_grad()
    assert all(p.grad is None for p in tp)


@pytest.mark.parametrize("norm_type", [2, 0])
def test_first_step_seeds_the_norm_with_the_gradients(norm_type):
    """Without ``init_zero`` the first blend leaves the running norm at
    the gradient's own norm; with it, the norm starts at zero."""
    g = np.random.default_rng(3).normal(size=(4, 5)).astype(np.float32)
    want = np.abs(g).max() if norm_type == 0 else np.linalg.norm(g)
    # from zero, one blend with beta2 0.98 gives 0.02 max|g| (L-inf) or
    # sqrt(0.02) |g| (L2)
    from_zero = 0.02 * want if norm_type == 0 else np.sqrt(0.02) * want
    for init_zero, expect in ((False, want), (True, from_zero)):
        p = torch.nn.Parameter(torch.ones(4, 5))
        p.grad = torch.from_numpy(g)
        opt = FusedNovoGrad([p], norm_type=norm_type, init_zero=init_zero)
        opt.step()
        np.testing.assert_allclose(float(opt.state[p]["exp_avg_sq"]),
                                   expect, rtol=1e-6)


def _bias_free_pair(seed):
    jnn.manual_seed(seed)
    jm = jnn.Sequential(jnn.Linear(12, 16, bias=False), jnn.ReLU(),
                        jnn.Linear(16, 5, bias=False))
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}

    def port():
        tm = torch.nn.Sequential(torch.nn.Linear(12, 16, bias=False),
                                 torch.nn.ReLU(),
                                 torch.nn.Linear(16, 5, bias=False))
        return from_jax_state_dict(tm, sd)
    return jm, port


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, weight_decay=0.01),
    dict(lr=1e-2, weight_decay=0.01, reg_inside_moment=True, norm_type=0),
    dict(lr=5e-3, init_zero=True, grad_averaging=False),
], ids=["l2-decoupled", "inf-reg-inside", "init-zero"])
def test_train_step_with_fused_novograd_matches_jax_and_eager(kw):
    jm, port = _bias_free_pair(4)
    r = np.random.default_rng(5)
    x = r.normal(size=(8, 12)).astype(np.float32)
    y = r.integers(0, 5, (8,))
    jstep = jax_make_train_step(
        jm, JaxFusedNovoGrad(list(jm.parameters()), **kw),
        lambda o, t: jax_F.cross_entropy(o, t), loss_scale=1.0)
    want = [float(jstep(jnp.asarray(x), jnp.asarray(y))) for _ in range(3)]
    tm = port()
    tstep = make_train_step(tm, FusedNovoGrad(list(tm.parameters()), **kw),
                            lambda o, t: F.cross_entropy(o, t),
                            loss_scale=1.0)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = [float(tstep(tx, ty)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(tstep.state.step) == 3
    # the port's eager loop over the same weights
    em = port()
    eopt = FusedNovoGrad(list(em.parameters()), **kw)
    for _ in range(3):
        F.cross_entropy(em(tx), ty).backward()
        eopt.step()
        eopt.zero_grad()
    for t, j, e, n in zip(tstep.state.master_params,
                          jstep.state.master_params, em.parameters(),
                          tstep.state.opt_state["grad_norms"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(t.numpy(), e.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert n.shape == () and n.dtype == torch.float32
    for t, j in zip(tstep.state.opt_state["grad_norms"],
                    jstep.state.opt_state["grad_norms"]):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_train_step_with_fused_novograd_skips_an_overflow():
    """fp16 half copies under the dynamic scale: a non-finite loss at step
    2 leaves masters, moments and norms as they were and halves the
    scale."""
    _, port = _bias_free_pair(6)
    tm = port()
    step = make_train_step(
        tm, FusedNovoGrad(list(tm.parameters()), lr=1e-2),
        lambda o, t, w: F.cross_entropy(o.float(), t) * w,
        half_dtype=torch.float16, loss_scale="dynamic",
        max_loss_scale=2.0 ** 10)
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.normal(size=(8, 12)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, 5, (8,)))
    seen = []
    for w in (1.0, float("inf"), 1.0):
        st = step.state
        before = [t.clone() for t in st.master_params + st.opt_state["m"]
                  + st.opt_state["grad_norms"]]
        step(x, y, torch.tensor(w))
        st = step.state
        after = st.master_params + st.opt_state["m"] \
            + st.opt_state["grad_norms"]
        seen.append((int(step.last_step_skipped),
                     float(step.state.scaler.loss_scale),
                     all(torch.equal(a, b) for a, b in zip(before, after))))
    assert seen == [(0, 1024.0, False), (1, 512.0, True), (0, 512.0, False)]
    assert int(step.state.step) == 2
