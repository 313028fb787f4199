"""The port's LAMB (``ops.multi_tensor_lamb``, ``optimizers.FusedLAMB`` and
the LAMB branch of ``make_train_step``) against the JAX package's.

LAMB is jnp in the JAX package and plain PyTorch in the port, so both
sides run the same per-tensor arithmetic on the same numpy-seeded
tensors: both weight-decay modes, with and without the gradient-norm clip,
tensors whose norms are zero (the trust ratio falls back to ``lr``), and a
step count given as a number or as a tensor.  Then the eager optimizer
over two groups and two dtypes, and the fused train step on a tiny GPT
whose weights are carried across by ``from_jax_state_dict``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.models import GptModel as JaxGpt
from apex_tpu.nn import functional as jax_F
from apex_tpu.nn.parameter import Parameter as JaxParameter
from apex_tpu.ops import multi_tensor as jax_ops
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch import ops
from apex_tpu_torch.models import GptModel, from_jax_state_dict
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.training import make_train_step

torch.set_num_threads(2)

SHAPES = [(5, 3), (7,), (4, 4), (6,), (3, 2)]


def _lists(seed, zero_p=False, zero_g=False, gscale=1.0):
    """grads, params, exp_avgs, exp_avg_sqs as numpy fp32 arrays; the last
    tensor's param and/or grad zeroed where asked."""
    r = np.random.default_rng(seed)
    out = [[(r.normal(size=s) * gscale).astype(np.float32) for s in SHAPES],
           [r.normal(size=s).astype(np.float32) for s in SHAPES],
           [(r.normal(size=s) * 0.1).astype(np.float32) for s in SHAPES],
           [np.abs(r.normal(size=s) * 0.01).astype(np.float32)
            for s in SHAPES]]
    if zero_g:
        out[0][-1][:] = 0
        out[2][-1][:] = 0
        out[3][-1][:] = 0
    if zero_p:
        out[1][-1][:] = 0
    return out


@pytest.mark.parametrize("mode,max_norm,gscale,zero_p,zero_g,tensor_step", [
    (1, 1.0, 3.0, False, False, False),    # decoupled, the norm clipped
    (0, 1.0, 3.0, False, False, True),     # L2 decay, clipped, device step
    (1, 0.0, 1.0, True, False, False),     # no clip; a zero param: ratio lr
    (0, 1e3, 1.0, False, True, True),      # clip inactive; zero update
    (1, 1.0, 0.01, True, True, False),     # zero param and zero update
])
def test_multi_tensor_lamb_matches_jax(mode, max_norm, gscale, zero_p,
                                       zero_g, tensor_step):
    lists = _lists(3, zero_p, zero_g, gscale)
    jl = [[jnp.asarray(a) for a in lst] for lst in lists]
    tl = [[torch.from_numpy(a.copy()) for a in lst] for lst in lists]
    wd = 0.0 if zero_g else 0.01
    _, jnorm, _ = jax_ops.multi_tensor_l2norm(jnp.zeros((), jnp.int32),
                                              [jl[0]])
    flag = ops.zero_flag("cpu")
    _, tnorm, _ = ops.multi_tensor_l2norm(flag, [tl[0]])
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    step = 3
    args = (2e-2, 0.9, 0.999, 1e-6)
    want = jax_ops.multi_tensor_lamb(
        jnp.zeros((), jnp.int32), jl, *args,
        jnp.asarray(step, jnp.int32) if tensor_step else step, True, wd, 1,
        mode, jnorm, max_norm)
    got = ops.multi_tensor_lamb(
        flag, tl, *args, torch.tensor(step, dtype=torch.int32)
        if tensor_step else step, True, wd, 1, mode, tnorm, max_norm)
    assert int(got[0]) == 0
    # the same fp32 arithmetic; sums (norms) in another order
    for g_list, w_list, old in zip(got[1:], want[1:], tl[1:]):
        for g, w, o in zip(g_list, w_list, old):
            assert g.dtype == o.dtype and g.shape == o.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    if zero_p:   # a zero param moves by lr * u: the ratio fell back to lr
        u_moved = got[1][-1].abs().max().item()
        assert u_moved > 0 or zero_g


def test_eager_fused_lamb_matches_jax_over_groups_and_dtypes():
    r = np.random.default_rng(9)
    shapes = [(5, 3), (7,), (4, 4), (6,)]
    init = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(r.normal(size=s) * 2).astype(np.float32) for s in shapes]
             for _ in range(3)]
    groups = [dict(lr=1e-2, weight_decay=0.01),
              dict(lr=3e-3, weight_decay=0.0, bias_correction=False,
                   max_grad_norm=0.0)]
    # the second group holds an fp32 and a bf16 bucket (a grad norm each)
    dts = [(jnp.float32, torch.float32)] * 3 + [(jnp.bfloat16,
                                                  torch.bfloat16)]
    jp = [JaxParameter(jnp.asarray(a, jd)) for a, (jd, _) in zip(init, dts)]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(td))
          for a, (_, td) in zip(init, dts)]
    jopt = JaxFusedLAMB([{"params": jp[:2], **groups[0]},
                         {"params": jp[2:], **groups[1]}], betas=(0.8, 0.99))
    topt = FusedLAMB([{"params": tp[:2], **groups[0]},
                      {"params": tp[2:], **groups[1]}], betas=(0.8, 0.99))
    for gs in grads:
        for p, g, (jd, td) in zip(jp, gs, dts):
            p.grad = jnp.asarray(g, jd)
        for p, g, (jd, td) in zip(tp, gs, dts):
            p.grad = torch.from_numpy(g).to(td)
        jopt.step()
        topt.step()
    assert [g["step"] for g in topt.param_groups] == [3, 3]
    # the JAX step takes the bias corrections in fp32 on the device, the
    # port's eager step in double on the host; the bf16 tensor rounds its
    # update to bf16 on both sides
    for (a, b), (_, td) in zip(zip(tp, jp), dts):
        tol = 1e-5 if td == torch.float32 else 1e-2
        assert a.dtype == td
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b.data, np.float32),
                                   rtol=tol, atol=tol)
        st = topt.state[a]
        assert st["exp_avg"].dtype == td
        np.testing.assert_allclose(
            st["exp_avg_sq"].float().numpy(),
            np.asarray(jopt.state[b]["exp_avg_sq"], np.float32),
            rtol=tol, atol=1e-7)
    topt.zero_grad()
    assert all(p.grad is None for p in tp)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(tp, amsgrad=True)


V, E, L, HEADS, S, B = 128, 64, 2, 4, 16, 2
CFG = dict(vocab_size=V, hidden=E, layers=L, heads=HEADS, max_positions=S,
           dropout=0.0, attn_dropout=0.0)


def _jax_loss(logits, ids):
    flat = logits[:, :-1].reshape((-1, logits.shape[-1]))
    return jax_F.cross_entropy(flat, ids[:, 1:].reshape((-1,)))


def _torch_loss(logits, ids):
    flat = logits[:, :-1].reshape(-1, logits.shape[-1])
    return F.cross_entropy(flat, ids[:, 1:].reshape(-1))


def test_train_step_with_fused_lamb_matches_jax():
    jnn.manual_seed(5)
    jm = JaxGpt(**CFG)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(GptModel(**CFG, device="cpu"), sd)
    kw = dict(lr=1e-2, weight_decay=0.01)
    jstep = jax_make_train_step(jm, JaxFusedLAMB(list(jm.parameters()), **kw),
                                _jax_loss, loss_scale=1.0)
    tstep = make_train_step(tm, FusedLAMB(list(tm.parameters()), **kw),
                            _torch_loss, loss_scale=1.0)
    ids = np.random.default_rng(1).integers(0, V, (B, S))
    with force_mode("interpret"):
        want = [float(jstep(jnp.asarray(ids), jnp.asarray(ids)))
                for _ in range(3)]
    got = [float(tstep(torch.from_numpy(ids), torch.from_numpy(ids)))
           for _ in range(3)]
    # fp32 on both sides: the same arithmetic up to summation order
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    assert int(tstep.state.step) == int(jstep.state.step) == 3
    names = [n for n, _ in tm.named_parameters()]
    jw = dict(zip([n for n, _ in jm.named_parameters()],
                  jstep.state.master_params))
    for n, t, m, v in zip(names, tstep.state.master_params,
                          tstep.state.opt_state["m"],
                          tstep.state.opt_state["v"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jw[n]), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    jm_state = dict(zip(names, zip(jstep.state.opt_state["m"],
                                   jstep.state.opt_state["v"])))
    for n, m, v in zip(names, tstep.state.opt_state["m"],
                       tstep.state.opt_state["v"]):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm_state[n][0]),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(v.numpy(), np.asarray(jm_state[n][1]),
                                   rtol=1e-4, atol=1e-9, err_msg=n)


def test_train_step_with_fused_lamb_skips_an_overflow():
    """fp16 half copies under the dynamic scale: a non-finite loss at step 2
    leaves the masters and moments as they were and halves the scale."""
    torch.manual_seed(0)
    tm = GptModel(**CFG, device="cpu")
    step = make_train_step(
        tm, FusedLAMB(list(tm.parameters()), lr=1e-2), lambda o, x, w:
        _torch_loss(o, x) * w, half_dtype=torch.float16,
        loss_scale="dynamic", max_loss_scale=2.0 ** 10)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, V, (B, S)))
    seen = []
    for w in (1.0, float("inf"), 1.0):
        before = [t.clone() for t in step.state.master_params
                  + step.state.opt_state["m"]]
        step(ids, ids, torch.tensor(w))
        after = step.state.master_params + step.state.opt_state["m"]
        seen.append((int(step.last_step_skipped),
                     float(step.state.scaler.loss_scale),
                     all(torch.equal(a, b) for a, b in zip(before, after))))
    assert seen == [(0, 1024.0, False), (1, 512.0, True), (0, 512.0, False)]
    assert int(step.state.step) == 2


def test_other_optimizers_are_refused_naming_their_owner():
    """An optimizer other than the four fused ones raises the JAX step's
    TypeError, which names the supported ones (every fused optimizer of
    the JAX step is ported)."""
    tm = GptModel(**CFG, device="cpu")
    sgd = torch.optim.SGD(tm.parameters(), lr=0.1)
    with pytest.raises(TypeError, match="supported: FusedSGD, FusedAdam, "
                                        "FusedLAMB, FusedNovoGrad"):
        make_train_step(tm, sgd, _torch_loss)


def test_amp_o2_with_fused_lamb_matches_jax():
    """amp O2 carries FusedLAMB through the generic master-weight path:
    fp32 masters in the optimizer, fp16 model copies re-made from them
    after each step, the losses and masters the JAX amp loop's."""
    from apex_tpu import amp as jamp
    from apex_tpu.amp._amp_state import reset as jax_reset
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import reset as port_reset

    jnn.manual_seed(7)
    jm = JaxGpt(**CFG)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(GptModel(**CFG, device="cpu"), sd)
    ids = np.random.default_rng(4).integers(0, V, (B, S))
    kw = dict(lr=1e-2, weight_decay=0.01)
    jax_reset()
    jm, jopt = jamp.initialize(jm, JaxFusedLAMB(list(jm.parameters()), **kw),
                               opt_level="O2", verbosity=0)
    port_reset()
    tm, topt = amp.initialize(tm, FusedLAMB(list(tm.parameters()), **kw),
                              opt_level="O2", verbosity=0)

    class _Loss(jnn.Module):
        def forward(self, ctx, logits, x):
            return _jax_loss(logits.astype(jnp.float32), x)
    jloss, want, got = _Loss(), [], []
    for _ in range(3):
        loss = jloss(jm(jnp.asarray(ids)), jnp.asarray(ids))
        with jamp.scale_loss(loss, jopt) as scaled:
            scaled.backward()
        jopt.step()
        jopt.zero_grad()
        want.append(float(loss))
        x = torch.from_numpy(ids)
        loss = _torch_loss(tm(x).float(), x)
        with amp.scale_loss(loss, topt) as scaled:
            scaled.backward()
        topt.step()
        topt.zero_grad()
        got.append(float(loss.detach()))
    # fp16 forward and backward, rounded at other places on the two sides
    np.testing.assert_allclose(got, want, rtol=5e-2)
    assert got[-1] < got[0]
    masters = topt._amp_stash.all_fp32_from_fp16_params
    halves = topt._amp_stash.all_fp16_params
    assert masters and all(m.dtype == torch.float32 for m in masters)
    for h, m in zip(halves, masters):
        assert h.dtype == torch.float16
        assert torch.equal(h, m.detach().half())
    jmasters = jopt._amp_stash.all_fp32_from_fp16_params
    # a zero tensor (LayerNorm biases) takes the ratio lr and moves by
    # about lr per element whatever its gradient (2 lr a step apart where a
    # tiny fp16 gradient's sign differs); 99% of the elements within 1e-3
    diff = np.concatenate([np.abs(m.detach().numpy()
                                  - np.asarray(j.data)).ravel()
                           for m, j in zip(masters, jmasters)])
    assert diff.max() <= 6 * kw["lr"], diff.max()
    assert (diff <= 1e-3).mean() >= 0.99, (diff > 1e-3).sum()
