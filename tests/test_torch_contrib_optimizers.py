"""The port's deprecated-API optimizers (``contrib.optimizers``: the legacy
``FusedAdam``, the two-stage ``FusedLAMB`` and ``FP16_Optimizer``) against
the JAX package's.

Both sides are plain per-tensor arithmetic (jnp there, PyTorch here) on
the same numpy-seeded tensors: the legacy Adam in both eps modes, with a
loss scale, explicit gradients, half ``output_params`` (bf16 and fp16),
the ``max_grad_norm`` clip fed by ``grad_norms``, weight decay and
per-parameter bias corrections (a parameter without a gradient for some
steps); the contrib LAMB's global-norm clip over two groups; and
``FP16_Optimizer`` over the legacy Adam: the skip and halving on an
overflow, growth after a clean window, ``grad_norms`` forwarded for the
clip, and a ``state_dict`` round trip.  Tolerances: 1e-5 relative for
three fp32 steps (the port takes the bias corrections in double on the
host, the JAX package in fp32 on the device), 1e-2 for half storage.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.optimizers import FP16_Optimizer as JaxFP16_Optimizer
from apex_tpu.contrib.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.contrib.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.nn.parameter import Parameter as JaxParameter

from apex_tpu_torch.contrib.optimizers import (FP16_Optimizer, FusedAdam,
                                               FusedLAMB)

torch.set_num_threads(2)

SHAPES = [(5, 3), (7,), (4, 4), (6,)]
_J = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
      torch.float16: jnp.float16}


def _arrays(seed, n_steps=3, gscale=1.0):
    r = np.random.default_rng(seed)
    init = [r.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(r.normal(size=s) * gscale).astype(np.float32)
              for s in SHAPES] for _ in range(n_steps)]
    return init, grads


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("eps_inside_sqrt", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16])
def test_legacy_adam_matches_jax_with_scale_and_output_params(
        eps_inside_sqrt, out_dtype):
    scale = 64.0
    init, grads = _arrays(1, gscale=scale)
    kw = dict(lr=1e-2, weight_decay=0.01, eps_inside_sqrt=eps_inside_sqrt)
    jp = [JaxParameter(jnp.asarray(a)) for a in init]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jout = [JaxParameter(jnp.asarray(a, _J[out_dtype])) for a in init]
    tout = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(out_dtype))
            for a in init]
    jopt = JaxFusedAdam([{"params": jp[:2]}, {"params": jp[2:], "lr": 3e-3}],
                        **kw)
    topt = FusedAdam([{"params": tp[:2]}, {"params": tp[2:], "lr": 3e-3}],
                     **kw)
    assert topt.eps_mode == jopt.eps_mode == (0 if eps_inside_sqrt else 1)
    for gs in grads:
        # explicit per-group gradients, the params' .grad left empty
        jopt.step(grads=[[jnp.asarray(g) for g in gs[:2]],
                         [jnp.asarray(g) for g in gs[2:]]],
                  output_params=[jout[:2], jout[2:]], scale=scale)
        topt.step(grads=[[torch.from_numpy(g) for g in gs[:2]],
                         [torch.from_numpy(g) for g in gs[2:]]],
                  output_params=[tout[:2], tout[2:]], scale=scale)
    for a, b, o, jo in zip(tp, jp, tout, jout):
        _close(a, b.data, 1e-5)
        assert o.dtype == out_dtype
        _close(o, jo.data, 1e-2)
        # the half copy is the fp32 weight rounded once
        assert torch.equal(o.detach(), a.detach().to(out_dtype))
        st, jst = topt.state[a], jopt.state[b]
        assert st["step"] == jst["step"] == 3
        assert st["exp_avg"].dtype == torch.float32
        _close(st["exp_avg"], jst["exp_avg"], 1e-5)
        _close(st["exp_avg_sq"], jst["exp_avg_sq"], 1e-5)


@pytest.mark.parametrize("max_grad_norm,factor", [(0.0, 1.0), (0.5, 1.0),
                                                  (0.5, 40.0)],
                         ids=["no-clip", "clip-inactive", "clip"])
def test_legacy_adam_clip_matches_jax(max_grad_norm, factor):
    """``grad_norms`` (of the still-scaled gradients) folds the group's
    clip into the combined scale; the port computes it on the device from
    the norm tensor."""
    scale = 8.0
    init, grads = _arrays(2, n_steps=2, gscale=scale * factor * 0.05)
    jp = [JaxParameter(jnp.asarray(a)) for a in init]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jopt = JaxFusedAdam(jp, lr=1e-2, max_grad_norm=max_grad_norm)
    topt = FusedAdam(tp, lr=1e-2, max_grad_norm=max_grad_norm)
    for gs in grads:
        gnorm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                  for g in gs)))
        for p, g in zip(jp, gs):
            p.grad = jnp.asarray(g)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        jopt.step(scale=scale, grad_norms=[gnorm])
        topt.step(scale=scale, grad_norms=[torch.tensor(gnorm)])
    for a, b in zip(tp, jp):
        _close(a, b.data, 1e-5)
        _close(topt.state[a]["exp_avg"], jopt.state[b]["exp_avg"], 1e-5)
    if factor > 1:      # the clip divided the gradients entering m
        unclipped = FusedAdam([torch.nn.Parameter(torch.from_numpy(
            init[0].copy()))], lr=1e-2)
        p = unclipped.param_groups[0]["params"][0]
        p.grad = torch.from_numpy(grads[0][0])
        unclipped.step(scale=scale)
        m = topt.state[tp[0]]["exp_avg"]
        assert m.abs().max() < 0.5 * unclipped.state[p]["exp_avg"].abs().max()


def test_legacy_adam_bias_correction_is_per_parameter():
    """A parameter without a gradient for 5 steps starts its own count;
    the other's trajectory is the one it has alone."""
    r = np.random.default_rng(3)
    wa, wb, gb = (r.normal(size=3).astype(np.float32) for _ in range(3))
    jp = [JaxParameter(jnp.asarray(wa)), JaxParameter(jnp.asarray(wb))]
    tp = [torch.nn.Parameter(torch.from_numpy(wa.copy())),
          torch.nn.Parameter(torch.from_numpy(wb.copy()))]
    jopt, topt = JaxFusedAdam(jp, lr=1e-2), FusedAdam(tp, lr=1e-2)
    for i in range(6):
        ga = None if i < 5 else gb
        jp[0].grad = None if ga is None else jnp.asarray(ga)
        jp[1].grad = jnp.asarray(gb)
        tp[0].grad = None if ga is None else torch.from_numpy(ga)
        tp[1].grad = torch.from_numpy(gb)
        jopt.step()
        topt.step()
    assert topt.state[tp[0]]["step"] == 1 and topt.state[tp[1]]["step"] == 6
    for a, b in zip(tp, jp):
        _close(a, b.data, 1e-5)
    alone = torch.nn.Parameter(torch.from_numpy(wb.copy()))
    opt = FusedAdam([alone], lr=1e-2)
    for _ in range(6):
        alone.grad = torch.from_numpy(gb)
        opt.step()
    np.testing.assert_allclose(tp[1].detach().numpy(),
                               alone.detach().numpy(), rtol=1e-6)


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0],
                         ids=["no-clip", "clip"])
def test_contrib_lamb_matches_jax_over_groups(max_grad_norm):
    """The global norm over every group's gradients, each group's clip,
    stage 1 and the trust ratio; a bf16 parameter keeps fp32 moments."""
    init, grads = _arrays(4, gscale=3.0)
    dts = [torch.float32] * 3 + [torch.bfloat16]
    jp = [JaxParameter(jnp.asarray(a, _J[d])) for a, d in zip(init, dts)]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(d))
          for a, d in zip(init, dts)]
    groups = lambda ps: [{"params": ps[:2]},                  # noqa: E731
                         {"params": ps[2:], "lr": 3e-3,
                          "weight_decay": 0.0, "grad_averaging": False}]
    kw = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=max_grad_norm)
    jopt, topt = JaxFusedLAMB(groups(jp), **kw), FusedLAMB(groups(tp), **kw)
    for gs in grads:
        for p, g, d in zip(jp, gs, dts):
            p.grad = jnp.asarray(g, _J[d])
        for p, g, d in zip(tp, gs, dts):
            p.grad = torch.from_numpy(g).to(d)
        jopt.step()
        topt.step()
    assert [g["step"] for g in topt.param_groups] == [3, 3]
    for a, b, d in zip(tp, jp, dts):
        tol = 1e-5 if d == torch.float32 else 1e-2
        assert a.dtype == d
        _close(a, b.data, tol)
        st, jst = topt.state[a], jopt.state[b]
        assert st["exp_avg"].dtype == torch.float32
        _close(st["exp_avg"], jst["exp_avg"], tol)
        _close(st["exp_avg_sq"], jst["exp_avg_sq"], tol)
    with pytest.raises(RuntimeError, match="adam_w_mode"):
        FusedLAMB(tp, adam_w_mode=False)


def _fp16_pair(init, half, **kw):
    """The JAX and port FP16_Optimizer over a legacy FusedAdam of half
    params made from ``init``."""
    jp = [JaxParameter(jnp.asarray(a, _J[half])) for a in init]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(half))
          for a in init]
    akw = kw.pop("adam", dict(lr=1e-2))
    jopt = JaxFP16_Optimizer(JaxFusedAdam(jp, **akw), verbose=False, **kw)
    topt = FP16_Optimizer(FusedAdam(tp, **akw), verbose=False, **kw)
    return jp, tp, jopt, topt


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_fp16_optimizer_matches_jax_skip_halving_and_growth(half):
    """Dynamic scale from 2^8, window 2: a clean step, an overflow (skipped,
    the scale halved first), then clean steps (the scale doubles after the
    window), every master and half weight alike on both sides."""
    init, grads = _arrays(5, n_steps=5)
    kw = dict(dynamic_loss_scale=True,
              dynamic_loss_args={"init_scale": 2.0 ** 8, "scale_window": 2})
    jp, tp, jopt, topt = _fp16_pair(init, half, **kw)
    hist = {"jax": [], "port": []}
    for i, gs in enumerate(grads):
        for side, ps, opt, mk in (
                ("jax", jp, jopt, lambda a: jnp.asarray(a, _J[half])),
                ("port", tp, topt, lambda a: torch.from_numpy(a).to(half))):
            scale = opt.loss_scale
            for p, g in zip(ps, gs):
                g = g * scale
                if i == 1:
                    g = g.copy()
                    g[0] = np.inf
                p.grad = mk(g)
            opt.step()
            hist[side].append((bool(opt.overflow), float(opt.loss_scale)))
            opt.zero_grad()
    assert hist["port"] == hist["jax"]
    assert [o for o, _ in hist["port"]] == [False, True, False, False, False]
    assert hist["port"][1][1] == hist["port"][0][1] / 2
    assert hist["port"][-1][1] > hist["port"][1][1]      # grew again
    tol = 1e-2 if half == torch.bfloat16 else 2e-3
    for g32, jg32, g16, jg16 in zip(topt.fp32_groups, jopt.fp32_groups,
                                    topt.fp16_groups, jopt.fp16_groups):
        for m, jm_, h, jh in zip(g32, jg32, g16, jg16):
            assert m.dtype == torch.float32 and h.dtype == half
            _close(m, jm_.data, tol)
            assert torch.equal(h.detach(), m.detach().to(half))
    assert all(p.grad is None for p in tp)


def test_fp16_optimizer_forwards_grad_norms_for_the_clip():
    init, grads = _arrays(6, n_steps=1)
    jp, tp, jopt, topt = _fp16_pair(
        init, torch.bfloat16, static_loss_scale=4.0,
        adam=dict(lr=1e-2, max_grad_norm=1e-3))
    for p, g in zip(jp, grads[0]):
        p.grad = jnp.asarray(g * 4.0, jnp.bfloat16)
    for p, g in zip(tp, grads[0]):
        p.grad = torch.from_numpy(g * 4.0).to(torch.bfloat16)
    jopt.step()
    topt.step()
    inner, jinner = topt.optimizer, jopt.optimizer
    for m, jm_ in zip(inner.param_groups[0]["params"],
                      jinner.param_groups[0]["params"]):
        got = inner.state[m]["exp_avg"]
        _close(got, jinner.state[jm_]["exp_avg"], 1e-4)
        assert got.abs().max() < 1e-2     # the clip divided the gradients


def test_fp16_optimizer_state_dict_round_trip_and_backward():
    """``backward`` scales the loss; ``state_dict`` is a snapshot (the
    scaler copied), and loading it restores masters, half weights,
    moments and scale into a fresh wrapper."""
    torch.manual_seed(0)
    model = torch.nn.Linear(6, 3).to(torch.bfloat16)
    opt = FP16_Optimizer(FusedAdam(list(model.parameters()), lr=1e-2),
                         dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 6},
                         verbose=False)
    x = torch.randn(8, 6).to(torch.bfloat16)
    for _ in range(2):
        opt.zero_grad()
        loss = model(x).float().square().mean()
        (g,) = torch.autograd.grad(loss, model.weight, retain_graph=True)
        opt.backward(loss)
        # the half weight's gradient is the scaled one
        np.testing.assert_allclose(model.weight.grad.float().numpy(),
                                   (g.float() * opt.loss_scale).numpy(),
                                   rtol=1e-2, atol=1e-6)
        opt.step()
    sd = opt.state_dict()
    assert sd["loss_scaler"] is not opt.loss_scaler
    scale_then = opt.loss_scale
    opt.loss_scaler.update_scale(True)
    assert sd["loss_scaler"].loss_scale == scale_then     # a snapshot

    torch.manual_seed(1)
    fresh_model = torch.nn.Linear(6, 3).to(torch.bfloat16)
    fresh = FP16_Optimizer(FusedAdam(list(fresh_model.parameters()),
                                     lr=1e-2), verbose=False)
    fresh.load_state_dict(sd)
    assert fresh.dynamic_loss_scale and fresh.loss_scale == scale_then
    for a, b in zip(fresh.fp32_groups[0], opt.fp32_groups[0]):
        assert torch.equal(a, b)
    for a, b in zip(fresh_model.parameters(), model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(fresh.optimizer.param_groups[0]["params"],
                    opt.optimizer.param_groups[0]["params"]):
        sa, sb = fresh.optimizer.state[a], opt.optimizer.state[b]
        assert sa["step"] == sb["step"] == 2
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
    with pytest.raises(RuntimeError, match="closures"):
        fresh.step(closure=lambda: 0)
