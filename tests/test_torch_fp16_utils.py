"""The port's ``fp16_utils`` against the JAX package's, on the CPU: the
cases of ``tests/test_fp16_utils.py`` on the port (network conversion,
master/model parameter lists, flat masters, ``FP16_Optimizer`` and its
overflow skip, the dynamic scaler, ``FP16Model``), and a manual
``FP16_Optimizer`` loop of the same weights and batch on both sides (3
steps, bf16 model, dynamic scale): losses, fp32 masters and the scale
history within bf16 rounding.
"""
import functools

import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

import apex_tpu.nn as jnn
from apex_tpu.fp16_utils import FP16_Optimizer as JaxFP16_Optimizer
from apex_tpu.fp16_utils import network_to_half as jax_network_to_half
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD

from apex_tpu_torch.fp16_utils import (
    BN_convert_float, DynamicLossScaler, FP16Model, FP16_Optimizer,
    LossScaler, clip_grad_norm, convert_network,
    master_params_to_model_params, model_grads_to_master_grads,
    network_to_half, prep_param_lists, to_python_float, tofp16)
from apex_tpu_torch.models import from_jax_state_dict
from apex_tpu_torch.optimizers import FusedSGD

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _jax_sd():
    jnn.manual_seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.BatchNorm1d(16), jnn.ReLU(),
                        jnn.Linear(16, 4))
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _jax_model():
    jnn.manual_seed(0)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.BatchNorm1d(16), jnn.ReLU(),
                          jnn.Linear(16, 4))


def _model():
    m = nn.Sequential(nn.Linear(8, 16), nn.BatchNorm1d(16), nn.ReLU(),
                      nn.Linear(16, 4))
    return from_jax_state_dict(m, _jax_sd())


def test_network_to_half_keeps_bn_fp32():
    m = network_to_half(_model())
    dtypes = {name: p.dtype for name, p in m.named_parameters()}
    assert dtypes["0.weight"] == torch.bfloat16
    assert dtypes["1.weight"] == torch.float32
    assert dtypes["3.weight"] == torch.bfloat16
    assert m[1].running_mean.dtype == torch.float32
    assert m[1].num_batches_tracked.dtype == torch.int64
    jm = jax_network_to_half(_jax_model())
    jd = {n: jnp.dtype(p.dtype).name for n, p in jm.named_parameters()}
    assert {n: str(d).replace("torch.", "") for n, d in dtypes.items()} == jd


def test_tofp16_and_bn_convert_float():
    m = tofp16(_model(), torch.float16)
    assert all(p.dtype == torch.float16 for p in m.parameters())
    BN_convert_float(m)
    assert m[1].weight.dtype == torch.float32
    assert m[0].weight.dtype == torch.float16


def test_convert_network_dtype():
    m = convert_network(_model(), torch.float16)
    assert m[0].weight.dtype == torch.float16
    assert m[1].weight.dtype == torch.float32


def test_prep_param_lists_roundtrip():
    m = network_to_half(_model())
    model_params, master_params = prep_param_lists(m)
    assert all(mp.dtype == torch.float32 for mp in master_params)
    for p in model_params:
        p.grad = torch.ones_like(p)
    model_grads_to_master_grads(model_params, master_params)
    assert all(mp.grad.dtype == torch.float32 for mp in master_params)
    with torch.no_grad():
        for mp in master_params:
            mp.mul_(0.5)
    master_params_to_model_params(model_params, master_params)
    for p, mp in zip(model_params, master_params):
        assert p.dtype in (torch.bfloat16, torch.float32)
        torch.testing.assert_close(p.float(), mp.to(p.dtype).float(),
                                   rtol=0, atol=0)


def test_prep_param_lists_flat_master():
    m = network_to_half(_model())
    model_params, master = prep_param_lists(m, flat_master=True)
    assert len(master) == 1
    total = sum(p.numel() for p in model_params)
    assert master[0].numel() == total and master[0].dtype == torch.float32
    for p in model_params:
        p.grad = torch.full_like(p, 2.0)
    model_params[0].grad = None
    model_grads_to_master_grads(model_params, master, flat_master=True)
    n0 = model_params[0].numel()
    assert torch.all(master[0].grad[:n0] == 0)
    assert torch.all(master[0].grad[n0:] == 2)
    with torch.no_grad():
        master[0].add_(1.0)
    before = [p.detach().float().clone() for p in model_params]
    master_params_to_model_params(model_params, master, flat_master=True)
    for p, b in zip(model_params, before):
        torch.testing.assert_close(p.float(), (b + 1.0).to(p.dtype).float(),
                                   rtol=0, atol=0)


def test_fp16_optimizer_step_and_overflow():
    m = network_to_half(_model())
    opt = FP16_Optimizer(FusedSGD(list(m.parameters()), lr=0.1),
                         dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2 ** 8},
                         verbose=False)
    params = list(m.parameters())
    before = [p.detach().float().clone() for p in params]
    for p in params:
        p.grad = torch.ones_like(p) * float(opt.loss_scale)
    opt.update_master_grads()
    assert not opt.overflow
    assert opt.clip_master_grads(1e9) > 0
    opt.step()
    after = [p.detach().float() for p in params]
    assert any(not torch.allclose(b, a) for b, a in zip(before, after))
    scale0 = opt.loss_scale
    for p in params:
        p.grad = torch.full_like(p, float("inf"))
    opt.update_master_grads()
    assert opt.overflow
    assert opt.clip_master_grads(1.0) == -1
    snap = [p.detach().clone() for p in params]
    opt.step()
    assert all(torch.equal(s, p) for s, p in zip(snap, params))
    assert opt.loss_scale == scale0 / 2


def test_dynamic_scaler_growth():
    s = DynamicLossScaler(init_scale=4.0, scale_window=2)
    s.update_scale(False)
    s.update_scale(False)
    assert s.loss_scale >= 8.0
    s.update_scale(True)
    assert s.loss_scale == 4.0
    static = LossScaler(16.0)
    assert static.loss_scale == 16.0 and not static.has_overflow([])
    assert DynamicLossScaler._has_inf_or_nan(torch.tensor([1.0, float(
        "nan")]))


def test_fp16model_wraps_batchnorm_safely():
    torch.manual_seed(2)
    net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8),
                        nn.ReLU(), nn.Flatten(), nn.Linear(8 * 16, 4))
    wrapped = FP16Model(net)
    assert net[0].weight.dtype == torch.bfloat16
    assert net[4].weight.dtype == torch.bfloat16
    assert net[1].weight.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 4, 4)).astype(np.float32))
    out = wrapped(x)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_clip_grad_norm_and_to_python_float():
    ps = [nn.Parameter(torch.zeros(3)), nn.Parameter(torch.zeros(4))]
    ps[0].grad = torch.tensor([3.0, 0.0, 0.0])
    ps[1].grad = torch.tensor([0.0, 4.0, 0.0, 0.0])
    total = clip_grad_norm(ps, 1.0)
    assert abs(total - 5.0) < 1e-6
    assert abs(float(torch.cat([p.grad for p in ps]).norm()) - 1.0) < 1e-5
    assert clip_grad_norm(ps, 10.0, norm_type=float("inf")) < 1.0
    assert to_python_float(torch.tensor(2.5)) == 2.5


def test_fp16_optimizer_loop_matches_jax():
    r = np.random.default_rng(3)
    x = r.standard_normal((8, 8)).astype(np.float32)
    y = r.standard_normal((8, 4)).astype(np.float32)
    args = dict(dynamic_loss_scale=True,
                dynamic_loss_args={"init_scale": 2 ** 8, "scale_window": 2},
                verbose=False)
    jm = jax_network_to_half(_jax_model())
    jopt = JaxFP16_Optimizer(JaxFusedSGD(list(jm.parameters()), lr=0.05,
                                         momentum=0.9), **args)
    tm = network_to_half(_model())
    topt = FP16_Optimizer(FusedSGD(list(tm.parameters()), lr=0.05,
                                   momentum=0.9), **args)
    jl, tl, js, ts = [], [], [], []
    for _ in range(3):
        jloss = jnn.MSELoss()(jm(jnp.asarray(x, jnp.bfloat16)).float(),
                              jnp.asarray(y))
        jopt.backward(jloss)
        jopt.step()
        jopt.zero_grad()
        jl.append(float(jloss))
        js.append(jopt.loss_scale)
        tloss = nn.MSELoss()(tm(torch.from_numpy(x).bfloat16()).float(),
                             torch.from_numpy(y))
        topt.backward(tloss)
        topt.step()
        topt.zero_grad()
        tl.append(float(tloss.detach()))
        ts.append(topt.loss_scale)
    assert ts == js
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    # the masters: within 2e-2 of max(1, |ref|), a few bf16 roundings of
    # the gradients apart after 3 momentum steps
    for tg, jg in zip(topt.fp32_from_fp16_groups, jopt.fp32_from_fp16_groups):
        for tp, jp in zip(tg, jg):
            ref = np.asarray(jp.data, np.float64)
            err = np.abs(tp.detach().numpy() - ref).max()
            assert err / max(1.0, np.abs(ref).max()) < 2e-2
    sd = topt.state_dict()
    topt.load_state_dict(sd)
    assert topt.loss_scale == ts[-1]
