"""The port's GAN train step (``training.make_gan_train_step``) on the CPU:
against the port's eager loop in the reference ordering, as
``tests/test_gan_step.py`` holds the JAX step against the JAX tape; against
the JAX step on the same weights (the test's small GAN, and the DCGAN
networks of ``examples/dcgan/main_amp.py`` with the example's ``--fused``
O1 mapping: no half copies, a dynamic scale, BCE with logits); a D overflow
that skips D only; ``sync_to_objects``; a dropout discriminator; and an
lr schedule.
"""
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as tF
from torch import nn

import apex_tpu.nn as jnn
from apex_tpu.nn import functional as jF
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.training import make_gan_train_step as jax_make_gan_train_step

from apex_tpu_torch.models import from_jax_state_dict
from apex_tpu_torch.models.dcgan import build_discriminator, build_generator
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import GanTrainStep, make_gan_train_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZDIM = 8
EPS = 1e-6


class _JaxReshape(jnn.Module):
    def __init__(self, shape):
        super().__init__()
        self.shape = shape

    def forward(self, ctx, x):
        return x.reshape((x.shape[0],) + self.shape)


class _Reshape(nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.shape = shape

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.shape)


@functools.lru_cache(maxsize=None)
def _jax_sds():
    d, g = _jax_gan()
    return ({k: np.asarray(v) for k, v in d.state_dict().items()},
            {k: np.asarray(v) for k, v in g.state_dict().items()})


def _jax_gan():
    jnn.manual_seed(11)
    netD = jnn.Sequential(
        jnn.Conv2d(1, 8, 3, stride=2, padding=1, bias=False),
        jnn.BatchNorm2d(8), jnn.LeakyReLU(0.2),
        jnn.Flatten(), jnn.Linear(8 * 4 * 4, 1), jnn.Sigmoid())
    netG = jnn.Sequential(
        jnn.Linear(ZDIM, 64), jnn.ReLU(), jnn.Linear(64, 64), jnn.Tanh(),
        _JaxReshape((1, 8, 8)))
    return netD, netG


def _gan():
    netD = nn.Sequential(
        nn.Conv2d(1, 8, 3, stride=2, padding=1, bias=False),
        nn.BatchNorm2d(8), nn.LeakyReLU(0.2),
        nn.Flatten(), nn.Linear(8 * 4 * 4, 1), nn.Sigmoid())
    netG = nn.Sequential(
        nn.Linear(ZDIM, 64), nn.ReLU(), nn.Linear(64, 64), nn.Tanh(),
        _Reshape((1, 8, 8)))
    dsd, gsd = _jax_sds()
    return from_jax_state_dict(netD, dsd), from_jax_state_dict(netG, gsd)


def d_loss(out_r, out_f):
    return -(torch.log(out_r + EPS).mean() + torch.log(1.0 - out_f + EPS)
             .mean())


def g_loss(out_f):
    return -torch.log(out_f + EPS).mean()


def jax_d_loss(out_r, out_f):
    return -(jnp.mean(jnp.log(out_r + EPS))
             + jnp.mean(jnp.log(1.0 - out_f + EPS)))


def jax_g_loss(out_f):
    return -jnp.mean(jnp.log(out_f + EPS))


def _data(n=8, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 1, 8, 8)).astype(np.float32),
            r.standard_normal((n, ZDIM)).astype(np.float32))


def _adams(netD, netG, cls=FusedAdam, **kw):
    return (cls(list(netD.parameters()), lr=2e-3, **kw),
            cls(list(netG.parameters()), lr=2e-3, **kw))


def test_gan_step_matches_eager_loop():
    real, z = map(torch.from_numpy, _data())
    netD, netG = _gan()
    optD, optG = _adams(netD, netG)
    hist = []
    for _ in range(3):
        optD.zero_grad()
        fake = netG(z)
        errD = d_loss(netD(real), netD(fake.detach()))
        errD.backward()
        optD.step()
        optG.zero_grad()
        errG = g_loss(netD(fake))
        errG.backward()
        optG.step()
        hist.append((float(errD.detach()), float(errG.detach())))
    netD_b, netG_b = _gan()
    optD_b, optG_b = _adams(netD_b, netG_b)
    step = make_gan_train_step(netD_b, netG_b, optD_b, optG_b, d_loss,
                               g_loss, loss_scale=1.0)
    assert isinstance(step, GanTrainStep)
    for i in range(3):
        errD, errG = step(real, z)
        np.testing.assert_allclose(float(errD), hist[i][0], rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(float(errG), hist[i][1], rtol=2e-4,
                                   atol=1e-6)
    for net, sub in ((netD, step.state.d), (netG, step.state.g)):
        for p, m in zip(net.parameters(), sub.master_params):
            np.testing.assert_allclose(p.detach().numpy(), m.numpy(),
                                       rtol=2e-4, atol=2e-6)
    # BatchNorm's statistics moved as the eager loop's did (3 D forwards)
    torch.testing.assert_close(netD_b[1].running_mean, netD[1].running_mean)
    assert int(step.state.d.step) == 3 and int(step.state.g.step) == 3
    assert step.compile_s is not None


def test_gan_step_matches_jax():
    real, z = _data()
    jD, jG = _jax_gan()
    jstep = jax_make_gan_train_step(jD, jG, *_adams(jD, jG, JaxFusedAdam),
                                    jax_d_loss, jax_g_loss, loss_scale=1.0)
    netD, netG = _gan()
    step = make_gan_train_step(netD, netG, *_adams(netD, netG), d_loss,
                               g_loss, loss_scale=1.0)
    for _ in range(3):
        jd, jg = jstep(jnp.asarray(real), jnp.asarray(z))
        td, tg = step(torch.from_numpy(real), torch.from_numpy(z))
        np.testing.assert_allclose([float(td), float(tg)],
                                   [float(jd), float(jg)], rtol=2e-4)
    for tsub, jsub in ((step.state.d, jstep.state.d),
                       (step.state.g, jstep.state.g)):
        for tm, jm in zip(tsub.master_params, jsub.master_params):
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm),
                                       rtol=2e-4, atol=2e-6)


def _dcgan_example():
    spec = importlib.util.spec_from_file_location(
        "_dcgan_example", os.path.join(REPO, "examples", "dcgan",
                                       "main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dcgan_fused_o1_mapping_matches_jax():
    """The example's --fused path at O1 (half_dtype None, a dynamic
    scale): 3 iterations of the DCGAN networks at nz 16, ngf = ndf = 8."""
    ex = _dcgan_example()
    jnn.manual_seed(0)
    jG, jD = ex.build_generator(16, 8), ex.build_discriminator(8)
    tG = from_jax_state_dict(build_generator(16, 8, device="cpu"),
                             {k: np.asarray(v) for k, v in
                              jG.state_dict().items()})
    tD = from_jax_state_dict(build_discriminator(8, device="cpu"),
                             {k: np.asarray(v) for k, v in
                              jD.state_dict().items()})

    def jd_loss(out_r, out_f):
        return (jF.binary_cross_entropy_with_logits(out_r, jnp.ones_like(
            out_r)) + jF.binary_cross_entropy_with_logits(
            out_f, jnp.zeros_like(out_f)))

    def jg_loss(out_f):
        return jF.binary_cross_entropy_with_logits(out_f,
                                                   jnp.ones_like(out_f))

    def td_loss(out_r, out_f):
        return (tF.binary_cross_entropy_with_logits(out_r, torch.ones_like(
            out_r)) + tF.binary_cross_entropy_with_logits(
            out_f, torch.zeros_like(out_f)))

    def tg_loss(out_f):
        return tF.binary_cross_entropy_with_logits(out_f,
                                                   torch.ones_like(out_f))

    kw = dict(lr=2e-4, betas=(0.5, 0.999))
    jstep = jax_make_gan_train_step(
        jD, jG, JaxFusedAdam(list(jD.parameters()), **kw),
        JaxFusedAdam(list(jG.parameters()), **kw), jd_loss, jg_loss,
        half_dtype=None, loss_scale="dynamic")
    step = make_gan_train_step(
        tD, tG, FusedAdam(list(tD.parameters()), **kw),
        FusedAdam(list(tG.parameters()), **kw), td_loss, tg_loss,
        half_dtype=None, loss_scale="dynamic")
    r = np.random.default_rng(0)
    for _ in range(3):
        real = r.standard_normal((4, 3, 32, 32)).astype(np.float32)
        noise = r.standard_normal((4, 16, 1, 1)).astype(np.float32)
        jd, jg = jstep(jnp.asarray(real), jnp.asarray(noise))
        td, tg = step(torch.from_numpy(real), torch.from_numpy(noise))
        np.testing.assert_allclose([float(td), float(tg)],
                                   [float(jd), float(jg)], rtol=1e-3)
    for net, tsub, jsub in ((tD, step.state.d, jstep.state.d),
                            (tG, step.state.g, jstep.state.g)):
        assert float(tsub.scaler.loss_scale) == float(jsub.scaler.loss_scale)
        assert int(tsub.step) == int(jsub.step) == 3
        # a bias right before a BatchNorm has a gradient of 0 in exact
        # arithmetic, so Adam steps it by +-lr along rounding noise on
        # either side: it is held within 3 such steps, the rest at 1e-3
        before_bn = {f"{i}.bias" for i, m in enumerate(net[:-1])
                     if isinstance(net[i + 1], nn.BatchNorm2d)}
        for (name, _), tm, jm in zip(net.named_parameters(),
                                     tsub.master_params, jsub.master_params):
            if name in before_bn:
                assert np.abs(tm.numpy() - np.asarray(jm)).max() \
                    <= 2 * 3 * kw["lr"]
            else:
                np.testing.assert_allclose(tm.numpy(), np.asarray(jm),
                                           rtol=1e-3, atol=1e-5)


def test_gan_step_overflow_skips_only_that_net():
    netD, netG = _gan()

    def d_loss_inf(out_r, out_f):
        return d_loss(out_r, out_f) * 1e38 * 1e38

    step = make_gan_train_step(netD, netG, *_adams(netD, netG), d_loss_inf,
                               g_loss, loss_scale="dynamic")
    real, z = map(torch.from_numpy, _data())
    d0 = [m.clone() for m in step.state.d.master_params]
    g0 = [m.clone() for m in step.state.g.master_params]
    scale0 = float(step.state.d.scaler.loss_scale)
    step(real, z)
    assert all(torch.equal(a, b)
               for a, b in zip(d0, step.state.d.master_params))
    assert any(not torch.equal(a, b)
               for a, b in zip(g0, step.state.g.master_params))
    assert float(step.state.d.scaler.loss_scale) == scale0 / 2
    assert float(step.state.g.scaler.loss_scale) == scale0
    assert int(step.state.d.step) == 0 and int(step.state.g.step) == 1


def test_gan_step_sync_to_objects():
    netD, netG = _gan()
    step = make_gan_train_step(netD, netG, *_adams(netD, netG), d_loss,
                               g_loss, loss_scale=1.0,
                               half_dtype=torch.bfloat16)
    real, z = map(torch.from_numpy, _data())
    errD, errG = step(real, z)
    assert torch.isfinite(errD) and torch.isfinite(errG)
    step.sync_to_objects()
    assert netD[0].weight.dtype == torch.bfloat16
    assert netD[1].weight.dtype == torch.float32
    assert not torch.allclose(netD[1].running_mean, torch.zeros(8))


def test_gan_step_with_dropout_discriminator():
    torch.manual_seed(13)
    netD = nn.Sequential(nn.Flatten(), nn.Linear(64, 32), nn.LeakyReLU(0.2),
                         nn.Dropout(0.5), nn.Linear(32, 1), nn.Sigmoid())
    netG = nn.Sequential(nn.Linear(ZDIM, 64), nn.Tanh(), _Reshape((1, 8, 8)))
    step = make_gan_train_step(netD, netG, *_adams(netD, netG), d_loss,
                               g_loss, loss_scale=1.0)
    real, z = map(torch.from_numpy, _data())
    for _ in range(3):
        errD, errG = step(real, z)
        assert torch.isfinite(errD) and torch.isfinite(errG)
    assert int(step.state.d.step) == 3 and int(step.state.g.step) == 3


def test_gan_step_lr_schedule_applies():
    def build(sched):
        torch.manual_seed(0)
        netD = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 1))
        netG = nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.Linear(16, 8))
        optD = FusedAdam(list(netD.parameters()), lr=1e-2)
        optG = FusedAdam(list(netG.parameters()), lr=1e-2)
        return make_gan_train_step(
            netD, netG, optD, optG,
            lambda dr, df: ((dr - 1.0) ** 2).mean() + (df ** 2).mean(),
            lambda df: ((df - 1.0) ** 2).mean(), half_dtype=None,
            loss_scale=1.0, donate_state=False, lr_schedule=sched)

    r = np.random.default_rng(1)
    real = torch.from_numpy(r.standard_normal((8, 8)).astype(np.float32))
    z = torch.from_numpy(r.standard_normal((8, 4)).astype(np.float32))

    def first_deltas(sched):
        step = build(sched)
        d0 = step.state.d.master_params[0].clone()
        g0 = step.state.g.master_params[0].clone()
        step(real, z)
        return (float((step.state.d.master_params[0] - d0).abs().max()),
                float((step.state.g.master_params[0] - g0).abs().max()))

    full_d, full_g = first_deltas(None)
    s_d, s_g = first_deltas(lambda s: torch.tensor(0.1))
    assert s_d < full_d * 0.5 and s_g < full_g * 0.5
