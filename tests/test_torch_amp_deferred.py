"""amp's deferred scale update (``amp.initialize(...,
defer_scale_update=True)``) in the port, against the JAX package's
(``tests/test_step_cache.py``'s deferred tests) and against the port's own
ordinary path.

In the deferred mode ``scale_loss`` reads nothing back: it hands the
scaler to the one optimizer, whose next ``step()`` skips on the scaler's
device overflow flag, keeps its step counts on the device and updates the
loss scale there.  So: the mode trains; a planted overflow skips on the
device, halves the scale and leaves the step count one behind, as in the
JAX package; the weights, moments and losses equal the ordinary path's bit
for bit (FusedAdam, FusedLAMB and FusedNovoGrad, which the JAX package
lets take the scale update); neither the scale nor the skip is read on
the host during an iteration; anything else keeps the ordinary path.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu import amp as jamp
from apex_tpu.amp._amp_state import _amp_state as jax_amp_state
from apex_tpu.amp._amp_state import reset as jax_reset
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch import amp
from apex_tpu_torch.amp._amp_state import _amp_state
from apex_tpu_torch.amp._amp_state import reset as port_reset
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.models import from_jax_state_dict
from apex_tpu_torch.optimizers import (FusedAdam, FusedLAMB, FusedNovoGrad,
                                       FusedSGD)

torch.set_num_threads(2)


def _data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((8, 16)).astype(np.float32),
            rng.integers(0, 4, (8,)))


def _jax_train(defer, steps=4, sabotage_at=None):
    """tests/test_step_cache.py::_small_train: O2 FusedAdam on a 16-32-4
    MLP."""
    jax_reset()
    jnn.manual_seed(7)
    model = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    sd = {k: np.asarray(v) for k, v in model.state_dict().items()}
    opt = JaxFusedAdam(list(model.parameters()), lr=1e-3)
    kw = {"defer_scale_update": True} if defer else {}
    model, opt = jamp.initialize(model, opt, opt_level="O2", verbosity=0,
                                 **kw)
    crit = jnn.CrossEntropyLoss()
    x, y = (jnp.asarray(a) for a in _data())
    losses = []
    for i in range(steps):
        loss = crit(model(x), y)
        with jamp.scale_loss(loss, opt) as scaled:
            scaled.backward()
            if sabotage_at == i:
                p16 = opt._amp_stash.all_fp16_params[0]
                p16.grad = p16.grad.at[(0,) * p16.grad.ndim].set(np.inf)
        opt.step()
        opt.zero_grad()
        losses.append(float(loss))
    scaler = jax_amp_state.loss_scalers[0]
    out = (losses, scaler.loss_scale(), int(opt.param_groups[0]["step"]))
    jax_reset()
    return sd, out


def _port_train(sd, defer, opt_cls=FusedAdam, steps=4, sabotage_at=None,
                guard=None):
    """The same loop in the port, from the JAX weights ``sd``; with
    ``guard`` the iterations run under it.  Returns (losses, scale, step
    count, unskipped, the fp16 params, the masters and the moments)."""
    port_reset()
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 4))
    from_jax_state_dict(model, sd)
    opt = opt_cls(list(model.parameters()), lr=1e-3)
    kw = {"defer_scale_update": True} if defer else {}
    model, opt = amp.initialize(model, opt, opt_level="O2", verbosity=0,
                                **kw)
    crit = torch.nn.CrossEntropyLoss()
    x, y = (torch.from_numpy(a) for a in _data())
    losses = []
    with guard() if guard is not None else contextlib.nullcontext():
        for i in range(steps):
            loss = crit(model(x), y)
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
                if sabotage_at == i:
                    p16 = opt._amp_stash.all_fp16_params[0]
                    p16.grad[(0,) * p16.grad.dim()] = float("inf")
            opt.step()
            opt.zero_grad()
            losses.append(loss.detach())
    scaler = _amp_state.loss_scalers[0]
    tensors = [p.detach().clone() for p in model.parameters()] + \
        [p.detach().clone() for p in opt.param_groups[0]["params"]] + \
        [opt.state[p][k].clone() for p in opt.param_groups[0]["params"]
         for k in ("exp_avg", "exp_avg_sq") if k in opt.state[p]]
    out = ([float(v) for v in losses], scaler.loss_scale(),
           int(opt.param_groups[0].get("step", 0)), scaler._unskipped,
           tensors)
    port_reset()
    return out


def test_deferred_mode_trains_as_the_jax_one():
    sd, (jlosses, jscale, jsteps) = _jax_train(defer=True, steps=6)
    losses, scale, steps, unskipped, _ = _port_train(sd, True, steps=6)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # 6 clean steps: the scale untouched, the clean steps counted on the
    # device
    assert scale == jscale == 2.0 ** 16
    assert unskipped == 6 and steps == jsteps == 6
    np.testing.assert_allclose(losses, jlosses, rtol=0.05)


def test_a_planted_overflow_skips_on_the_device_as_in_jax():
    sd, (jlosses, jscale, jsteps) = _jax_train(defer=True, steps=3,
                                               sabotage_at=2)
    losses, scale, steps, _, _ = _port_train(sd, True, steps=3,
                                             sabotage_at=2)
    assert scale == jscale == 2.0 ** 15
    # the skipped step does not advance the device step count
    assert steps == jsteps == 2
    np.testing.assert_allclose(losses, jlosses, rtol=0.05)


@pytest.mark.parametrize("opt_cls", [FusedAdam, FusedLAMB, FusedNovoGrad])
@pytest.mark.parametrize("sabotage_at", [None, 0, 2])
def test_deferred_equals_the_ordinary_path_bit_for_bit(opt_cls, sabotage_at):
    sd, _ = _jax_train(defer=False, steps=1)
    sync = _port_train(sd, False, opt_cls, steps=5, sabotage_at=sabotage_at)
    deferred = _port_train(sd, True, opt_cls, steps=5,
                           sabotage_at=sabotage_at)
    assert deferred[:4] == sync[:4]
    assert len(deferred[4]) == len(sync[4])
    for a, b in zip(deferred[4], sync[4]):
        assert torch.equal(a, b)
    skipped = sabotage_at is not None
    assert sync[1] == 2.0 ** (15 if skipped else 16)
    assert sync[2] == 5 - skipped


def test_deferred_iterations_read_nothing_back(monkeypatch):
    """The scale and the skip stay on the device: neither
    ``LossScaler.loss_scale`` nor ``update_scale`` (the ordinary path's
    host reads) runs in a deferred iteration."""
    sd, _ = _jax_train(defer=False, steps=1)

    @contextlib.contextmanager
    def guard():
        with monkeypatch.context() as m:
            for name in ("loss_scale", "update_scale"):
                m.setattr(LossScaler, name, _refused(name))
            yield
    losses, scale, steps, _, _ = _port_train(sd, True, steps=3,
                                             sabotage_at=1, guard=guard)
    assert steps == 2 and len(losses) == 3 and scale == 2.0 ** 15


def _refused(name):
    def fn(self, *a, **k):
        raise AssertionError(f"LossScaler.{name} read the card in a "
                             f"deferred iteration")
    return fn


def test_other_optimizers_keep_the_ordinary_path(monkeypatch):
    """FusedSGD has no ``_step_cache_scaler_ok`` (as in the JAX package):
    its scale update stays in ``scale_loss``, with the skip patch."""
    assert not getattr(FusedSGD, "_step_cache_scaler_ok", False)
    assert all(o._step_cache_scaler_ok
               for o in (FusedAdam, FusedLAMB, FusedNovoGrad))
    sd, _ = _jax_train(defer=False, steps=1)
    calls = []
    orig = LossScaler.update_scale

    def counted(self):
        calls.append(1)
        return orig(self)
    monkeypatch.setattr(LossScaler, "update_scale", counted)
    _port_train(sd, True, FusedSGD, steps=2)
    assert len(calls) == 2
