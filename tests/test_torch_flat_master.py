"""``make_train_step(flat_master=True)``: masters and slots stacked per
(group, shape, dtype) bucket, each group's update one kernel launch over
its stacks, the forward reading each parameter's row.

On the CPU the flat step equals the port's per-tensor step bit for bit
(its products memoised on their operands' values, ``torch_products``):
Adam and SGD, fp32 and bf16 half copies with BatchNorm's kept fp32, the
dynamic scale's skip, accumulation, two param groups, an lr schedule, a
checkpoint round trip, telemetry and ``rollout.master_leaves``; and it
meets the JAX package's flat step within the JAX test's tolerances.  Two
gloo ranks (``tests/torch_ranks.py``, once for the file) run it under DP
with SyncBatchNorm, against the JAX flat step on the full batch.  The JAX
refusals (LAMB, a frozen parameter, ZeRO) raise as there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.nn import functional as jF
from apex_tpu.optimizers import FusedAdam as JaxAdam, FusedSGD as JaxSGD
from apex_tpu.runtime import step_cache as jax_step_cache
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch import rollout
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD, \
    warmup_cosine
from apex_tpu_torch.training import make_train_step
from apex_tpu_torch.utils.checkpoint import restore_train_state, \
    save_train_state

from torch_products import value_products
from torch_ranks import run_ranks

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _empty_jax_step_cache():
    """The JAX steps built here are emptied from the JAX step cache after
    the file, whose 128-program LRU, once full, empties the jaxpr audit's
    slices (ROADMAP C3)."""
    yield
    jax_step_cache.clear()


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(8)
        self.fc = torch.nn.Linear(8 * 4 * 4, 5)

    def forward(self, x):
        h = torch.relu(self.bn(self.c(x)))
        return self.fc(h.reshape(h.shape[0], -1))


class JaxNet(jnn.Module):
    def __init__(self):
        super().__init__()
        self.c = jnn.Conv2d(3, 8, 3, padding=1)
        self.bn = jnn.BatchNorm2d(8)
        self.fc = jnn.Linear(8 * 4 * 4, 5)

    def forward(self, ctx, x):
        h = jF.relu(self.bn.forward(ctx, self.c.forward(ctx, x)))
        return self.fc.forward(ctx, h.reshape(h.shape[0], -1))


def _jax_net(seed=11):
    jnn.manual_seed(seed)
    return JaxNet()


def _net(seed=11):
    """The port's Net with the JAX Net's weights."""
    m = Net()
    sd = _jax_net(seed).state_dict()
    with torch.no_grad():
        for k, v in m.state_dict().items():
            v.copy_(torch.from_numpy(np.array(sd[k])))
    return m


def _loss(out, y):
    return F.cross_entropy(out.float(), y)


def _jloss(out, y):
    return jF.cross_entropy(out.astype(jnp.float32), y)


def _data(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3, 4, 4)).astype(np.float32), \
        rng.integers(0, 5, (n,))


def _run(flat, opt_fn, steps, n=4, seed=11, **kw):
    """A port step's losses, synced parameters and the step."""
    m = _net(seed)
    s = make_train_step(m, opt_fn(m), _loss, flat_master=flat, **kw)
    x, y = (torch.from_numpy(a) for a in _data(n))
    with value_products():
        losses = [float(s(x, y)) for _ in range(steps)]
    s.sync_to_objects()
    return losses, [p.detach().float().clone() for p in m.parameters()], s


OPTS = {"sgd": (lambda m: FusedSGD(list(m.parameters()), lr=0.1,
                                   momentum=0.9, weight_decay=1e-4),
                lambda m: JaxSGD(list(m.parameters()), lr=0.1, momentum=0.9,
                                 weight_decay=1e-4)),
        "adam": (lambda m: FusedAdam(list(m.parameters()), lr=1e-3,
                                     weight_decay=0.01),
                 lambda m: JaxAdam(list(m.parameters()), lr=1e-3,
                                   weight_decay=0.01))}


def _same(a, b):
    assert a[0] == b[0]
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("half", [None, "bfloat16"])
def test_flat_matches_per_tensor_and_jax(opt, half):
    """Four steps: the flat step's losses and synced parameters equal the
    per-tensor step's bit for bit, and meet the JAX flat step's: losses
    within the JAX test's tolerances (fp32 rtol 5e-4 / atol 1e-6, bf16 1e-2
    / 2e-3), SGD's parameters too; Adam moves a parameter by about lr a
    step whatever the size of its gradient, so a near-zero gradient whose
    sign differs between the packages parts the two by up to 2 lr a step
    (``test_torch_train.py``'s bound: 8 lr over 4 steps), and the rest
    agree to the tolerance."""
    hd = None if half is None else torch.bfloat16
    flat = _run(True, OPTS[opt][0], 4, half_dtype=hd, loss_scale=1.0)
    _same(flat, _run(False, OPTS[opt][0], 4, half_dtype=hd, loss_scale=1.0))
    jm = _jax_net()
    js = jax_make_train_step(jm, OPTS[opt][1](jm), _jloss,
                             half_dtype=None if half is None
                             else jnp.bfloat16, loss_scale=1.0,
                             flat_master=True)
    x, y = (jnp.asarray(a) for a in _data())
    want = [float(js(x, y)) for _ in range(4)]
    js.sync_to_objects()
    tol = dict(rtol=5e-4, atol=1e-6) if half is None \
        else dict(rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(flat[0], want, **tol)
    got = np.concatenate([a.numpy().ravel() for a in flat[1]])
    ref = np.concatenate([np.asarray(p.data, np.float32).ravel()
                          for p in jm.parameters()])
    if opt == "sgd":
        np.testing.assert_allclose(got, ref, **tol)
    else:
        diff = np.abs(got - ref)
        assert diff.max() <= 8 * 1e-3
        assert (diff <= tol["atol"] + tol["rtol"] * np.abs(ref)).mean() \
            >= 0.99, (diff > tol["atol"]).sum()
    # the layout: one stack a (group, shape, dtype) bucket, the rows views
    st = flat[2].state
    shapes = [tuple(t.shape) for t in st.master_params]
    if half is None:
        # c.bias, bn.weight and bn.bias share a (group, shape, dtype)
        assert shapes == [(1, 8, 3, 3, 3), (3, 8), (1, 5, 128), (1, 5)]
        assert all(h is None for h in st.model_params)
    else:
        # BatchNorm's parameters stay fp32: a bucket of their own
        assert shapes == [(1, 8, 3, 3, 3), (1, 8), (2, 8), (1, 5, 128),
                          (1, 5)]
        assert [h is None for h in st.model_params] == \
            [False, False, True, False, False]


def test_flat_dynamic_scaler_skip():
    """An overflowing loss trips the flag and skips the flat update as on
    the per-tensor path: masters unchanged, scale halved, step 0."""
    m = _net()
    s = make_train_step(m, OPTS["sgd"][0](m),
                        lambda o, y: _loss(o, y) * 1e38 * 1e38,
                        half_dtype=torch.bfloat16, loss_scale="dynamic",
                        flat_master=True)
    before = [t.clone() for t in s.state.master_params]
    x, y = (torch.from_numpy(a) for a in _data())
    s(x, y)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 s.state.master_params))
    assert float(s.state.scaler.loss_scale) == 2.0 ** 15
    assert int(s.state.step) == 0


def test_flat_grad_accum_matches():
    _same(_run(True, OPTS["adam"][0], 3, n=8, loss_scale=1.0,
               grad_accum_steps=2),
          _run(False, OPTS["adam"][0], 3, n=8, loss_scale=1.0,
               grad_accum_steps=2))


def test_flat_multi_group_hyperparams():
    """Two groups, each lr and weight decay its own through the stacks
    (one launch a group)."""
    def opt(m):
        ps = list(m.parameters())
        return FusedSGD([{"params": ps[:2], "lr": 0.05},
                         {"params": ps[2:], "lr": 0.2,
                          "weight_decay": 1e-3}], lr=0.1, momentum=0.9)
    flat = _run(True, opt, 3, loss_scale=1.0)
    _same(flat, _run(False, opt, 3, loss_scale=1.0))
    assert [b[0] for b in flat[2]._flat_meta.buckets] == [0, 0, 1, 1, 1]


def test_flat_with_lr_schedule_matches():
    sched = warmup_cosine(2, 10)
    _same(_run(True, OPTS["adam"][0], 4, loss_scale=1.0, lr_schedule=sched),
          _run(False, OPTS["adam"][0], 4, loss_scale=1.0,
               lr_schedule=sched))


def test_flat_refusals():
    m = _net()
    with pytest.raises(TypeError, match="trust ratio"):
        make_train_step(m, FusedLAMB(list(m.parameters()), lr=1e-3), _loss,
                        flat_master=True)
    with pytest.raises(ValueError, match="param_group"):
        make_train_step(m, FusedSGD(list(m.parameters())[:-1], lr=0.1),
                        _loss, flat_master=True)
    with pytest.raises(ValueError, match="zero_sharding"):
        make_train_step(m, FusedSGD(list(m.parameters()), lr=0.1), _loss,
                        flat_master=True, zero_sharding=True)


def test_flat_state_checkpoint_roundtrip(tmp_path):
    """save_train_state / restore_train_state of the stacked state:
    training resumes bit for bit."""
    x, y = (torch.from_numpy(a) for a in _data())
    m = _net()
    s = make_train_step(m, OPTS["sgd"][0](m), _loss,
                        half_dtype=torch.bfloat16, loss_scale=1.0,
                        flat_master=True)
    with value_products():
        s(x, y)
        save_train_state(str(tmp_path / "flat"), s)
        want = float(s(x, y))
        m2 = _net()
        s2 = make_train_step(m2, OPTS["sgd"][0](m2), _loss,
                             half_dtype=torch.bfloat16, loss_scale=1.0,
                             flat_master=True)
        restore_train_state(str(tmp_path / "flat"), s2)
        assert int(s2.state.step) == 1
        assert float(s2(x, y)) == want


def test_flat_telemetry_and_master_leaves():
    """Telemetry over the stacks: the per-tensor step's loss, a gradient
    norm within fp32 rounding of it; ``rollout.master_leaves`` gives each
    parameter's row of its stack (a view), equal to the per-tensor
    masters."""
    flat = _run(True, OPTS["adam"][0], 2, loss_scale=1.0, telemetry=True,
                drain_every=10)
    per = _run(False, OPTS["adam"][0], 2, loss_scale=1.0, telemetry=True,
               drain_every=10)
    a, b = flat[2].drain_telemetry(), per[2].drain_telemetry()
    assert a["loss_mean"] == b["loss_mean"]
    np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-6)
    leaves = rollout.master_leaves(flat[2])
    assert all(torch.equal(x, y) for x, y in zip(
        leaves, rollout.master_leaves(per[2])))
    bid, j = flat[2]._flat_meta.pos[0]
    assert leaves[0].data_ptr() == \
        flat[2].state.master_params[bid][j].data_ptr()


WORKER = r'''
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.training import make_train_step

D = dict(np.load(os.path.join(OUT, "data.npz")))


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(8)
        self.fc = torch.nn.Linear(8 * 4 * 4, 5)

    def forward(self, x):
        h = torch.relu(self.bn(self.c(x)))
        return self.fc(h.reshape(h.shape[0], -1))


m = Net()
with torch.no_grad():
    for k, v in m.state_dict().items():
        v.copy_(torch.from_numpy(D[k]))
m = parallel.convert_syncbn_model(m)
s = make_train_step(m, FusedSGD(list(m.parameters()), lr=0.1, momentum=0.9),
                    lambda o, y: F.cross_entropy(o, y), loss_scale=1.0,
                    flat_master=True, axis_name="data")
x, y = torch.from_numpy(D["x"]), torch.from_numpy(D["y"])
k = x.shape[0] // WORLD
losses = [float(s(x[RANK * k:(RANK + 1) * k], y[RANK * k:(RANK + 1) * k]))
          for _ in range(3)]
finish(dict(losses=losses, masters=[t.clone()
                                    for t in s.state.master_params]))
'''


def test_flat_under_dp_matches_the_full_batch(tmp_path):
    """flat_master under DP (the gradients exchanged per tensor before the
    stack) with SyncBatchNorm on two ranks of 4 rows: the first bucket of
    the JAX flat step on the full 8-row batch, rtol 2e-5 / atol 1e-6, on
    both ranks."""
    x, y = _data(8, seed=1)
    sd = {k: np.asarray(v) for k, v in _jax_net().state_dict().items()}
    np.savez(tmp_path / "data.npz", x=x, y=y, **sd)
    ranks = run_ranks(WORKER, 2, str(tmp_path))
    jm = _jax_net()
    js = jax_make_train_step(jm, JaxSGD(list(jm.parameters()), lr=0.1,
                                        momentum=0.9), _jloss,
                             loss_scale=1.0, flat_master=True)
    for _ in range(3):
        js(jnp.asarray(x), jnp.asarray(y))
    for r in ranks:
        np.testing.assert_allclose(r["masters"][0].numpy(),
                                   np.asarray(js.state.master_params[0]),
                                   rtol=2e-5, atol=1e-6)
        assert all(np.isfinite(r["losses"]))
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["masters"],
                                                 ranks[1]["masters"]))
