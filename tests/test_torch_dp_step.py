"""The fused step's data parallelism (``make_train_step(axis_name="data")``)
against the JAX package's ``shard_map`` step, on the CPU.

Two gloo ranks run once for the file through the port's launcher
(``tests/torch_ranks.py``); each calls the step on its half of the global
batch, and the results are compared here with the JAX step mapped over a
2-device CPU mesh (``jax.devices()[:2]``): the exchange with each of the
DDP knobs (``gradient_predivide_factor``, ``allreduce_always_fp32``),
accumulation under DP (one exchange a window), the skip when only one
rank's gradients overflow, dropout (finite losses, each rank its own
masks: masks cannot match across the packages, ROADMAP C "Random
streams"), and telemetry's loss averaged over the data axis
(``accumulate(mean_axes=("data",))``).  In this process: the axis
refusals and a world of one.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import apex_tpu.nn as jnn
from apex_tpu.nn import functional as jF
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu.runtime import step_cache as jax_step_cache
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.observe import telemetry
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.training import make_train_step

from torch_ranks import run_ranks

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _empty_jax_step_cache():
    """The JAX steps built here are emptied from the JAX step cache after
    the file, whose 128-program LRU, once full, empties the jaxpr audit's
    slices (ROADMAP C3)."""
    yield
    jax_step_cache.clear()

WORKER = r'''
from apex_tpu_torch.models import GptModel
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.observe import telemetry
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.training import make_train_step

D = dict(np.load(os.path.join(OUT, "data.npz")))


def T(name):
    return torch.from_numpy(D[name])


def mine(a):
    k = a.shape[0] // WORLD
    return a[RANK * k:(RANK + 1) * k]


def convnet():
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.ReLU(),
        torch.nn.MaxPool2d(2), torch.nn.Flatten(), torch.nn.Linear(128, 10))


def small():
    return torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                               torch.nn.Linear(8, 3))


def load(m, name):
    with torch.no_grad():
        for k, v in m.state_dict().items():
            v.copy_(torch.from_numpy(D[f"{name}/{k}"]))
    return m


def ce(out, t):
    return F.cross_entropy(out.float(), t)


def run(model, name, batch, steps, lr=0.05, momentum=0.9, **kw):
    m = load(model(), name)
    s = make_train_step(m, FusedSGD(list(m.parameters()), lr=lr,
                                    momentum=momentum), ce,
                        axis_name="data", **kw)
    losses = [float(s(*batch)) for _ in range(steps)]
    return dict(losses=losses,
                masters=[t.clone() for t in s.state.master_params],
                step=int(s.state.step)), s


res = {}
xy = (mine(T("x")), mine(T("y")))
res["dp"], _ = run(convnet, "conv", xy, 3, loss_scale=1.0)
res["dp_pre"], _ = run(convnet, "conv", xy, 3, loss_scale=1.0,
                       gradient_predivide_factor=2.0)
for fp32 in (False, True):
    res[f"dp_bf16_{fp32}"], _ = run(
        convnet, "conv", xy, 3, loss_scale=1.0, half_dtype=torch.bfloat16,
        allreduce_always_fp32=fp32)
res["dp_accum"], _ = run(small, "small", (mine(T("xs")), mine(T("ys"))), 2,
                         momentum=0.0, loss_scale=1.0, grad_accum_steps=2)

# an overflow on rank 1 only: the exchange spreads it, both ranks skip
x = xy[0].clone()
if RANK == 1:
    x[0, 0, 0, 0] = float("inf")
res["dp_skip"], s = run(convnet, "conv", (x, xy[1]), 1,
                        loss_scale="dynamic")
res["dp_skip"]["scale"] = float(s.state.scaler.loss_scale)

# dropout: the same ids on both ranks, lr 0, so only the masks differ
torch.manual_seed(3)
g = GptModel(vocab_size=64, hidden=32, layers=1, heads=2, max_positions=8,
             dropout=0.3, attn_dropout=0.0, device="cpu")
ids = T("ids")
s = make_train_step(g, FusedAdam(list(g.parameters()), lr=0.0),
                    lambda lo, t: F.cross_entropy(
                        lo[:, :-1].reshape(-1, lo.shape[-1]),
                        t[:, 1:].reshape(-1)),
                    axis_name="data", loss_scale=1.0)
res["dropout"] = [float(s(ids, ids)) for _ in range(2)]

res["telem"], s = run(convnet, "conv", xy, 2, loss_scale=1.0,
                      telemetry=True, drain_every=10)
res["telem_rec"] = s.drain_telemetry()
t = telemetry.accumulate(
    telemetry.init_telemetry(device="cpu"), loss=torch.tensor(float(RANK)),
    master_grads=[torch.ones(3)], flag=torch.zeros((), dtype=torch.int32),
    loss_scale=1.0, mean_axes=("data",))
res["mean_axes"] = float(t.loss_sum)
finish(res)
'''


def _convnet(seed=42):
    jnn.manual_seed(seed)
    return jnn.Sequential(jnn.Conv2d(3, 8, 3, padding=1), jnn.ReLU(),
                          jnn.MaxPool2d(2), jnn.Flatten(),
                          jnn.Linear(128, 10))


def _small(seed=4):
    jnn.manual_seed(seed)
    return jnn.Sequential(jnn.Linear(6, 8), jnn.ReLU(), jnn.Linear(8, 3))


def _ce(out, t):
    return jF.cross_entropy(out.astype(jnp.float32), t)


def _data():
    rng = np.random.default_rng(0)
    return dict(x=rng.standard_normal((16, 3, 8, 8)).astype(np.float32),
                y=rng.integers(0, 10, (16,)),
                xs=rng.standard_normal((16, 6)).astype(np.float32),
                ys=rng.integers(0, 3, (16,)),
                ids=rng.integers(0, 64, (2, 8)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    d = _data()
    flat = dict(d)
    for name, build in (("conv", _convnet), ("small", _small)):
        for k, v in build().state_dict().items():
            flat[f"{name}/{k}"] = np.asarray(v)
    np.savez(out / "data.npz", **flat)
    return dict(res=run_ranks(WORKER, 2, str(out)), d=d)


def _jax_dp(build, x, y, steps, lr=0.05, momentum=0.9, **kw):
    """The JAX DP step mapped over a 2-device mesh: masters, losses."""
    m = build()
    step = jax_make_train_step(m, JaxSGD(list(m.parameters()), lr=lr,
                                         momentum=momentum), _ce,
                               axis_name="data", **kw)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    sharded = jax.jit(jax.shard_map(
        step._step_fn, mesh=mesh, in_specs=(P(), P("data"), P("data")),
        out_specs=(P(), P()), check_vma=False))
    state, losses = step.state, []
    for _ in range(steps):
        state, loss = sharded(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return [np.asarray(t, np.float32) for t in state.master_params], \
        losses, state


def _masters_close(got, want, rtol, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("knob", ["dp", "dp_pre"])
def test_dp_step_matches_jax_shard_map(ranks, knob):
    """Three SGD steps on each rank's half batch: the masters of the JAX
    step mapped over 2 devices within 1e-5 (the JAX test's tolerance is
    rtol 2e-3 / atol 2e-5), with and without gradient_predivide_factor;
    rank 0's loss is the JAX step's (its first shard's), and both ranks
    hold the same masters."""
    d = ranks["d"]
    kw = dict(gradient_predivide_factor=2.0) if knob == "dp_pre" else {}
    want, losses, _ = _jax_dp(_convnet, d["x"], d["y"], 3, loss_scale=1.0,
                              **kw)
    got = [r[knob] for r in ranks["res"]]
    for g in got:
        _masters_close(g["masters"], want, 1e-5, 1e-5)
        assert g["step"] == 3
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    for a, b in zip(got[0]["masters"], got[1]["masters"]):
        assert torch.equal(a, b)


def test_dp_allreduce_always_fp32_matches_jax(ranks):
    """bf16 half copies, the exchange in fp32 (allreduce_always_fp32) and
    in bf16: the JAX step's masters for each, within bf16's tolerance (the
    two frameworks round the bf16 activations at different places, as
    ``test_torch_train.py`` says: 2e-2 relative, 2e-3 absolute after three
    SGD steps at lr 0.05), and the two exchanges likewise of each other."""
    d = ranks["d"]
    for fp32 in (False, True):
        want, _, _ = _jax_dp(_convnet, d["x"], d["y"], 3, loss_scale=1.0,
                             half_dtype=jnp.bfloat16,
                             allreduce_always_fp32=fp32)
        for r in ranks["res"]:
            _masters_close(r[f"dp_bf16_{fp32}"]["masters"], want, 2e-2, 2e-3)
    for r in ranks["res"]:
        _masters_close(r["dp_bf16_True"]["masters"],
                       [t.numpy() for t in r["dp_bf16_False"]["masters"]],
                       2e-2, 2e-3)


def test_dp_accumulation_exchanges_once_a_window(ranks):
    """accum_steps=2 under DP: the JAX step's masters (its exchange after
    the scan) within 1e-5, two applied steps on both ranks."""
    d = ranks["d"]
    want, _, state = _jax_dp(_small, d["xs"], d["ys"], 2, momentum=0.0,
                             loss_scale=1.0, grad_accum_steps=2)
    assert int(state.step) == 2
    for r in ranks["res"]:
        _masters_close(r["dp_accum"]["masters"], want, 1e-5, 1e-5)
        assert r["dp_accum"]["step"] == 2


def test_dp_overflow_on_one_rank_skips_on_both(ranks):
    """A non-finite input on rank 1 only: the exchanged gradients are
    non-finite on both ranks, so both skip the step and halve the scale."""
    for r in ranks["res"]:
        assert r["dp_skip"]["step"] == 0
        assert r["dp_skip"]["scale"] == 2.0 ** 15


def test_dp_dropout_draws_each_ranks_own_masks(ranks):
    """Dropout under DP: finite losses; the same ids and lr 0 on both
    ranks give other losses, since the rank is folded into each forward's
    dropout seed (the JAX step folds the axis index)."""
    a, b = (r["dropout"] for r in ranks["res"])
    assert np.isfinite(a + b).all()
    assert a[0] != b[0] and a[1] != b[1]


def test_dp_telemetry_averages_the_loss_over_the_data_axis(ranks):
    """telemetry under DP: the drained loss is the mean over both ranks
    of their mean losses, the gradient norm the same on both;
    accumulate(mean_axes=("data",)) averages a loss over the ranks."""
    recs = [r["telem_rec"] for r in ranks["res"]]
    want = np.mean([np.mean(r["telem"]["losses"]) for r in ranks["res"]])
    for rec in recs:
        np.testing.assert_allclose(rec["loss_mean"], want, rtol=1e-6)
        assert rec["windows"] == 2
    assert recs[0]["grad_norm"] == recs[1]["grad_norm"]
    assert [r["mean_axes"] for r in ranks["res"]] == [0.5, 0.5]


def test_dp_axis_refusals_and_world_of_one():
    """Only the data axis is ported: another name, a tuple of two axes and
    tp_axis raise naming ROADMAP A9; without torch.distributed the world
    is this process, and the DP step is the plain step, bit for bit."""
    torch.manual_seed(0)

    def pair():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 3))
        return m, FusedSGD(list(m.parameters()), lr=0.1, momentum=0.9)
    m, opt = pair()
    loss = lambda o, t: F.cross_entropy(o, t)  # noqa: E731
    for kw in (dict(axis_name="model"), dict(axis_name=("data", "model")),
               dict(tp_axis="model"), dict(parallel="auto")):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            make_train_step(m, opt, loss, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        telemetry.accumulate(telemetry.init_telemetry(device="cpu"),
                             loss=None, master_grads=[], flag=None,
                             loss_scale=1.0, mean_axes=("model",))
    x, y = torch.randn(8, 6), torch.randint(0, 3, (8,))
    dp = make_train_step(m, opt, loss, axis_name=("data",), loss_scale=1.0,
                         gradient_predivide_factor=2.0,
                         allreduce_always_fp32=True)
    m2, opt2 = pair()
    plain = make_train_step(m2, opt2, loss, loss_scale=1.0)
    assert [float(dp(x, y)) for _ in range(2)] \
        == [float(plain(x, y)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(
        dp.state.master_params, plain.state.master_params))
