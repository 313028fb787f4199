"""ZeRO (``parallel/zero.py``) against the JAX package's, on the CPU.

The port's ranks run once for the file over gloo through the port's
launcher (``tests/torch_ranks.py``): two ranks for every case, and four
once for the shard rule's indivisible dims.  Each case builds
``make_train_step(..., zero_sharding=True)`` from the JAX model's weights
and feeds every rank the same global batch; its results are compared here
with the JAX ZeRO step on a CPU mesh of the same size
(``jax.devices()[:n]``), within the JAX tests' own tolerances (loss 1e-5,
parameters rtol 2e-5 / atol 2e-6 after 5 steps): stages 0, 1 and 3, bf16
half copies with a dynamic scale, accumulation with a schedule, a scalar
tail argument, a BatchNorm model (global-batch statistics), the skip when
only one rank's shard overflows, a summed loss (the port's gradients
``1/n`` of the JAX step's), the layout and ``shard_sizes()``, the gather
overlap knob on and off (bit for bit), telemetry, and a JAX schema-3
checkpoint restored into the port's step; the port's own checkpoint round
trips.  In this process: the refusals and the placements of a world of
one.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import apex_tpu.nn as jnn
from apex_tpu.nn import functional as jF
from apex_tpu.optimizers import FusedAdam as JaxAdam, FusedSGD as JaxSGD, \
    warmup_linear as jax_warmup_linear
from apex_tpu.runtime.resilience import CheckpointManager as JaxCkpt
from apex_tpu.runtime import step_cache as jax_step_cache
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import ZeroTrainStep, zero_state_sharding
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
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD, warmup_linear
from apex_tpu_torch.parallel import zero_state_sharding
from apex_tpu_torch.runtime.resilience import CheckpointManager
from apex_tpu_torch.training import make_train_step
from apex_tpu_torch.utils.checkpoint import (restore_train_state,
                                             save_train_state)

D = dict(np.load(os.path.join(OUT, "data.npz")))


def T(name):
    return torch.from_numpy(D[name])


def mlp():
    return torch.nn.Sequential(torch.nn.Linear(16, 64), torch.nn.ReLU(),
                               torch.nn.Linear(64, 8))


def narrow():
    return torch.nn.Sequential(torch.nn.Linear(16, 6), torch.nn.ReLU(),
                               torch.nn.Linear(6, 4), torch.nn.ReLU(),
                               torch.nn.Linear(4, 2))


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(8)
        self.fc = torch.nn.Linear(8 * 4 * 4, 5)

    def forward(self, x):
        h = torch.relu(self.bn(self.c(x)))
        return self.fc(h.reshape(h.shape[0], -1))


def load(m, name):
    with torch.no_grad():
        for k, v in m.state_dict().items():
            v.copy_(torch.from_numpy(D[f"{name}/{k}"]))
    return m


def ce(out, t):
    return F.cross_entropy(out.float(), t)


def adam(lr):
    return lambda m: FusedAdam(list(m.parameters()), lr=lr)


def build(model, name, opt, loss=ce, **kw):
    m = load(model(), name)
    return m, make_train_step(m, opt(m), loss, zero_sharding=True, **kw)


def run(model, name, opt, batch, steps, loss=ce, **kw):
    m, s = build(model, name, opt, loss, **kw)
    losses = [float(s(*batch)) for _ in range(steps)]
    s.sync_to_objects()
    return dict(losses=losses,
                params=[p.detach().float().clone() for p in m.parameters()],
                buffers=[b.detach().clone() for b in m.buffers()]), s


def layout(s):
    st = s.state
    return dict(masters=[tuple(t.shape) for t in st.master_params],
                m=[tuple(t.shape) for t in st.opt_state.get("m", [])],
                halves=[None if h is None else tuple(h.shape)
                        for h in st.model_params],
                placements=[str(p) for p in s.shardings.master_params],
                half_placements=[str(p) for p in s.shardings.model_params],
                sizes=s.shard_sizes(), n=s.n, rank=s.rank)


res = {}
xy = (T("x"), T("y"))
if WORLD == 4:
    for k in (1, 3):
        res[f"narrow{k}"], s = run(narrow, "narrow", adam(1e-2), xy, 3,
                                   loss_scale=1.0, zero_stage=k)
        res[f"narrow{k}_layout"] = layout(s)
    finish(res)
    sys.exit(0)

for k in (0, 1, 3):
    res[f"s{k}"], s = run(mlp, "mlp", adam(1e-2), xy, 5, loss_scale=1.0,
                          zero_stage=k)
    res[f"s{k}_layout"] = layout(s)
mesh_sh = zero_state_sharding(s.state, s.mesh, "data", stage=1)
res["placements"] = [str(p) for p in mesh_sh.master_params]
xy64 = (T("x64"), T("y64"))
res["bf16_dyn"], s = run(mlp, "mlp", adam(5e-3), xy64, 16,
                         half_dtype=torch.bfloat16, loss_scale="dynamic")
res["bf16_dyn_layout"] = layout(s)
for k in (1, 3):
    res[f"bf16_s{k}"], s = run(mlp, "mlp", adam(5e-3), xy64, 5,
                               half_dtype=torch.bfloat16, loss_scale=1.0,
                               zero_stage=k)
    res[f"bf16_s{k}_layout"] = layout(s)
res["accum"], _ = run(mlp, "mlp", adam(1e-2), xy, 4, loss_scale=1.0,
                      grad_accum_steps=2, lr_schedule=warmup_linear(2, 20))
res["tail"], _ = run(mlp, "mlp", adam(1e-2), xy + (torch.tensor(0.5),), 2,
                     loss=lambda o, t, w: ce(o, t) * w, loss_scale=1.0)
sgd = lambda m: FusedSGD(list(m.parameters()), lr=0.1, momentum=0.9)
res["bn"], _ = run(Net, "net", sgd, (T("xb"), T("yb")), 3, loss_scale=1.0)

# one rank's shard overflows: rows 4-7 of the weight and the bias are rank
# 1's, and only their gradients are scaled past fp32's range
m, s = build(lambda: torch.nn.Linear(16, 8), "lin", adam(1e-2),
             loss=lambda o, c: (o * c).sum(), loss_scale="dynamic")
before = [t.clone() for t in s.state.master_params]
s(T("x"), T("c"))
res["skip"] = dict(
    same=[torch.equal(a, b) for a, b in zip(before, s.state.master_params)],
    scale=float(s.state.scaler.loss_scale), step=int(s.state.step),
    overflow=int(s.state.scaler.overflow))

# a summed loss: each rank sums its rows, the ranks' gradients and losses
# are averaged, so one plain SGD step moves 1/n of the JAX step's move
res["sum"], _ = run(mlp, "mlp",
                    lambda m: FusedSGD(list(m.parameters()), lr=0.01), xy, 1,
                    loss=lambda o, t: ce(o, t) * o.shape[0], loss_scale=1.0)

# the gather overlap knob on and off: the same bits
for k, half in ((3, torch.bfloat16), (1, None)):
    for ov in (False, True):
        res[f"ov{k}_{ov}"], _ = run(mlp, "mlp", adam(1e-2), xy, 3,
                                    half_dtype=half, loss_scale=1.0,
                                    zero_stage=k, grad_accum_steps=2,
                                    overlap=ov)

# the collectives of one window, counted where the step calls them
NAMES = ("reduce_scatter_tensor", "all_gather_into_tensor", "all_reduce")
real = {n: getattr(dist, n) for n in NAMES}
calls = {}


def counter(n):
    def call(*a, **k):
        calls[n] = calls.get(n, 0) + 1
        return real[n](*a, **k)
    return call


res["collectives"] = {}
for k, acc in ((0, 1), (1, 1), (3, 1), (1, 2), (3, 2)):
    m, s = build(mlp, "mlp", adam(1e-2), half_dtype=torch.bfloat16,
                 loss_scale=1.0, zero_stage=k, grad_accum_steps=acc)
    s(*xy)
    calls.clear()
    for n in NAMES:
        setattr(dist, n, counter(n))
    try:
        s(*xy)
    finally:
        for n in NAMES:
            setattr(dist, n, real[n])
    res["collectives"][(k, acc)] = dict(calls)

res["telem"], s = run(mlp, "mlp", adam(1e-2), xy, 2, loss_scale=1.0,
                      telemetry=True, drain_every=10)
res["telem_rec"] = s.drain_telemetry()

# a JAX ZeRO checkpoint (2 steps on a 2-device mesh) restored here
m, s = build(mlp, "mlp", adam(1e-2), loss_scale=1.0)
step_no, _ = CheckpointManager(ARGS[0]).restore_resharded(s)
res["ckpt_jax"] = dict(step_no=step_no, count=int(s.state.step),
                       losses=[float(s(*xy)) for _ in range(2)])
s.sync_to_objects()
res["ckpt_jax"]["params"] = [p.detach().clone() for p in m.parameters()]

# the port's own round trips: CheckpointManager and save_train_state
ck = os.path.join(OUT, "port_ckpt")
m, s = build(mlp, "mlp", adam(1e-2), loss_scale=1.0, zero_stage=3,
             half_dtype=torch.bfloat16)
s(*xy)
mgr = CheckpointManager(ck)
mgr.save_sharded(1, s)
save_train_state(os.path.join(OUT, "port_state"), s)
want = [float(s(*xy)) for _ in range(2)]
got = []
for restore in ("manager", "train_state"):
    _, s2 = build(mlp, "mlp", adam(1e-2), loss_scale=1.0, zero_stage=3,
                  half_dtype=torch.bfloat16)
    if restore == "manager":
        mgr.restore_resharded(s2)
    else:
        restore_train_state(os.path.join(OUT, "port_state"), s2)
    got.append([float(s2(*xy)) for _ in range(2)])
    got.append(all(torch.equal(a, b) for a, b in zip(
        s.state.master_params, s2.state.master_params)))
res["ckpt_port"] = dict(want=want, got=got)
finish(res)
'''


def _mlp(seed=11):
    jnn.manual_seed(seed)
    return jnn.Sequential(jnn.Linear(16, 64), jnn.ReLU(), jnn.Linear(64, 8))


def _narrow(seed=12):
    jnn.manual_seed(seed)
    return jnn.Sequential(jnn.Linear(16, 6), jnn.ReLU(), jnn.Linear(6, 4),
                          jnn.ReLU(), jnn.Linear(4, 2))


def _lin(seed=13):
    jnn.manual_seed(seed)
    return jnn.Linear(16, 8)


class _Net(jnn.Module):
    def __init__(self):
        super().__init__()
        self.c = jnn.Conv2d(3, 8, 3, padding=1)
        self.bn = jnn.BatchNorm2d(8)
        self.fc = jnn.Linear(8 * 4 * 4, 5)

    def forward(self, ctx, x):
        h = jF.relu(self.bn.forward(ctx, self.c.forward(ctx, x)))
        return self.fc.forward(ctx, h.reshape(h.shape[0], -1))


def _net(seed=14):
    jnn.manual_seed(seed)
    return _Net()


MODELS = {"mlp": _mlp, "narrow": _narrow, "lin": _lin, "net": _net}


def _data():
    rng = np.random.default_rng(0)
    d = dict(x=rng.standard_normal((32, 16)).astype(np.float32),
             y=rng.integers(0, 8, (32,)),
             x64=rng.standard_normal((64, 16)).astype(np.float32),
             y64=rng.integers(0, 8, (64,)),
             xb=rng.standard_normal((8, 3, 4, 4)).astype(np.float32),
             yb=rng.integers(0, 5, (8,)))
    # the loss's weights: columns 4-7 (rank 1's rows of the weight) huge
    d["c"] = np.where(np.arange(8) < 4, 1.0, 1e35).astype(np.float32)
    return d


def _ce(out, t):
    return jF.cross_entropy(out.astype(jnp.float32), t)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _jax_run(name, opt, batch, steps, n=2, loss=_ce, **kw):
    """The JAX ZeRO step on an n-device mesh: losses, parameters, buffers
    and the step."""
    m = MODELS[name]()
    s = jax_make_train_step(m, opt(m), loss, zero_sharding=True,
                            zero_mesh=_mesh(n), **kw)
    losses = [float(s(*batch)) for _ in range(steps)]
    s.sync_to_objects()
    sd = m.state_dict()
    return dict(losses=losses,
                params=[np.asarray(p.data, np.float32)
                        for p in m.parameters()],
                buffers={k: np.asarray(v) for k, v in sd.items()
                         if "running" in k}), s


def _jadam(lr):
    return lambda m: JaxAdam(list(m.parameters()), lr=lr)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two-rank and four-rank runs, and the JAX checkpoint and
    reference they restore and continue."""
    out = tmp_path_factory.mktemp("zero")
    d = _data()
    flat = dict(d)
    for name, build in MODELS.items():
        for k, v in build().state_dict().items():
            flat[f"{name}/{k}"] = np.asarray(v)
    np.savez(out / "data.npz", **flat)
    # the JAX side of the checkpoint case: 2 steps, a save, 2 more
    m = _mlp()
    js = jax_make_train_step(m, _jadam(1e-2)(m), _ce, loss_scale=1.0,
                             zero_sharding=True, zero_mesh=_mesh(2))
    x, y = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    for _ in range(2):
        js(x, y)
    JaxCkpt(str(out / "jax_ckpt")).save_sharded(2, js)
    cont = [float(js(x, y)) for _ in range(2)]
    js.sync_to_objects()
    jax_ckpt = dict(losses=cont, params=[np.asarray(p.data)
                                         for p in m.parameters()])
    two = run_ranks(WORKER, 2, str(out), str(out / "jax_ckpt"))
    four_dir = out / "four"
    four_dir.mkdir()
    np.savez(four_dir / "data.npz", **flat)
    four = run_ranks(WORKER, 4, str(four_dir))
    return dict(two=two, four=four, d=d, jax_ckpt=jax_ckpt)


def _close_run(got, want, loss_tol=1e-5, rtol=2e-5, atol=2e-6):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=loss_tol)
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol)


def _xy(d, x="x", y="y"):
    return jnp.asarray(d[x]), jnp.asarray(d[y])


@pytest.mark.parametrize("stage", [0, 1, 3])
def test_zero_stages_match_jax_zero_and_unsharded(ranks, stage):
    """5 steps of fp32 Adam at each stage on two ranks: the JAX ZeRO step
    on a 2-device mesh within loss 1e-5 and params rtol 2e-5 / atol 2e-6,
    and so the unsharded JAX step; both ranks hold the same values."""
    d = ranks["d"]
    want, _ = _jax_run("mlp", _jadam(1e-2), _xy(d), 5, loss_scale=1.0,
                       zero_stage=stage)
    m = _mlp()
    ref = jax_make_train_step(m, _jadam(1e-2)(m), _ce, loss_scale=1.0)
    ref_losses = [float(ref(*_xy(d))) for _ in range(5)]
    ref.sync_to_objects()
    for r in ranks["two"]:
        _close_run(r[f"s{stage}"], want)
        _close_run(r[f"s{stage}"], dict(
            losses=ref_losses,
            params=[np.asarray(p.data) for p in m.parameters()]))
    for a, b in zip(ranks["two"][0][f"s{stage}"]["params"],
                    ranks["two"][1][f"s{stage}"]["params"]):
        assert torch.equal(a, b)


def test_zero_layout_and_shard_sizes_match_jax(ranks):
    """Masters and slots shard on dim 0 (each rank half the rows), stage 1
    keeps the half copies whole and stage 3 shards them, stage 0 keeps
    everything whole; ``shard_sizes()`` equals the JAX step's per-device
    bytes on the same mesh size."""
    d = ranks["d"]
    for r, res in enumerate(ranks["two"]):
        lay = res["s1_layout"]
        assert lay["n"] == 2 and lay["rank"] == r
        assert lay["masters"] == [(32, 16), (32,), (4, 64), (4,)]
        assert lay["m"] == lay["masters"]
        assert lay["placements"] == ["S(0)"] * 4 == res["placements"]
        assert res["s0_layout"]["masters"] == [(64, 16), (64,), (8, 64),
                                               (8,)]
        assert res["s0_layout"]["placements"] == ["R"] * 4
        assert res["bf16_s1_layout"]["halves"] == [(64, 16), (64,),
                                                   (8, 64), (8,)]
        assert res["bf16_s3_layout"]["halves"] == lay["masters"]
        assert res["bf16_s3_layout"]["sizes"] \
            < res["bf16_s1_layout"]["sizes"]
        for key, stage, half in (("s0_layout", 0, None),
                                 ("s1_layout", 1, None),
                                 ("bf16_s1_layout", 1, jnp.bfloat16),
                                 ("bf16_s3_layout", 3, jnp.bfloat16)):
            _, js = _jax_run("mlp", _jadam(1e-2), _xy(d), 1, loss_scale=1.0,
                             zero_stage=stage, half_dtype=half)
            assert res[key]["sizes"] == js.shard_sizes(), key


def test_zero_indivisible_dims_replicate_on_four_ranks(ranks):
    """Four ranks: a dim 0 of 6 (not divisible) or 2 (under 4) stays
    whole; 4 shards one row a rank; stages 1 and 3 match the JAX step on a
    4-device mesh."""
    d = ranks["d"]
    for r, res in enumerate(ranks["four"]):
        lay = res["narrow1_layout"]
        assert lay["n"] == 4 and lay["rank"] == r
        assert lay["placements"] == ["R", "R", "S(0)", "S(0)", "R", "R"]
        assert lay["masters"] == [(6, 16), (6,), (1, 6), (1,), (2, 4),
                                  (2,)]
        for k in (1, 3):
            want, js = _jax_run("narrow", _jadam(1e-2), _xy(d), 3, n=4,
                                loss_scale=1.0, zero_stage=k)
            _close_run(res[f"narrow{k}"], want)
            assert res[f"narrow{k}_layout"]["sizes"] == js.shard_sizes()


def test_zero_bf16_dynamic_scale_trains_with_whole_half_copies(ranks):
    """bf16 half copies and the dynamic scaler under ZeRO: the loss falls,
    the JAX step's losses within bf16's tolerance, the half copies whole
    (stage 1)."""
    d = ranks["d"]
    want, _ = _jax_run("mlp", _jadam(5e-3), _xy(d, "x64", "y64"), 16,
                       half_dtype=jnp.bfloat16, loss_scale="dynamic")
    for res in ranks["two"]:
        got = res["bf16_dyn"]["losses"]
        assert np.isfinite(got).all() and got[-1] < got[0]
        np.testing.assert_allclose(got, want["losses"], rtol=2e-2)
        assert all(h == s for h, s in zip(
            res["bf16_dyn_layout"]["halves"], [(64, 16), (64,), (8, 64),
                                               (8,)]))


def test_zero_stage3_matches_stage1(ranks):
    """Stage 3 is a layout change: the same losses and parameters as stage
    1 in bf16 (the JAX test's tolerance), and the JAX stage-3 step's."""
    d = ranks["d"]
    want, _ = _jax_run("mlp", _jadam(5e-3), _xy(d, "x64", "y64"), 5,
                       half_dtype=jnp.bfloat16, loss_scale=1.0, zero_stage=3)
    for res in ranks["two"]:
        s1, s3 = res["bf16_s1"], res["bf16_s3"]
        np.testing.assert_allclose(s3["losses"], s1["losses"], rtol=0,
                                   atol=1e-6)
        for a, b in zip(s3["params"], s1["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(s3["losses"], want["losses"], rtol=2e-2)


def test_zero_accumulation_and_schedule_match_jax(ranks):
    """accum_steps=2 with warmup_linear under ZeRO: one collective pair a
    window; the JAX step's losses and parameters within its tolerances."""
    d = ranks["d"]
    want, _ = _jax_run("mlp", _jadam(1e-2), _xy(d), 4, loss_scale=1.0,
                       grad_accum_steps=2, lr_schedule=jax_warmup_linear(2, 20))
    for res in ranks["two"]:
        _close_run(res["accum"], want)


def test_zero_broadcasts_scalar_tail_args(ranks):
    """A 0-d loss argument is broadcast to every rank, not split."""
    d = ranks["d"]
    want, _ = _jax_run("mlp", _jadam(1e-2), _xy(d) + (jnp.float32(0.5),), 2,
                       loss=lambda o, t, w: _ce(o, t) * w, loss_scale=1.0)
    for res in ranks["two"]:
        _close_run(res["tail"], want)


def test_zero_summed_loss_is_one_nth_of_the_jax_step(ranks):
    """A loss summed over the rows: the JAX global-view step sums the
    global batch, the port sums each rank's rows and averages over the
    ranks, so on two ranks its loss and the move of one plain SGD step are
    half the JAX step's (ZeroTrainStep's stated condition: only a mean
    over rows with equal weight is the JAX step's loss)."""
    d = ranks["d"]
    sgd = lambda m: JaxSGD(list(m.parameters()), lr=0.01)  # noqa: E731
    want, _ = _jax_run("mlp", sgd, _xy(d), 1,
                       loss=lambda o, t: _ce(o, t) * o.shape[0],
                       loss_scale=1.0)
    start = [np.asarray(p.data, np.float32) for p in _mlp().parameters()]
    for res in ranks["two"]:
        got = res["sum"]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0] / 2,
                                   rtol=1e-5)
        for a, b, p0 in zip(got["params"], want["params"], start):
            np.testing.assert_allclose(a.numpy() - p0, (b - p0) / 2,
                                       rtol=2e-3, atol=2e-6)


def test_zero_batchnorm_uses_global_batch_statistics(ranks):
    """A BatchNorm model under ZeRO on two ranks of 4 rows each: the JAX
    global-view step's losses, parameters and running statistics, which
    are the 8-row batch's."""
    d = ranks["d"]
    sgd = lambda m: JaxSGD(list(m.parameters()), lr=0.1,  # noqa: E731
                           momentum=0.9)
    want, _ = _jax_run("net", sgd, _xy(d, "xb", "yb"), 3, loss_scale=1.0)
    for res in ranks["two"]:
        _close_run(res["bn"], want)
        rm, rv = res["bn"]["buffers"][:2]
        np.testing.assert_allclose(rm.numpy(), want["buffers"]
                                   ["bn.running_mean"], rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(rv.numpy(), want["buffers"]
                                   ["bn.running_var"], rtol=2e-5, atol=2e-6)


def test_zero_skips_when_only_one_ranks_shard_overflows(ranks):
    """Only rank 1's rows of the gradient overflow, yet both ranks skip:
    masters unchanged, step count 0, the scale halved, the flag set, as
    the JAX step decides once for the global batch."""
    d = ranks["d"]
    m = _lin()
    js = jax_make_train_step(m, _jadam(1e-2)(m), lambda o, c: (o * c).sum(),
                             loss_scale="dynamic", zero_sharding=True,
                             zero_mesh=_mesh(2))
    js(jnp.asarray(d["x"]), jnp.asarray(d["c"]))
    for res in ranks["two"]:
        sk = res["skip"]
        assert all(sk["same"]) and sk["step"] == int(js.state.step) == 0
        assert sk["scale"] == float(js.state.scaler.loss_scale) == 2.0 ** 15
        assert sk["overflow"] == 1


def test_zero_gather_prefetch_on_equals_off_bitwise(ranks):
    """accum_steps=2 at stage 3 (bf16 half shards) and at stage 1 with
    fp32 masters (gathered for the forward): the executor's gather
    overlap knob on and off give the same bits (the step gathers once a
    window either way)."""
    for res in ranks["two"]:
        for k in (3, 1):
            on, off = res[f"ov{k}_True"], res[f"ov{k}_False"]
            assert on["losses"] == off["losses"]
            assert all(torch.equal(a, b) for a, b in zip(on["params"],
                                                         off["params"]))


def test_zero_collectives_are_one_pair_a_window(ranks):
    """The collectives of one window, counted: each of the 4 sharded
    leaves is reduce-scattered once a window (with or without
    accumulation) and gathered once a window: into its half copy after
    the update (stage 1) or into the forward's view at the top (stage 3);
    the loss's mean is the one all-reduce (stage 0 exchanges its whole
    leaves in one flattened all-reduce instead)."""
    want = {(0, 1): {"all_reduce": 2},
            (1, 1): {"reduce_scatter_tensor": 4, "all_gather_into_tensor": 4,
                     "all_reduce": 1},
            (3, 1): {"reduce_scatter_tensor": 4, "all_gather_into_tensor": 4,
                     "all_reduce": 1},
            (1, 2): {"reduce_scatter_tensor": 4, "all_gather_into_tensor": 4,
                     "all_reduce": 1},
            (3, 2): {"reduce_scatter_tensor": 4, "all_gather_into_tensor": 4,
                     "all_reduce": 1}}
    for res in ranks["two"]:
        assert res["collectives"] == want


def test_zero_telemetry_is_the_global_window(ranks):
    """Telemetry under ZeRO: the drained loss is the mean of the global
    losses, and the gradient norm the global one, the same on both ranks
    and the JAX ZeRO step's."""
    d = ranks["d"]
    m = _mlp()
    js = jax_make_train_step(m, _jadam(1e-2)(m), _ce, loss_scale=1.0,
                             zero_sharding=True, zero_mesh=_mesh(2),
                             telemetry=True, drain_every=10)
    for _ in range(2):
        js(*_xy(d))
    want = js.drain_telemetry()
    recs = [res["telem_rec"] for res in ranks["two"]]
    assert recs[0]["grad_norm"] == recs[1]["grad_norm"]
    for res, rec in zip(ranks["two"], recs):
        assert rec["windows"] == 2
        np.testing.assert_allclose(rec["loss_mean"],
                                   np.mean(res["telem"]["losses"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(rec["loss_mean"], want["loss_mean"],
                                   atol=1e-5)
        np.testing.assert_allclose(rec["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)


def test_jax_zero_checkpoint_restores_into_the_port(ranks):
    """A schema-3 checkpoint of a JAX ZeroTrainStep on a 2-device mesh,
    restored into the port's over two ranks (each taking its rows), goes
    on as the JAX step went on."""
    want = ranks["jax_ckpt"]
    for res in ranks["two"]:
        got = res["ckpt_jax"]
        assert got["step_no"] == 2 and got["count"] == 2
        _close_run(got, want)


def test_port_zero_checkpoints_round_trip(ranks):
    """CheckpointManager.save_sharded / restore_resharded and
    save_train_state / restore_train_state of a stage-3 bf16 ZeRO step
    (gathered whole, written by rank 0): resume is exact."""
    for res in ranks["two"]:
        ck = res["ckpt_port"]
        assert ck["got"][0] == ck["want"] == ck["got"][2]
        assert ck["got"][1] and ck["got"][3]


def _tiny():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(16, 64), torch.nn.ReLU(),
                            torch.nn.Linear(64, 8))
    return m, FusedAdam(list(m.parameters()), lr=1e-2)


def _loss(o, t):
    return F.cross_entropy(o, t)


def test_zero_refusals_and_world_of_one():
    """The JAX refusals, and a world of one (no torch.distributed): every
    dim-0 leaf is ``Shard(0)`` of one rank, the step is the plain step."""
    class Fake:
        pass
    with pytest.raises(ValueError, match="_raw_step_fn"):
        ZeroTrainStep(Fake(), None)
    m, opt = _tiny()
    with pytest.raises(ValueError, match="WITHOUT axis_name"):
        ZeroTrainStep(make_train_step(m, opt, _loss, axis_name="data"), None)
    with pytest.raises(ValueError, match="donate_state=False"):
        ZeroTrainStep(make_train_step(m, opt, _loss, donate_state=True),
                      None)
    with pytest.raises(ValueError, match="zero_stage must be 1"):
        make_train_step(m, opt, _loss, zero_sharding=True, zero_stage=2)
    with pytest.raises(ValueError, match="excludes axis_name"):
        make_train_step(m, opt, _loss, zero_sharding=True, axis_name="data")
    with pytest.raises(ValueError, match="zero_sharding"):
        make_train_step(m, opt, _loss, zero_sharding=True, flat_master=True)

    class OtherMesh:
        mesh_dim_names = ("x",)
    with pytest.raises(ValueError, match="not an axis of zero_mesh"):
        make_train_step(m, opt, _loss, zero_sharding=True,
                        zero_mesh=OtherMesh())
    for kw in (dict(tp_axis="model"), dict(parallel="auto"),
               dict(axis_name="model")):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            make_train_step(m, opt, _loss, **kw)
    z = make_train_step(m, opt, _loss, zero_sharding=True, loss_scale=1.0)
    assert z.mesh is None and z.n == 1
    sh = zero_state_sharding(z.state, None)
    assert [str(p) for p in sh.master_params] == ["S(0)"] * 4
    assert str(sh.scaler.loss_scale) == "R" and str(sh.step) == "R"
    assert zero_state_sharding(z.state, None, stage=0).model_params \
        == [None] * 4
    x, y = torch.randn(8, 16), torch.randint(0, 8, (8,))
    m2, opt2 = _tiny()
    plain = make_train_step(m2, opt2, _loss, loss_scale=1.0)
    assert [float(z(x, y)) for _ in range(2)] \
        == [float(plain(x, y)) for _ in range(2)]
    assert z.graph_stats()["entries"] == 1
