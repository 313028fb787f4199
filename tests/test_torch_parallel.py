"""The port's data parallelism against the JAX package's, on the CPU.

Two gloo ranks are started once for the file, by the port's own launcher
(``python -m apex_tpu_torch.parallel.multiproc --nproc 2 worker.py``, one
subprocess); each runs ``WORKER`` and leaves its results in ``tmp_path``.
The tests compare them with the JAX package on the full batch:
``DistributedDataParallel``'s averaged gradients of two half batches
against the full-batch gradient of a BatchNorm-free model;
``SyncBatchNorm`` over two half batches against JAX ``F.batch_norm`` on the
full batch (output, gradients, running statistics); the exchange knobs
(``allreduce_always_fp32``, ``gradient_predivide_factor``,
``gradient_average=False``), ``delay_allreduce`` with
``attach_optimizer`` (one exchange a window), the same under amp O2 with a
non-finite gradient on one rank only (both ranks skip that window),
``SyncBatchNorm`` over halves of unequal size, ``Reducer``, the parameter
broadcast and ``create_syncbn_process_group``.  In this process: the
option errors, ``create_syncbn_process_group``'s errors, LARC against the
JAX LARC, and the launcher's environment.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.nn import functional as jax_F
from apex_tpu.nn.parameter import Parameter as JaxParameter
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import LARC as JaxLARC

from apex_tpu_torch import parallel
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import multiproc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from apex_tpu_torch import parallel
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedSGD

out_dir = sys.argv[1]
local = int([a for a in sys.argv if a.startswith("--local_rank=")][0][13:])
parallel.init_distributed(device="cpu", timeout_s=60)
r, n = dist.get_rank(), dist.get_world_size()
assert r == local and n == 2
rng = np.random.default_rng(0)
W1, b1 = rng.normal(size=(16, 8)), rng.normal(size=16)
W2, b2 = rng.normal(size=(4, 16)), rng.normal(size=4)
x = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
y = torch.from_numpy(rng.integers(0, 4, 8))
res = {}


def mlp(seed_shift=0.0):
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p, a in zip(m.parameters(), (W1, b1, W2, b2)):
            p.copy_(torch.from_numpy(a.astype(np.float32)) + seed_shift)
    return m


def grads(m):
    return [p.grad.detach().clone() for p in m.parameters()]


# DDP: rank 1 starts from other weights, which the broadcast replaces;
# buckets of 50 elements, so most exchanges run inside backward
ddp = parallel.DistributedDataParallel(mlp(float(r)), message_size=50)
res["broadcast"] = [p.detach().clone() for p in ddp.parameters()]
xs, ys = ddp.shard_batch(x), ddp.shard_batch(y)
F.cross_entropy(ddp(xs), ys).backward()
res["ddp_grads"], res["ddp_exchanges"] = grads(ddp.module), ddp.exchanges
res["ddp_buckets"] = len(ddp._buckets)

for name, kw in (("predivide", dict(gradient_predivide_factor=2.0)),
                 ("sum", dict(gradient_average=False)),
                 ("fp32", dict(allreduce_always_fp32=True)),
                 ("delay", dict(delay_allreduce=True))):
    d = parallel.DistributedDataParallel(mlp(), **kw)
    F.cross_entropy(d(xs), ys).backward()
    res[name + "_grads"], res[name + "_exchanges"] = grads(d.module), \
        d.exchanges

# delay_allreduce + attach_optimizer: two microbatches, one exchange at
# step(); lr 0.1, no momentum
d = parallel.DistributedDataParallel(mlp(), delay_allreduce=True)
opt = d.attach_optimizer(FusedSGD(d.parameters(), lr=0.1))
for k in range(2):
    F.cross_entropy(d(xs[2 * k:2 * k + 2]), ys[2 * k:2 * k + 2]).backward()
res["window_exchanges_before_step"] = d.exchanges
opt.step()
res["window_exchanges"] = d.exchanges
res["window_params"] = [p.detach().clone() for p in d.parameters()]

# amp O2 (fp16, dynamic scale capped at 2^8) + delay_allreduce +
# attach_optimizer, FusedSGD with momentum: a non-finite gradient planted on
# rank 1 only, in window 2 of 3.  The window is exchanged before amp
# unscales it, so both ranks see the inf and skip the same window
from apex_tpu_torch import amp
m = mlp()
m, o = amp.initialize(m, FusedSGD(m.parameters(), lr=0.1, momentum=0.9),
                      opt_level="O2", verbosity=0, max_loss_scale=2.0 ** 8)
d = parallel.DistributedDataParallel(m, delay_allreduce=True)
o = d.attach_optimizer(o)
res["amp_skips"], res["amp_scales"] = [], []
for k in range(3):
    loss = F.cross_entropy(d(xs).float(), ys)
    with amp.scale_loss(loss, o) as scaled:
        scaled.backward()
        if k == 1 and r == 1:
            d.module[0].weight.grad[0, 0] = float("inf")
    res["amp_skips"].append(o._amp_stash.already_patched)
    o.step()
    o.zero_grad()
    res["amp_scales"].append(amp._amp_state.loss_scalers[0].loss_scale())
res["amp_exchanges"] = d.exchanges
res["amp_masters"] = [p.detach().clone() for g in o.param_groups
                      for p in g["params"]]
res["amp_model"] = [p.detach().clone() for p in d.module.parameters()]

# Reducer over a module and over a list of tensors
m = mlp()
red = parallel.Reducer(m)
F.cross_entropy(m(xs), ys).backward()
red.reduce()
res["reducer_grads"] = grads(m)
ts = [torch.full((3,), float(r + 1)), torch.arange(4.0) * (r + 1)]
parallel.Reducer(ts).reduce()
res["reducer_list"] = ts

# all_reduce_mean's knobs on per-rank values
a = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))[r]
res["arm"] = {
    "mean16": parallel.all_reduce_mean([a.half()], always_fp32=True)[0],
    "pre": parallel.all_reduce_mean([a], predivide_factor=2.0)[0],
    "sum": parallel.all_reduce_mean([a], average=False)[0]}

# SyncBatchNorm over the two halves of one batch
xb = torch.from_numpy(rng.normal(size=(8, 6, 5, 5)).astype(np.float32) * 2
                      + 1)
wout = torch.from_numpy(rng.normal(size=(8, 6, 5, 5)).astype(np.float32))
wb = rng.normal(size=(2, 6)).astype(np.float32)
sbn = parallel.SyncBatchNorm(6)
with torch.no_grad():
    sbn.weight.copy_(torch.from_numpy(wb[0]))
    sbn.bias.copy_(torch.from_numpy(wb[1]))
xh = xb[4 * r:4 * r + 4].clone().requires_grad_(True)
yh = sbn(xh)
(yh * wout[4 * r:4 * r + 4]).sum().backward()
res["sbn"] = dict(y=yh.detach(), dx=xh.grad, dw=sbn.weight.grad.clone(),
                  db=sbn.bias.grad.clone(), rm=sbn.running_mean.clone(),
                  rv=sbn.running_var.clone(),
                  tracked=int(sbn.num_batches_tracked))
sbn.eval()
with torch.no_grad():
    res["sbn_eval"] = (sbn(xb[:2]), torch.nn.functional.batch_norm(
        xb[:2], sbn.running_mean, sbn.running_var, sbn.weight, sbn.bias))
# the same batch split 3 + 5: the merge weighs each rank by its count
cut = (0, 3, 8)
su = parallel.SyncBatchNorm(6)
with torch.no_grad():
    su.weight.copy_(torch.from_numpy(wb[0]))
    su.bias.copy_(torch.from_numpy(wb[1]))
xu = xb[cut[r]:cut[r + 1]].clone().requires_grad_(True)
yu = su(xu)
(yu * wout[cut[r]:cut[r + 1]]).sum().backward()
res["sbn_uneven"] = dict(y=yu.detach(), dx=xu.grad, dw=su.weight.grad.clone(),
                         db=su.bias.grad.clone(), rm=su.running_mean.clone(),
                         rv=su.running_var.clone())
# a group of one rank per group: local statistics
g1 = parallel.create_syncbn_process_group(1)
res["group_sizes"] = (dist.get_world_size(g1),
                      parallel.create_syncbn_process_group(2))
sl = parallel.SyncBatchNorm(6, process_group=g1)
with torch.no_grad():
    res["sbn_local"] = (sl(xb[4 * r:4 * r + 4]),
                        torch.nn.functional.batch_norm(
                            xb[4 * r:4 * r + 4], None, None, training=True))
torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results: one launch of the port's launcher."""
    out = tmp_path_factory.mktemp("ddp")
    worker = out / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, APEX_TPU_COORD_PORT=str(_free_port()),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc", "--nproc",
         "2", str(worker), str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def _data():
    """The worker's numpy data, drawn in the same order."""
    rng = np.random.default_rng(0)
    ws = [rng.normal(size=s).astype(np.float32)
          for s in ((16, 8), (16,), (4, 16), (4,))]
    x = rng.normal(size=(8, 8)).astype(np.float32)
    y = rng.integers(0, 4, 8)
    a = rng.normal(size=(2, 5)).astype(np.float32)
    xb = rng.normal(size=(8, 6, 5, 5)).astype(np.float32) * 2 + 1
    wout = rng.normal(size=(8, 6, 5, 5)).astype(np.float32)
    wb = rng.normal(size=(2, 6)).astype(np.float32)
    return ws, x, y, a, xb, wout, wb


def _jax_grads(ws, x, y):
    """The full-batch gradient of the mean cross entropy of the MLP."""
    def loss(params):
        w1, b1, w2, b2 = params
        h = jnp.maximum(x @ w1.T + b1, 0.0)
        return jax_F.cross_entropy(h @ w2.T + b2, jnp.asarray(y))
    return [np.asarray(g) for g in jax.grad(loss)([jnp.asarray(w)
                                                   for w in ws])]


def _close(a, b, tol=1e-5):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                               atol=tol)


def test_ddp_averages_half_batch_gradients_to_the_full_batch_gradient(ranks):
    """The mean of the exchanged gradients of two half batches is JAX's
    full-batch gradient (within 1e-5), on both ranks; rank 1's other
    starting weights were replaced by rank 0's; buckets of at least 50
    elements (two here) run one exchange each."""
    ws, x, y = _data()[:3]
    want = _jax_grads(ws, x, y)
    for res in ranks:
        for p, w in zip(res["broadcast"], ws):
            _close(p, w, 0)
        for g, w in zip(res["ddp_grads"], want):
            _close(g, w)
        assert res["ddp_exchanges"] == res["ddp_buckets"] == 2
        for g, w in zip(res["fp32_grads"], want):
            _close(g, w)
        for g, w in zip(res["predivide_grads"], want):
            _close(g, w)
        for g, w in zip(res["sum_grads"], want):
            _close(g, 2 * w)            # gradient_average=False: the sum
        for g, w in zip(res["delay_grads"], want):
            _close(g, w)
        assert res["delay_exchanges"] == 1     # one flattened exchange
        for g, w in zip(res["reducer_grads"], want):
            _close(g, w)


def test_delay_allreduce_with_attach_optimizer_exchanges_once_a_window(ranks):
    """Two microbatches per rank, one ``step()``: no exchange in backward,
    one at the step, and the update is lr times the rank mean of the summed
    microbatch gradients (2 x the full-batch gradient here)."""
    ws, x, y = _data()[:3]
    want = _jax_grads(ws, x, y)
    for res in ranks:
        assert res["window_exchanges_before_step"] == 0
        assert res["window_exchanges"] == 1
        for p, w, g in zip(res["window_params"], ws, want):
            _close(p, w - 0.1 * 2 * g)
    np.testing.assert_array_equal(ranks[0]["reducer_list"][0].numpy(),
                                  np.full(3, 1.5, np.float32))


def test_all_reduce_mean_knobs(ranks):
    a = _data()[3]
    for res in ranks:
        arm = res["arm"]
        assert arm["mean16"].dtype == torch.float16
        _close(arm["mean16"], a.astype(np.float16).astype(np.float32).mean(0),
               2e-3)
        _close(arm["pre"], a.mean(0))
        _close(arm["sum"], a.sum(0))


def test_amp_with_attach_optimizer_skips_the_same_window_on_every_rank(
        ranks):
    """amp O2 + ``attach_optimizer``: an inf planted in rank 1's gradients
    only, in window 2 of 3, is exchanged before amp unscales, so both ranks
    skip window 2 (scale 256 -> 128) and make the other two steps; each
    window is exchanged once (one fp16 bucket), the skipped one too; both
    ranks end with the same fp32 masters and fp16 model, bit for bit, and
    the masters moved."""
    init = _data()[0]
    for res in ranks:
        assert res["amp_skips"] == [False, True, False]
        assert res["amp_scales"] == [256.0, 128.0, 128.0]
        assert res["amp_exchanges"] == 3
    for a, b in zip(ranks[0]["amp_masters"], ranks[1]["amp_masters"]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(ranks[0]["amp_model"], ranks[1]["amp_model"]):
        assert a.dtype == torch.float16
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, w in zip(ranks[0]["amp_masters"], init):
        assert not np.allclose(a.numpy(), w, rtol=0, atol=1e-4)


def _jax_batch_norm(xb, wout, wb):
    """JAX ``F.batch_norm`` on the full batch: output, input gradient,
    weight and bias gradients, running statistics."""
    def loss(xv, w, b):
        y, rm, rv = jax_F.batch_norm(xv, jnp.zeros(6), jnp.ones(6), w, b,
                                     training=True)
        return jnp.sum(y * wout), (y, rm, rv)
    (_, (y, rm, rv)), (dx, dw, db) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(xb), jnp.asarray(wb[0]), jnp.asarray(wb[1]))
    return np.asarray(y), np.asarray(dx), dw, db, rm, rv


def test_sync_batchnorm_over_two_ranks_matches_jax_full_batch(ranks):
    """Output, input gradient, weight and bias gradients (summed over the
    ranks' losses) and running statistics within 1e-5 of JAX
    ``F.batch_norm`` on the full batch, with the batch split 4 + 4 and
    3 + 5 over the ranks; eval mode uses the running statistics; a group
    of one rank keeps local statistics."""
    y, dx, dw, db, rm, rv = _jax_batch_norm(*_data()[4:])
    for r, res in enumerate(ranks):
        s = res["sbn"]
        assert s["tracked"] == 1
        torch.testing.assert_close(*res["sbn_eval"], rtol=0, atol=0)
        assert res["group_sizes"] == (1, None)
        torch.testing.assert_close(*res["sbn_local"], rtol=1e-6, atol=1e-6)
    cut = (0, 3, 8)
    for case, lo, hi in (("sbn", (0, 4), (4, 8)), ("sbn_uneven", cut[:2],
                                                  cut[1:])):
        for res, (a, b) in zip(ranks, (lo, hi)):
            _close(res[case]["y"], y[a:b])
            _close(res[case]["dx"], dx[a:b])
            _close(res[case]["rm"], rm)
            _close(res[case]["rv"], rv)
        _close(ranks[0][case]["dw"] + ranks[1][case]["dw"], dw)
        _close(ranks[0][case]["db"] + ranks[1][case]["db"], db)


def test_ddp_option_errors_and_syncbn_group_errors():
    m = torch.nn.Linear(2, 2)
    cases = [(dict(shared_param=True), "shared_param is no longer"),
             (dict(delay_allreduce=True, num_allreduce_streams=2),
              "makes num_allreduce_streams irrelevant"),
             (dict(delay_allreduce=True, allreduce_trigger_params=[]),
              "only valid if delay_allreduce=False"),
             (dict(allreduce_communicators=([1, 2], [])),
              "allreduce_communicators must be")]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            parallel.DistributedDataParallel(m, **kw)
    # the reference's options for its own buckets, streams and buffers
    for kw in (dict(allreduce_trigger_params=[m.weight]),
               dict(retain_allreduce_buffers=True),
               dict(num_allreduce_streams=2),
               dict(allreduce_communicators=([1, 2], [3, 4]),
                    num_allreduce_streams=2),
               dict(gradient_average_split_factor=2.0), dict(prof=True)):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            parallel.DistributedDataParallel(m, **kw)
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        parallel.DistributedDataParallel(m)
    assert parallel.SyncBatchNorm(4, channel_last=True).channel_last
    for size, msg in ((-1, "non-negative"), (8, "exceeds world size"),
                      (3, "must be divisible")):
        with pytest.raises(ValueError, match=msg):
            parallel.create_syncbn_process_group(size, world_size=4)
    assert parallel.create_syncbn_process_group(0, world_size=4) is None
    assert parallel.create_syncbn_process_group(4, world_size=4) is None
    # without torch.distributed: one rank, and local statistics
    assert parallel.world_size() == 1 and parallel.rank() == 0
    bn, sbn = torch.nn.BatchNorm2d(3), parallel.SyncBatchNorm(3)
    xin = torch.randn(4, 3, 5, 5)
    torch.testing.assert_close(sbn(xin), bn(xin), rtol=0, atol=0)


def test_init_distributed_retries_then_names_its_target():
    calls = []

    def failing(**kw):
        calls.append(kw)
        raise RuntimeError("connection refused")
    with pytest.raises(parallel.DistributedInitError) as e:
        parallel.init_distributed("127.0.0.1:1", num_processes=2,
                                  process_id=1, max_retries=2, backoff_s=0.0,
                                  device="cpu", _initialize=failing)
    msg = str(e.value)
    assert "after 3 attempt(s)" in msg and "'127.0.0.1:1'" in msg
    assert "process_id=1" in msg and "num_processes=2" in msg
    assert "connection refused" in msg
    assert calls[0]["backend"] == "gloo"
    assert calls[0]["init_method"] == "tcp://127.0.0.1:1"


def test_convert_syncbn_model_copies_parameters_and_buffers():
    m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1), torch.nn.BatchNorm2d(4))
    with torch.no_grad():
        m[1].weight.uniform_()
        m[1].running_var.fill_(3.0)
        m[1].num_batches_tracked.fill_(5)
    c = parallel.convert_syncbn_model(m)
    assert isinstance(c[1], parallel.SyncBatchNorm)
    assert isinstance(c[1], torch.nn.modules.batchnorm._BatchNorm)
    for name in ("weight", "bias", "running_mean", "running_var",
                 "num_batches_tracked"):
        assert torch.equal(getattr(c[1], name), getattr(m[1], name)), name


def test_larc_matches_jax_larc():
    """Two LARC steps (clip mode, weight decay 1e-4) around FusedSGD with
    momentum, one zero gradient among them: params within 1e-6."""
    r = np.random.default_rng(3)
    init = [r.normal(size=s).astype(np.float32) for s in ((5, 3), (7,), (4,))]
    grads = [[r.normal(size=a.shape).astype(np.float32) for a in init]
             for _ in range(2)]
    grads[1][2][:] = 0.0
    jp = [JaxParameter(jnp.asarray(a)) for a in init]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jopt = JaxLARC(JaxFusedSGD(jp, lr=0.1, momentum=0.9, weight_decay=1e-4))
    topt = parallel.LARC(FusedSGD(tp, lr=0.1, momentum=0.9,
                                  weight_decay=1e-4))
    for gs in grads:
        for p, g in zip(jp, gs):
            p.grad = jnp.asarray(g)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        jopt.step()
        topt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b.data),
                                   rtol=1e-6, atol=1e-6)
    assert topt.param_groups[0]["weight_decay"] == 1e-4


def test_launcher_environment_for_two_ranks():
    base = {"PATH": "/bin", "KEEP": "1"}
    envs = [multiproc.rank_env(base, 2, r, 23456) for r in range(2)]
    for r, env in enumerate(envs):
        assert env["KEEP"] == "1" and env["PATH"] == "/bin"
        assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("127.0.0.1",
                                                            "23456")
        assert (env["RANK"], env["LOCAL_RANK"], env["WORLD_SIZE"]) == \
            (str(r), str(r), "2")
        assert env["APEX_TPU_COORDINATOR"] == "127.0.0.1:23456"
        assert env["APEX_TPU_NUM_PROCESSES"] == "2"
        assert env["APEX_TPU_PROCESS_ID"] == str(r)
    assert "RANK" not in base
    assert multiproc.main([]) == 1      # no script: the usage, exit 1
