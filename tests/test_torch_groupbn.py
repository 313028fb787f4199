"""``contrib.groupbn.BatchNorm2d_NHWC`` and the channels-last
``SyncBatchNorm`` and DDP exchange against the JAX package, on the CPU (the
counterpart of ``tests/test_groupbn.py``).

In this process: the module against the JAX module on the same NHWC input
(output, running statistics, the ``minibatch_mean`` / ``minibatch_riv``
buffers, eval mode), the residual add before the fused ReLU, and the
reference's launch knobs taken for parity.  The JAX test's mesh case, group
statistics over ``bn_group`` devices, becomes two gloo ranks started once
for the file by the port's launcher (``python -m
apex_tpu_torch.parallel.multiproc --nproc 2 worker.py``): ``bn_group=2``
shares the statistics of the pair, ``bn_group=1`` keeps each rank's own;
beside them ``SyncBatchNorm(channel_last=True)`` over the pair, and
``DistributedDataParallel`` over a channels-last convolution, whose
exchanged gradients keep the weights' channels-last layout.  Each is held
against the JAX package on the full batch (or each rank's half).
"""
import os
import socket
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JaxBatchNorm2d_NHWC
from apex_tpu.nn import functional as jax_F
from apex_tpu.nn.modules import Ctx

from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 6

WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from apex_tpu_torch import nn, parallel
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.nn import functional as F

out_dir = sys.argv[1]
parallel.init_distributed(device="cpu", timeout_s=60)
r = dist.get_rank()
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.normal(size=(8, 5, 5, 6)).astype(np.float32) * 2
                     + 1)
wout = torch.from_numpy(rng.normal(size=(8, 5, 5, 6)).astype(np.float32))
wb = rng.normal(size=(2, 6)).astype(np.float32)
res = {}
half = slice(4 * r, 4 * r + 4)


def bn_run(bn):
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(wb[0]))
        bn.bias.copy_(torch.from_numpy(wb[1]))
    xh = x[half].clone().requires_grad_(True)
    y = bn(xh)
    (y * wout[half]).sum().backward()
    out = dict(y=y.detach(), dx=xh.grad, dw=bn.weight.grad.clone(),
               db=bn.bias.grad.clone())
    out.update({k: v.clone() for k, v in bn.named_buffers()})
    return out


res["group2"] = bn_run(BatchNorm2d_NHWC(6, bn_group=2, device="cpu"))
res["group1"] = bn_run(BatchNorm2d_NHWC(6, bn_group=1, device="cpu"))
res["sbn_cl"] = bn_run(parallel.SyncBatchNorm(6, channel_last=True))

# DDP over a channels-last convolution: NHWC input, conv weights in
# torch.channels_last memory, buckets of 10 elements (one each)
xi = torch.from_numpy(rng.normal(size=(8, 7, 7, 3)).astype(np.float32))
yi = torch.from_numpy(rng.integers(0, 5, 8))
cw = torch.from_numpy(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
fw = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
conv = torch.nn.Conv2d(3, 4, 3, bias=False)
fc = torch.nn.Linear(4, 5, bias=False)
with torch.no_grad():
    conv.weight.copy_(cw)
    fc.weight.copy_(fw)
net = nn.to_channels_last(torch.nn.Sequential(conv, torch.nn.ReLU()))
ddp = parallel.DistributedDataParallel(torch.nn.ModuleDict(
    dict(net=net, fc=fc)), message_size=10)
F.cross_entropy(fc(net(xi[half]).mean(dim=(1, 2))), yi[half]).backward()
res["ddp"] = dict(dw=conv.weight.grad.clone(),
                  dw_channels_last=conv.weight.grad.is_contiguous(
                      memory_format=torch.channels_last),
                  w_channels_last=conv.weight.is_contiguous(
                      memory_format=torch.channels_last),
                  dfc=fc.weight.grad.clone(), exchanges=ddp.exchanges)
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
    out = tmp_path_factory.mktemp("groupbn")
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
    x = rng.normal(size=(8, 5, 5, C)).astype(np.float32) * 2 + 1
    wout = rng.normal(size=(8, 5, 5, C)).astype(np.float32)
    wb = rng.normal(size=(2, C)).astype(np.float32)
    xi = rng.normal(size=(8, 7, 7, 3)).astype(np.float32)
    yi = rng.integers(0, 5, 8)
    cw = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    fw = rng.normal(size=(5, 4)).astype(np.float32)
    return x, wout, wb, xi, yi, cw, fw


def _close(a, b, tol=1e-5):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                               atol=tol)


def _jax_groupbn(x, wout, wb, **kw):
    """The JAX module on ``x`` (NHWC) in training: output, input, weight
    and bias gradients of sum(y * wout), and its buffers after the call."""
    jnn.manual_seed(0)
    bn = JaxBatchNorm2d_NHWC(C, **kw)
    names = ("running_mean", "running_var", "minibatch_mean",
             "minibatch_riv")

    def loss(xv, w, b):
        stats = {}
        ctx = Ctx(env={id(bn.weight): w, id(bn.bias): b}, stats_out=stats,
                  training=True)
        y = bn.forward(ctx, xv)
        return jnp.sum(y * wout), (y, [stats[id(getattr(bn, n))]
                                       for n in names])

    (_, (y, bufs)), (dx, dw, db) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(wb[0]), jnp.asarray(wb[1]))
    return dict(y=y, dx=dx, dw=dw, db=db, **dict(zip(names, bufs)))


def _port_groupbn(x, wout, wb, **kw):
    bn = BatchNorm2d_NHWC(C, device="cpu", **kw)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(wb[0]))
        bn.bias.copy_(torch.from_numpy(wb[1]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(wout)).sum().backward()
    return bn, dict(y=y, dx=xt.grad, dw=bn.weight.grad, db=bn.bias.grad,
                    **dict(bn.named_buffers()))


def test_matches_the_jax_module_and_nchw_batchnorm():
    """One rank, training: output, the three gradients, the running
    statistics and the minibatch buffers within 1e-5 of the JAX module's
    on the same NHWC batch (the JAX test's 1e-5 / 1e-6 for y and the
    running mean), and the output within 1e-5 of torch's BatchNorm2d on the
    NCHW batch; the state dict has the JAX module's keys."""
    x, wout, wb = _data()[:3]
    want = _jax_groupbn(x, wout, wb)
    bn, got = _port_groupbn(x, wout, wb)
    for k, v in want.items():
        _close(got[k], v)
    _close(got["running_mean"], want["running_mean"], 1e-6)
    jnn.manual_seed(0)
    assert set(bn.state_dict()) == set(JaxBatchNorm2d_NHWC(C).state_dict())
    ref = torch.nn.BatchNorm2d(C)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(wb[0]))
        ref.bias.copy_(torch.from_numpy(wb[1]))
    _close(got["y"], ref(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).detach())


def test_fuse_relu_and_add():
    """``forward(x, z)`` with ``fuse_relu``: ReLU after the residual add
    (every output >= 0), within 1e-5 of the JAX module's; eval mode
    normalises with the running statistics and leaves the buffers."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    z = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    jnn.manual_seed(0)
    jbn = JaxBatchNorm2d_NHWC(4, fuse_relu=True)
    want = jbn.forward(Ctx(training=True), jnp.asarray(x), jnp.asarray(z))
    bn = BatchNorm2d_NHWC(4, fuse_relu=True, device="cpu")
    got = bn(torch.from_numpy(x), torch.from_numpy(z))
    assert bool((got >= 0).all())
    _close(got, want)
    no_add = bn(torch.from_numpy(x))
    assert not torch.allclose(no_add, got)
    # eval: the running statistics, and no buffer written
    bn.eval()
    before = {k: v.clone() for k, v in bn.named_buffers()}
    stats = {id(jbn.running_mean): jnp.asarray(bn.running_mean.numpy()),
             id(jbn.running_var): jnp.asarray(bn.running_var.numpy())}
    want = jbn.forward(Ctx(env=stats, training=False), jnp.asarray(x),
                       jnp.asarray(z))
    with torch.no_grad():
        got = bn(torch.from_numpy(x), torch.from_numpy(z))
    _close(got, want)
    assert all(torch.equal(v, before[k]) for k, v in bn.named_buffers())


def test_launch_knobs_are_taken_and_one_process_keeps_local_stats():
    """The reference's CUDA knobs change nothing; ``bn_group`` > 1 without
    ``torch.distributed`` (one process) normalises with this process's
    statistics, as the JAX module does with its axis unbound."""
    x, wout, wb = _data()[:3]
    _, plain = _port_groupbn(x, wout, wb)
    _, knobs = _port_groupbn(x, wout, wb, max_cta_per_sm=4,
                             cta_launch_margin=0, multi_stream=True)
    for k in plain:
        assert torch.equal(plain[k], knobs[k]), k
    bn = BatchNorm2d_NHWC(C, bn_group=4, group_world_size=4, device="cpu")
    assert bn.bn_group == 4 and bn.axis_name == "data"
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(wb[0]))
        bn.bias.copy_(torch.from_numpy(wb[1]))
    assert torch.equal(bn(torch.from_numpy(x)), plain["y"])
    with pytest.raises(NotImplementedError, match="axis_name"):
        BatchNorm2d_NHWC(C, axis_name="batch", device="cpu")


def test_group_statistics_over_two_ranks_match_jax(ranks):
    """``bn_group=2`` over two ranks holding halves of one NHWC batch: each
    rank's output and input gradient, the weight and bias gradients summed
    over the ranks, and both ranks' running statistics and minibatch
    buffers within 1e-5 of the JAX module on the full batch; ``bn_group=1``
    keeps each rank's own statistics (the JAX module on that rank's half),
    so the pairs' running means agree and the singles' differ."""
    x, wout, wb = _data()[:3]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        full = _jax_groupbn(x, wout, wb)
        halves = [_jax_groupbn(x[4 * r:4 * r + 4], wout[4 * r:4 * r + 4], wb)
                  for r in range(2)]
    for r, res in enumerate(ranks):
        g2, g1 = res["group2"], res["group1"]
        _close(g2["y"], np.asarray(full["y"])[4 * r:4 * r + 4])
        _close(g2["dx"], np.asarray(full["dx"])[4 * r:4 * r + 4])
        for k in ("running_mean", "running_var", "minibatch_mean",
                  "minibatch_riv"):
            _close(g2[k], full[k])
        for k in ("y", "dx", "dw", "db", "running_mean", "running_var",
                  "minibatch_mean", "minibatch_riv"):
            _close(g1[k], halves[r][k])
    _close(ranks[0]["group2"]["dw"] + ranks[1]["group2"]["dw"], full["dw"])
    _close(ranks[0]["group2"]["db"] + ranks[1]["group2"]["db"], full["db"])
    assert torch.equal(ranks[0]["group2"]["running_mean"],
                       ranks[1]["group2"]["running_mean"])
    assert not torch.allclose(ranks[0]["group1"]["running_mean"],
                              ranks[1]["group1"]["running_mean"])


def test_sync_batchnorm_channel_last_over_two_ranks_matches_jax(ranks):
    """``SyncBatchNorm(channel_last=True)`` over the two NHWC halves:
    output, gradients (weight and bias summed over the ranks) and running
    statistics within 1e-5 of JAX ``F.batch_norm(channel_axis=-1)`` on the
    full batch."""
    x, wout, wb = _data()[:3]

    def loss(xv, w, b):
        y, rm, rv = jax_F.batch_norm(xv, jnp.zeros(C), jnp.ones(C), w, b,
                                     training=True, channel_axis=-1)
        return jnp.sum(y * wout), (y, rm, rv)
    (_, (y, rm, rv)), (dx, dw, db) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(wb[0]), jnp.asarray(wb[1]))
    for r, res in enumerate(ranks):
        s = res["sbn_cl"]
        _close(s["y"], np.asarray(y)[4 * r:4 * r + 4])
        _close(s["dx"], np.asarray(dx)[4 * r:4 * r + 4])
        _close(s["running_mean"], rm)
        _close(s["running_var"], rv)
        assert int(s["num_batches_tracked"]) == 1
    _close(ranks[0]["sbn_cl"]["dw"] + ranks[1]["sbn_cl"]["dw"], dw)
    _close(ranks[0]["sbn_cl"]["db"] + ranks[1]["sbn_cl"]["db"], db)


def test_ddp_keeps_channels_last_gradients_and_averages_them(ranks):
    """DDP over an NHWC convolution whose weight is stored channels-last:
    the exchanged gradient is still channels-last on both ranks (the
    buckets take each tensor in its memory order, and the result is
    written back in it), and it is JAX's full-batch gradient of the same
    network (NHWC ``F.conv2d``, ReLU, spatial mean, a linear head, mean
    cross entropy) within 1e-5; buckets of 10 elements made two
    exchanges."""
    _, _, _, xi, yi, cw, fw = _data()

    def loss(w, f):
        h = jnp.maximum(jax_F.conv2d(jnp.asarray(xi), w, channels_last=True),
                        0.0)
        return jax_F.cross_entropy(h.mean(axis=(1, 2)) @ f.T,
                                   jnp.asarray(yi))
    dw, dfc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(cw),
                                              jnp.asarray(fw))
    for res in ranks:
        d = res["ddp"]
        assert d["w_channels_last"] and d["dw_channels_last"]
        _close(d["dw"], dw)
        _close(d["dfc"], dfc)
        assert d["exchanges"] == 2
    assert torch.equal(ranks[0]["ddp"]["dw"], ranks[1]["ddp"]["dw"])
