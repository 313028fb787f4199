"""The port's ResNet against the JAX package's, on the CPU, with weights
carried across by ``from_jax_state_dict``.

Two small models, ``ResNet(BasicBlock, [1, 1, 1, 1], num_classes=10,
small_input=True)`` and ``ResNet(Bottleneck, [1, 1, 1, 1],
num_classes=10)``, batch 4 at 16 x 16 from a numpy seed: the forward in
train and eval mode, the gradients and BatchNorm's running statistics of
one backward; then 4 steps of ``make_train_step`` with ``FusedSGD`` (the
bench's optimizer) against the JAX step on the BasicBlock model, in fp32
and with bf16 half copies under ``keep_batchnorm_fp32``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.models import resnet as jax_resnet
from apex_tpu.nn import functional as jax_F
from apex_tpu.nn.modules import Ctx
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.kernels import dispatch
from apex_tpu_torch.models import (BasicBlock, Bottleneck, ResNet,
                                   from_jax_state_dict, resnet50,
                                   to_numpy_state_dict)
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.training import make_train_step

torch.set_num_threads(2)

B, NCLS = 4, 10
# (port block, JAX block, small_input, input size)
_KINDS = {"basic": (BasicBlock, jax_resnet.BasicBlock, True, 16),
          "bottleneck": (Bottleneck, jax_resnet.Bottleneck, False, 16)}


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    """The JAX model of ``kind`` and its weights as numpy arrays, built once
    per file (JAX's eager initialisation is slow); no test changes it."""
    _, jblock, small, _ = _KINDS[kind]
    jnn.manual_seed(3)
    jm = jax_resnet.ResNet(jblock, [1, 1, 1, 1], num_classes=NCLS,
                           small_input=small)
    return jm, {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _models(kind):
    block, _, small, _ = _KINDS[kind]
    jm, sd = _jax_model(kind)
    tm = ResNet(block, [1, 1, 1, 1], num_classes=NCLS, small_input=small,
                device="cpu")
    return jm, from_jax_state_dict(tm, sd)


def _batch(kind, seed=0):
    hw = _KINDS[kind][3]
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, 3, hw, hw)).astype(np.float32),
            r.integers(0, NCLS, (B,)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _rel(a, b):
    """max |a - b| / max(1, max |b|)."""
    a, b = _np(a), _np(b)
    return np.abs(a - b).max(initial=0.0) / max(1.0, np.abs(b).max(
        initial=0.0))


def test_resnet50_names_counts_and_state_dict_round_trip():
    """ResNet-50 keeps the JAX package's names and order: 161 parameter
    tensors of 25,557,032 values and 159 buffers; the state dict travels
    both ways, ``num_batches_tracked`` as the JAX package's int32."""
    tm = resnet50(device="cpu")
    jm = jax_resnet.resnet50()
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert len(list(tm.parameters())) == 161
    assert sum(p.numel() for p in tm.parameters()) == 25_557_032
    assert [n for n, _ in tm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()]
    assert len(list(tm.buffers())) == 159
    assert "layer1.0.downsample.0.weight" in tm.state_dict()
    with torch.no_grad():
        tm.bn1.num_batches_tracked.fill_(7)
        tm.bn1.running_var.fill_(2.0)
    sd = to_numpy_state_dict(tm)
    assert sd["bn1.num_batches_tracked"].dtype == np.int32
    assert set(sd) == set(jm.state_dict())
    back = from_jax_state_dict(resnet50(device="cpu"), sd)
    assert back.bn1.num_batches_tracked.dtype == torch.int64
    assert int(back.bn1.num_batches_tracked) == 7
    assert torch.equal(back.bn1.running_var, tm.bn1.running_var)


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_resnet_forward_grads_and_stats_match_jax(kind):
    """Train mode: logits within 1e-4 of max(1, |ref|), every gradient
    within 1e-4 of max(1, |ref|) (fp32 sums in another order), the running
    statistics within 1e-5 and ``num_batches_tracked`` equal after one
    forward.  Eval mode on those statistics: logits within 1e-4."""
    jm, tm = _models(kind)
    x, y = _batch(kind)
    jparams = list(jm.parameters())
    jbufs = dict(jm.named_buffers())

    @jax.jit
    def loss_of(vals):
        stats = {}
        ctx = Ctx(env={id(p): v for p, v in zip(jparams, vals)},
                  stats_out=stats, training=True)
        logits = jm.forward(ctx, jnp.asarray(x))
        return jax_F.cross_entropy(logits, jnp.asarray(y)), (
            logits, {n: stats[id(b)] for n, b in jbufs.items()})

    (jloss, (jlogits, jstats)), jgrads = jax.value_and_grad(
        loss_of, has_aux=True)([p.data for p in jparams])
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert _rel(logits.detach(), jlogits) <= 1e-4
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for (name, p), g in zip(tm.named_parameters(), jgrads):
        assert _rel(p.grad, g) <= 1e-4, name
    for name, b in tm.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(b) == int(jstats[name]) == 1, name
        else:
            assert _rel(b, jstats[name]) <= 1e-5, name

    # eval mode on the running statistics that forward left
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jm.forward(Ctx(env={id(b): jstats[n] for n, b in jbufs.items()},
                          training=False), jnp.asarray(x))
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("half", ["float32", "bfloat16"])
def test_resnet_train_step_with_fused_sgd_matches_jax(half):
    """4 steps of ``make_train_step`` + ``FusedSGD(lr=0.01, momentum=0.9,
    weight_decay=1e-4)``, static loss scale 1, on the BasicBlock model, a
    new batch each step (the bench's recipe at a small size; a batch of 4
    repeated is memorised within three steps, and a loss near 0 magnifies
    rounding differences).

    fp32: losses within 1e-5 (relative); masters, momenta and running
    statistics within 1e-5 of max(1, |ref|).  bf16 half copies (BatchNorm
    kept fp32, so the update takes a list of bf16 conv/fc and fp32
    BatchNorm gradients): losses within 2e-2, running statistics within
    2e-2 of max(1, |ref|).  The bf16 gradients, which both packages compute
    about 20% (in norm) away from the fp32 ones (BatchNorm's gradients
    cancel), drive the rest: each master's change over the 4 steps lies
    within 0.5 of JAX's change, tensor by tensor in norm (the worst tensor
    reads 0.41, the median 0.32; an update skipped or scaled by 2 or 1/2
    reads 0.5 or more), and after 4 steps each side's momenta lie some 45%
    from an fp32 run's: the port's may lie at most 1.25 times as far from
    the fp32 run as JAX's.  ``num_batches_tracked`` is 4 on both sides.

    The Bottleneck model is left to the single backward above: its max
    pool meets near-ties that route a gradient to either of two inputs, and
    JAX's own compiled and eager gradients then differ by percents."""
    jm, tm = _models("basic")
    batches = [_batch("basic", 5 + i) for i in range(4)]
    jhalf = None if half == "float32" else jnp.bfloat16
    thalf = None if half == "float32" else torch.bfloat16
    hyper = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)
    jstep = jax_make_train_step(
        jm, JaxFusedSGD(list(jm.parameters()), **hyper),
        lambda out, t: jax_F.cross_entropy(out, t), half_dtype=jhalf,
        loss_scale=1.0)
    tstep = make_train_step(
        tm, FusedSGD(list(tm.parameters()), **hyper),
        lambda out, t: F.cross_entropy(out, t), half_dtype=thalf,
        loss_scale=1.0)
    tm.train()
    init = [_np(p) for p in tm.parameters()]
    with force_mode("interpret"):
        jl = [float(jstep(jnp.asarray(x), jnp.asarray(y)))
              for x, y in batches]
    dispatch.reset_counts()
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for x, y in batches]
    assert dispatch.counts()["fused_sgd"] == 0       # CPU: the plain version
    tol = 1e-5 if half == "float32" else 2e-2
    for a, b in zip(tl, jl):
        assert abs(a - b) <= tol * abs(b), (tl, jl)
    names = [n for n, _ in tm.named_parameters()]
    for name, a, b, p0 in zip(names, tstep.state.master_params,
                              jstep.state.master_params, init):
        if half == "float32":
            assert _rel(a, b) <= tol, name
        else:
            da, db = _np(a) - p0, _np(b) - p0
            assert np.linalg.norm(da - db) <= 0.5 * np.linalg.norm(db), name
    moms = list(zip(tstep.state.opt_state["momentum"],
                    jstep.state.opt_state["momentum"]))
    if half == "float32":
        for name, (a, b) in zip(names, moms):
            assert _rel(a, b) <= tol, name
    else:
        # the fp32 momenta of the same run, the port's (the fp32 case pins
        # them to JAX's)
        _, fm = _models("basic")
        fstep = make_train_step(fm, FusedSGD(list(fm.parameters()), **hyper),
                                lambda out, t: F.cross_entropy(out, t),
                                loss_scale=1.0)
        for x, y in batches:
            fstep(torch.from_numpy(x), torch.from_numpy(y))
        f32 = fstep.state.opt_state["momentum"]

        def dist(side):
            return np.sqrt(sum(np.sum((_np(m[side]) - _np(f)) ** 2)
                               for m, f in zip(moms, f32)))
        assert dist(0) <= 1.25 * dist(1), (dist(0), dist(1))
    jbufs = [n for n, _ in jm.named_buffers()]
    jstats = dict(zip(jbufs, jstep.state.stats))
    for name, b in tm.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(b) == int(jstats[name]) == 4, name
        else:
            assert _rel(b, jstats[name]) <= tol, name
