"""Channels-last (NHWC) execution in the port against the JAX package's,
on the CPU (the counterpart of ``tests/test_channels_last.py``).

The same numpy-seeded inputs and weights go through the JAX function (in
its NHWC layout) and the port's: ``F.conv2d`` / the pools with
``channels_last``, ``F.batch_norm(channel_axis=-1, return_stats=)``, a
ResNet flipped by ``nn.to_channels_last`` (forward, every gradient, eval
on the running statistics), ``SyncBatchNorm(channel_last=True)`` and bf16
``make_train_step`` steps, at the JAX tests' tolerances.  Then what the
port adds to the contract: the layout costs no copy at the boundaries, the
state dict and ``convert_syncbn_model`` keep working, conv weights are
stored channels-last and the masters, slots and amp copies of a flipped
model keep that layout through a step, and the multi-tensor wrappers (B11
SGD, B12 Adam) update channels-last lists where they lie and refuse any
other layout that is not the param's.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
import apex_tpu.nn.functional as jax_F
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.models import resnet as jax_resnet
from apex_tpu.nn.modules import Ctx
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import SyncBatchNorm as JaxSyncBatchNorm
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch import amp, nn, parallel
from apex_tpu_torch.amp._amp_state import reset as reset_amp
from apex_tpu_torch.kernels import multi_tensor
from apex_tpu_torch.kernels.dispatch import same_layout
from apex_tpu_torch.models import (BasicBlock, ResNet, from_jax_state_dict,
                                   resnet18)
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.nn.modules import conv_weights_to
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.training import make_train_step
from torch_products import value_products

torch.set_num_threads(2)

CL = torch.channels_last
NCLS = 10


def _nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def _close(got, want, rtol, atol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("fmt", [torch.contiguous_format, CL],
                         ids=["oihw", "oihw-channels-last-memory"])
@pytest.mark.parametrize("groups", [1, 2])
def test_conv2d_channels_last_matches_jax(rng, groups, fmt):
    """The JAX test's two convolutions (stride 2 with a bias; grouped), NHWC
    in and out, with the OIHW weight in either memory format; the output
    is the permuted view of cuDNN's / oneDNN's channels-last result, so
    it is contiguous (B, H, W, C)."""
    if groups == 1:
        x = rng.standard_normal((2, 5, 12, 12)).astype(np.float32)
        w = rng.standard_normal((7, 5, 3, 3)).astype(np.float32)
        b = rng.standard_normal((7,)).astype(np.float32)
        kw = dict(stride=2, padding=1)
    else:
        x = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
        w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
        b = None
        kw = dict(padding=1, groups=2)
    want = jax_F.conv2d(jnp.asarray(_nhwc(x)), jnp.asarray(w),
                        None if b is None else jnp.asarray(b),
                        channels_last=True, **kw)
    tw = torch.from_numpy(w).contiguous(memory_format=fmt)
    got = F.conv2d(torch.from_numpy(_nhwc(x)), tw,
                   None if b is None else torch.from_numpy(b),
                   channels_last=True, **kw)
    _close(got, want, 1e-5, 1e-5)
    assert got.is_contiguous()
    # and the NCHW call of the same weights, permuted
    nchw = F.conv2d(torch.from_numpy(x), tw,
                    None if b is None else torch.from_numpy(b), **kw)
    _close(got, nchw.permute(0, 2, 3, 1).numpy(), 1e-5, 1e-5)


def test_conv2d_asymmetric_padding_matches_jax(rng):
    x = rng.standard_normal((1, 3, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 2)).astype(np.float32)
    pad = ((0, 2), (1, 0))
    for cl, xin in ((False, x), (True, _nhwc(x))):
        want = jax_F.conv2d(jnp.asarray(xin), jnp.asarray(w), padding=pad,
                            channels_last=cl)
        got = F.conv2d(torch.from_numpy(xin), torch.from_numpy(w),
                       padding=pad, channels_last=cl)
        _close(got, want, 1e-5, 1e-5)


POOLS = [("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
         ("avg_pool2d", dict(kernel_size=2)),
         ("adaptive_avg_pool2d", dict(output_size=(1, 1))),
         ("adaptive_avg_pool2d", dict(output_size=(3, 5)))]


@pytest.mark.parametrize("name,kw", POOLS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(POOLS)])
@pytest.mark.parametrize("cl", [False, True], ids=["nchw", "nhwc"])
def test_pools_match_jax(rng, name, kw, cl):
    x = rng.standard_normal((2, 4, 11, 11)).astype(np.float32)
    xin = _nhwc(x) if cl else x
    want = getattr(jax_F, name)(jnp.asarray(xin), channels_last=cl, **kw)
    got = getattr(F, name)(torch.from_numpy(xin), channels_last=cl, **kw)
    _close(got, want, 1e-5, 1e-5)


def _bn_inputs(rng, c=5):
    x = rng.standard_normal((3, c, 6, 6)).astype(np.float32) + 2.0
    w = rng.standard_normal((c,)).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    rm = rng.standard_normal((c,)).astype(np.float32) * 0.1
    rv = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
    return x, w, b, rm, rv


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_channel_axis_and_return_stats_match_jax(rng, training):
    """``channel_axis=-1`` over NHWC: y, the running statistics, and with
    ``return_stats`` the batch mean and 1/sqrt(var + eps) (the running
    statistics' in eval), within the JAX test's 1e-5 / 1e-6."""
    x, w, b, rm, rv = _bn_inputs(rng)
    j = [jnp.asarray(a) for a in (rm, rv, w, b)]
    t = [torch.from_numpy(a) for a in (rm, rv, w, b)]
    want = jax_F.batch_norm(jnp.asarray(_nhwc(x)), *j, training=training,
                            channel_axis=-1, return_stats=True)
    got = F.batch_norm(torch.from_numpy(_nhwc(x)), *t, training=training,
                       channel_axis=-1, return_stats=True)
    assert len(got) == 5
    _close(got[0], want[0], 1e-5, 1e-5)
    for g, wv in zip(got[1:], want[1:]):
        _close(g, wv, 1e-6, 1e-6)
    # the default return and the NCHW call agree with the NHWC one
    y3 = F.batch_norm(torch.from_numpy(_nhwc(x)), *t, training=training,
                      channel_axis=-1)
    assert len(y3) == 3 and torch.equal(y3[0], got[0])
    nchw = F.batch_norm(torch.from_numpy(x), *t, training=training)
    _close(got[0], nchw[0].permute(0, 2, 3, 1).numpy(), 1e-5, 1e-5)
    _close(got[1], nchw[1].numpy(), 1e-6, 1e-6)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    """The JAX model's weights as numpy arrays (built once per file)."""
    jnn.manual_seed(3)
    jm = jax_resnet.ResNet(jax_resnet.BasicBlock, [1, 1, 1, 1],
                           num_classes=NCLS, small_input=True)
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _jax_model(cl):
    jnn.manual_seed(3)
    jm = jax_resnet.ResNet(jax_resnet.BasicBlock, [1, 1, 1, 1],
                           num_classes=NCLS, small_input=True)
    return jnn.to_channels_last(jm) if cl else jm


def _port_model(cl):
    tm = ResNet(BasicBlock, [1, 1, 1, 1], num_classes=NCLS,
                small_input=True, device="cpu")
    from_jax_state_dict(tm, _jax_weights())
    return nn.to_channels_last(tm) if cl else tm


def _batch(seed=0, b=4, hw=16):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, 3, hw, hw)).astype(np.float32),
            r.integers(0, NCLS, (b,)))


def test_resnet_channels_last_forward_and_grads_match_jax():
    """A BasicBlock ResNet flipped to NHWC on both sides from the same
    weights: logits within 2e-4, the loss within 1e-5 (relative), every
    gradient within rtol 2e-3 / atol 2e-4 (the JAX test's); the running
    statistics it leaves within 1e-5.  The port's NHWC model also agrees
    with its own NCHW model on the same weights, and its conv weights'
    gradients arrive in the weights' channels-last layout."""
    x, y = _batch()
    jm = _jax_model(True)
    jparams = list(jm.parameters())
    jbufs = dict(jm.named_buffers())

    @jax.jit
    def loss_of(vals):
        stats = {}
        ctx = Ctx(env={id(p): v for p, v in zip(jparams, vals)},
                  stats_out=stats, training=True)
        logits = jm.forward(ctx, jnp.asarray(_nhwc(x)))
        return jax_F.cross_entropy(logits, jnp.asarray(y)), (
            logits, {n: stats[id(b)] for n, b in jbufs.items()})

    (jloss, (jlogits, jstats)), jgrads = jax.value_and_grad(
        loss_of, has_aux=True)([p.data for p in jparams])
    runs = {}
    for cl in (True, False):
        tm = _port_model(cl)
        xin = _nhwc(x) if cl else x
        logits = tm(torch.from_numpy(xin))
        loss = F.cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
        runs[cl] = (tm, logits.detach(), loss.item())
    tm, logits, loss = runs[True]
    _close(logits, jlogits, 2e-4, 2e-4)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    for (name, p), g in zip(tm.named_parameters(), jgrads):
        _close(p.grad, g, 2e-3, 2e-4)
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=CL), name
            assert same_layout(p.grad, p), name
    for name, b in tm.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(b) == int(jstats[name]) == 1
        else:
            _close(b, jstats[name], 1e-5, 1e-5)
    nchw, nlogits, _ = runs[False]
    _close(logits, nlogits.numpy(), 2e-4, 2e-4)
    for (name, a), b in zip(tm.named_parameters(), nchw.parameters()):
        _close(a.grad, b.grad.numpy(), 2e-3, 2e-4)


def test_resnet_channels_last_eval_uses_running_stats():
    x, _ = _batch(1, b=2)
    jm = _jax_model(True)
    want = jm.forward(Ctx(training=False), jnp.asarray(_nhwc(x)))
    tm = _port_model(True).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(_nhwc(x)))
    _close(got, want, 1e-4, 1e-5)


def test_to_channels_last_keeps_the_state_dict_and_flips_back():
    """The flip adds no key and changes no value; conv weights go to
    channels-last memory with their shapes, and ``enabled=False`` takes
    the tree back to NCHW, contiguous weights and all."""
    tm = _port_model(False)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    nn.to_channels_last(tm)
    nn.to_channels_last(tm)                 # twice: no second pair of hooks
    after = tm.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    convs = [m for m in tm.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m.channels_last and m.weight.is_contiguous(memory_format=CL)
               for m in convs)
    assert len(tm.conv1._forward_pre_hooks) == 1
    x, _ = _batch(2, b=2)
    tm.eval()
    with torch.no_grad():
        y_cl = tm(torch.from_numpy(_nhwc(x)))
        nn.to_channels_last(tm, enabled=False)
        assert not tm.conv1._forward_pre_hooks and not tm.bn1.channels_last
        assert all(m.weight.is_contiguous() for m in convs)
        y = tm(torch.from_numpy(x))
    _close(y_cl, y.numpy(), 1e-5, 1e-5)


def test_to_channels_last_refuses_layers_without_a_channels_last_path():
    """The JAX test's refusals (ConvTranspose2d; GroupNorm, InstanceNorm2d,
    BatchNorm1d, BatchNorm3d beside a conv) and torch's 1-d and 3-d
    convolutions; the tree is left as it was."""
    gen = torch.nn.Sequential(torch.nn.ConvTranspose2d(4, 8, 4, stride=2),
                              torch.nn.ReLU())
    with pytest.raises(ValueError, match="ConvTranspose2d"):
        nn.to_channels_last(gen)
    for bad in (torch.nn.GroupNorm(2, 4), torch.nn.InstanceNorm2d(4),
                torch.nn.BatchNorm1d(4), torch.nn.BatchNorm3d(4),
                torch.nn.Conv1d(4, 4, 3), torch.nn.Conv3d(4, 4, 3)):
        tree = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), bad)
        with pytest.raises(ValueError, match="channels-last path"):
            nn.to_channels_last(tree)
        assert not getattr(tree[0], "channels_last", False)
        assert tree[0].weight.is_contiguous()


def test_sync_batchnorm_channel_last_matches_jax(rng):
    """``SyncBatchNorm(channel_last=True)`` on one rank normalises NHWC over
    the last axis: output and running statistics against the JAX module's
    (unbound axis: local statistics), and bit for bit torch's BatchNorm2d
    on the permuted view; ``channel_last`` and ``channels_last`` are one
    flag, as there."""
    x = rng.standard_normal((2, 6, 4, 4)).astype(np.float32) * 2 + 1
    jbn = JaxSyncBatchNorm(6, channel_last=True, axis_name="data")
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the JAX module's unbound axis
        want = jbn.forward(Ctx(training=True, stats_out=stats),
                           jnp.asarray(_nhwc(x)))
    sbn = parallel.SyncBatchNorm(6, channel_last=True)
    got = sbn(torch.from_numpy(_nhwc(x)))
    _close(got, want, 1e-5, 1e-5)
    _close(sbn.running_var, stats[id(jbn.running_var)], 1e-5, 1e-6)
    bn = torch.nn.BatchNorm2d(6)
    view = torch.from_numpy(_nhwc(x)).permute(0, 3, 1, 2)
    assert view.is_contiguous(memory_format=CL)
    assert torch.equal(got, bn(view).permute(0, 2, 3, 1))
    assert sbn.channel_last is True and sbn.channels_last is True
    sbn.channel_last = False
    assert sbn.channels_last is False


def test_convert_syncbn_then_to_channels_last():
    """The imagenet example's order: ``convert_syncbn_model(channel_last=
    True)`` then ``to_channels_last``: every BatchNorm is a SyncBatchNorm
    on its own NHWC path (no hooks), and the tree computes what the
    BatchNorm2d tree does in train mode."""
    x, _ = _batch(3, b=2)
    ref = _port_model(True)
    tm = _port_model(False)
    tm = parallel.convert_syncbn_model(tm, channel_last=True)
    nn.to_channels_last(tm)
    sbns = [m for m in tm.modules() if isinstance(m, parallel.SyncBatchNorm)]
    assert len(sbns) == 12
    assert all(m.channel_last and not m._forward_pre_hooks for m in sbns)
    with value_products():      # the two trees' convolutions alike
        got = tm(torch.from_numpy(_nhwc(x)))
        want = ref(torch.from_numpy(_nhwc(x)))
    assert torch.equal(got, want)


def test_resnet_channels_last_bf16_step_matches_jax():
    """The bench's ``nhwc`` arm at a small size: 4 steps of
    ``make_train_step`` (bf16 half copies, BatchNorm fp32, FusedSGD lr 0.05
    momentum 0.9, static scale 1) on the NHWC BasicBlock ResNet, against
    the JAX NHWC step from the same weights and batches: losses within
    5% a step (the JAX test's bound between layouts, bf16 rounding in
    another order), and the loss falls.  The step keeps every conv
    weight's master, momentum and bf16 half copy channels-last."""
    batches = [_batch(7 + i) for i in range(4)]
    jm = _jax_model(True)
    hyper = dict(lr=0.05, momentum=0.9)
    jstep = jax_make_train_step(
        jm, JaxFusedSGD(list(jm.parameters()), **hyper),
        lambda o, t: jax_F.cross_entropy(o, t), half_dtype=jnp.bfloat16,
        loss_scale=1.0)
    tm = _port_model(True)
    tstep = make_train_step(
        tm, FusedSGD(list(tm.parameters()), **hyper),
        lambda o, t: F.cross_entropy(o, t), half_dtype=torch.bfloat16,
        loss_scale=1.0)
    with force_mode("interpret"):
        jl = [float(jstep(jnp.asarray(_nhwc(x)), jnp.asarray(y)))
              for x, y in batches]
    tl = [float(tstep(torch.from_numpy(_nhwc(x)), torch.from_numpy(y)))
          for x, y in batches]
    for a, b in zip(tl, jl):
        assert abs(a - b) / max(abs(b), 1e-6) < 0.05, (tl, jl)
    assert tl[-1] < tl[0]
    st = tstep.state
    for p, m, mom, half in zip(tm.parameters(), st.master_params,
                               st.opt_state["momentum"], st.model_params):
        if p.dim() == 4:
            assert m.is_contiguous(memory_format=CL)
            assert mom.is_contiguous(memory_format=CL)
            assert half.dtype == torch.bfloat16 and \
                half.is_contiguous(memory_format=CL)


def test_train_step_puts_gradients_in_the_masters_layout():
    """Option (ii), conv weights left OIHW-contiguous under NHWC
    activations: whatever layout autograd returns a weight gradient in,
    the step hands the update its master's layout, and it agrees with the
    channels-last step from the same weights."""
    x, y = _batch(11)
    losses, masters = [], []
    for fmt in (torch.contiguous_format, CL):
        tm = conv_weights_to(_port_model(True), fmt)
        step = make_train_step(tm, FusedSGD(list(tm.parameters()), lr=0.05,
                                            momentum=0.9),
                               lambda o, t: F.cross_entropy(o, t),
                               loss_scale=1.0)
        losses.append([float(step(torch.from_numpy(_nhwc(x)),
                                  torch.from_numpy(y))) for _ in range(2)])
        masters.append(step.state.master_params)
        for p, m in zip(tm.parameters(), step.state.master_params):
            if p.dim() == 4:
                assert p.is_contiguous(memory_format=fmt) and \
                    m.is_contiguous(memory_format=fmt)
    assert np.allclose(losses[0], losses[1], rtol=1e-5)
    for a, b in zip(*masters):
        _close(a, b.numpy(), 1e-5, 1e-5)


def test_amp_o2_masters_and_momenta_keep_channels_last():
    """amp O2 (fp16 model, fp32 masters) with FusedSGD over an NHWC
    ResNet-18 at 64 x 64 (the size the CPU's half convolutions stay finite
    at): after two iterations every 4-d fp16 param, its gradient, its fp32
    master and its momentum are channels-last, and the loss is finite."""
    torch.manual_seed(0)
    m = nn.to_channels_last(resnet18(num_classes=NCLS, device="cpu"))
    opt = FusedSGD(list(m.parameters()), lr=0.01, momentum=0.9)
    reset_amp()
    try:
        m, opt = amp.initialize(m, opt, opt_level="O2", verbosity=0,
                                loss_scale=128.0)
        x, y = _batch(12, b=2, hw=64)
        for _ in range(2):
            loss = F.cross_entropy(m(torch.from_numpy(_nhwc(x))).float(),
                                   torch.from_numpy(y))
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            opt.step()
            assert np.isfinite(loss.item())
        stash = opt._amp_stash
        pairs = [(h, mp) for h, mp in zip(stash.all_fp16_params,
                                          stash.all_fp32_from_fp16_params)
                 if h.dim() == 4]
        assert len(pairs) == 20
        for h, mp in pairs:
            assert h.dtype == torch.float16
            for t in (h, h.grad, mp, opt.state[mp]["momentum_buffer"]):
                assert t.is_contiguous(memory_format=CL)
    finally:
        reset_amp()


# --------------------------------------------------------------------------
# B11 / B12: the layout rule of the multi-tensor wrappers
# --------------------------------------------------------------------------

SHAPES = [(8, 4, 3, 3), (6, 3, 7, 7), (16, 8, 1, 1), (5,), (3, 2, 5, 4)]


def _lists(rng, depth, gdtype, copy=None, fmt=torch.contiguous_format):
    """[grads, params, momenta(, copies)] of SHAPES, 4-d ones in ``fmt``."""
    def t(shape, dtype, scale=1.0):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             * scale).to(dtype)
        return a.contiguous(memory_format=fmt) if a.dim() == 4 else a
    ls = [[t(s, gdtype) for s in SHAPES], [t(s, torch.float32)
                                          for s in SHAPES],
          [t(s, torch.float32, 0.1) for s in SHAPES]]
    if depth == 4:
        ls.append([p.to(copy) for p in ls[1]])
    if depth == "adam":
        ls.append([t(s, torch.float32, 0.1).abs() for s in SHAPES])
    return ls


def _as(ls, fmt):
    return [[x.clone(memory_format=fmt if x.dim() == 4 else
                     torch.contiguous_format) for x in lst] for lst in ls]


@pytest.mark.parametrize("depth,gdtype,copy", [
    (3, torch.bfloat16, None), (3, torch.float32, None),
    (4, torch.float32, torch.float16), (4, torch.float16, torch.bfloat16)],
    ids=["d3-bf16", "d3-fp32", "d4-fp16-copy", "d4-bf16-copy"])
def test_sgd_on_channels_last_lists_equals_contiguous_lists(rng, depth,
                                                            gdtype, copy):
    """B11's wrapper on a list whose 4-d tensors are all channels-last
    (gradients, params, momenta, the half copy) gives, bit for bit, what
    it gives on contiguous lists of the same values, and leaves every
    tensor in its layout."""
    base = _lists(rng, depth, gdtype, copy)
    flag = torch.zeros((), dtype=torch.int32)
    out = {}
    for fmt in (torch.contiguous_format, CL):
        ls = _as(base, fmt)
        multi_tensor.fused_sgd(flag, ls, 1e-4, 0.9, 0.0, 0.1, False, False,
                               False, 0.5)
        assert all(x.is_contiguous(memory_format=fmt) for lst in ls
                   for x in lst if x.dim() == 4)
        out[fmt] = ls
    for a, b in zip(out[CL][1:], out[torch.contiguous_format][1:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(out[CL][1][0], base[1][0])


@pytest.mark.parametrize("pdtype", [torch.float32, torch.float16])
def test_adam_on_channels_last_lists_equals_contiguous_lists(rng, pdtype):
    """B12's wrapper likewise (fp32 params and bf16 gradients; half params
    and moments, amp O3's)."""
    g, p, m, v = _lists(rng, "adam", torch.bfloat16)
    base = [g, [x.to(pdtype) for x in p], [x.to(pdtype) for x in m],
            [x.to(pdtype) for x in v]]
    flag = torch.zeros((), dtype=torch.int32)
    out = {}
    for fmt in (torch.contiguous_format, CL):
        ls = _as(base, fmt)
        multi_tensor.fused_adam(flag, ls, 1e-3, 0.9, 0.999, 1e-8, 3, 1, True,
                                0.01)
        assert all(x.is_contiguous(memory_format=fmt) for lst in ls
                   for x in lst if x.dim() == 4)
        out[fmt] = ls
    for a, b in zip(out[CL][1:], out[torch.contiguous_format][1:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_wrappers_refuse_lists_off_the_params_layout(rng):
    """A gradient, momentum, copy or moment in another layout than its
    param raises, naming the tensor (nothing is copied into the param's
    layout), and so does a param that is not dense."""
    flag = torch.zeros((), dtype=torch.int32)
    sgd_args = (1e-4, 0.9, 0.0, 0.1, False, False, False)
    cases = []
    for i, what in ((0, "gradient 0"), (2, "momentum 0"),
                    (3, "model param 0")):
        ls = _as(_lists(rng, 4, torch.float32, torch.float16), CL)
        ls[i][0] = ls[i][0].contiguous()
        cases.append((ls, what))
    for ls, what in cases:
        with pytest.raises(ValueError, match=what):
            multi_tensor.fused_sgd(flag, ls, *sgd_args)
    ls = _lists(rng, 3, torch.float32)
    ls = [[x[:, :2] if x.dim() == 4 else x for x in lst] for lst in ls]
    with pytest.raises(ValueError, match="param 0 .* is not dense"):
        multi_tensor.fused_sgd(flag, ls, *sgd_args)
    g, p, m, v = _lists(rng, "adam", torch.float32, fmt=CL)
    v[1] = v[1].contiguous()
    with pytest.raises(ValueError, match="exp_avg_sq 1"):
        multi_tensor.fused_adam(flag, [g, p, m, v], 1e-3, 0.9, 0.999, 1e-8,
                                1, 1, True, 0.0)
    # a 1 x 1 kernel is one layout in either format: accepted
    w = torch.randn(16, 8, 1, 1)
    lists = [[w.contiguous(memory_format=CL)], [w.clone()],
             [torch.zeros_like(w)]]
    multi_tensor.fused_sgd(flag, lists, *sgd_args)
