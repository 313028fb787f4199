"""amp O1 of the port against the JAX package's, on the CPU.

* The cast policy: ``CastPolicy.cast_args`` of both packages over a matrix
  of ops (each category, banned, unlisted) and argument dtypes, and the
  cases of ``tests/test_policy.py`` on the port (no policy, disable_casts,
  the registry, the decorators).
* The torch-function mode that applies the policy to torch ops inside a
  module call: the operators, in-place ops, integer arguments, one cast
  per call, exceptions, and ``reset()``.
* The op-dtype trace of one O1 forward, op for op: ``ResNet(BasicBlock,
  [1, 1, 1, 1], num_classes=10, small_input=True)`` at 2 x 3 x 16 x 16 with
  its cross-entropy loss, and the DCGAN networks of
  ``examples/dcgan/main_amp.py`` at nz 16, ngf = ndf = 8, batch 4 with
  BCE-with-logits.  Each side's trace is recorded by wrapping its
  ``CastPolicy.cast_args``: each op whose category fixes a dtype (half,
  float, banned) and each promote or sequence op over mixed float dtypes,
  with the dtype its arguments leave with.  A promote op over one float
  dtype is the identity under any policy, and the JAX package's module
  bodies add raw jnp arrays without asking the policy, so neither side
  records one.
* The port's fused modules under O1: their bodies are one op, not cast.
* The loops: 4 O1 iterations of the ResNet loop (``FusedSGD``) and of the
  three-loss DCGAN loop (two ``FusedAdam``, ``num_losses=3``), weights
  carried across by ``from_jax_state_dict``, losses and fp32 weights
  within the JAX amp test's ``rtol=0.05``; a non-finite gradient planted
  in the D-fake backward gives the same (skipped, scale) history on both
  sides.
* The legacy API (``amp.init``, ``AmpHandle``, ``OptimWrapper``): the
  cases of ``tests/test_amp_opt.py`` on the port, and a loop against JAX.
* ``DistributedDataParallel`` over an O1 model (one gloo rank): the casts
  run once, under the wrapped model's policy.
"""
import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import apex_tpu.nn as jnn
from apex_tpu import amp as jamp
from apex_tpu.amp import policy as jpolicy
from apex_tpu.amp._amp_state import reset as jax_reset
from apex_tpu.models import resnet as jax_resnet
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD

from apex_tpu_torch import amp
from apex_tpu_torch.amp import policy
from apex_tpu_torch.amp._amp_state import _amp_state
from apex_tpu_torch.amp._amp_state import reset as port_reset
from apex_tpu_torch.amp.opt import OptimWrapper
from apex_tpu_torch.models import BasicBlock, ResNet, from_jax_state_dict
from apex_tpu_torch.models.dcgan import build_discriminator, build_generator
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 0.05        # the JAX amp test's tolerance for O1 against O0


@pytest.fixture(autouse=True)
def _fresh_amp():
    jax_reset()
    port_reset()
    yield
    jax_reset()
    port_reset()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    """max |a - b| / max(1, max |b|)."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max(initial=0.0) / max(1.0, np.abs(b).max(
        initial=0.0))


# ---------------------------------------------------------------------------
# the cast policy against the JAX package's
# ---------------------------------------------------------------------------

_DT = {"f16": (jnp.float16, torch.float16), "bf16": (jnp.bfloat16,
                                                      torch.bfloat16),
       "f32": (jnp.float32, torch.float32), "i32": (jnp.int32, torch.int32)}

# (op, argument dtypes, wrap the arguments in one list: a sequence op)
POLICY_CASES = [
    ("linear", ("f32", "f32"), False), ("linear", ("f32", "i32"), False),
    ("conv2d", ("f32",), False), ("softmax", ("f16",), False),
    ("batch_norm", ("f16", "f32"), False), ("sum", ("bf16",), False),
    ("relu", ("f16",), False), ("add", ("f16", "f32"), False),
    ("add", ("f16", "f16"), False), ("mul", ("f16", "bf16"), False),
    ("eq", ("i32", "i32"), False), ("cat", ("f16", "f32"), True),
    ("stack", ("bf16", "bf16"), True),
]


def _args(dtypes, as_list, side):
    xs = [jnp.ones((2, 2), _DT[d][0]) if side == "jax"
          else torch.ones((2, 2), dtype=_DT[d][1]) for d in dtypes]
    return (xs,) if as_list else tuple(xs)


def _dtypes(tree, side):
    if side == "jax":
        return [jnp.dtype(x.dtype).name for x in jax.tree_util.tree_leaves(
            tree)]
    flat = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            flat.append(str(t.dtype).replace("torch.", ""))
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
    walk(tree)
    return flat


@pytest.mark.parametrize("half", ["f16", "bf16"])
@pytest.mark.parametrize("op,dtypes,as_list", POLICY_CASES,
                         ids=[f"{c[0]}-{'-'.join(c[1])}" for c in POLICY_CASES])
def test_cast_args_matches_jax(op, dtypes, as_list, half):
    jp = jpolicy.CastPolicy(half_dtype=_DT[half][0])
    tp = policy.CastPolicy(half_dtype=_DT[half][1])
    assert tp.category_of(op) == jp.category_of(op)
    ja, _ = jp.cast_args(op, _args(dtypes, as_list, "jax"))
    ta, _ = tp.cast_args(op, _args(dtypes, as_list, "torch"))
    assert _dtypes(ta, "torch") == _dtypes(ja, "jax")


@pytest.mark.parametrize("allow", [False, True])
def test_banned_binary_cross_entropy(allow):
    for side, pol_cls, x in (
            ("jax", jpolicy.CastPolicy, jnp.ones((4,), jnp.float16)),
            ("port", policy.CastPolicy, torch.ones(4, dtype=torch.float16))):
        pol = pol_cls(allow_banned=allow)
        if allow:
            args, _ = pol.cast_args("binary_cross_entropy", (x,))
            assert _dtypes(args, "jax" if side == "jax" else "torch") == [
                "float16"]
        else:
            with pytest.raises(NotImplementedError, match="binary_cross"):
                pol.cast_args("binary_cross_entropy", (x,))


def test_widest_float_dtype_matches_jax():
    combos = [("f16",), ("f16", "f32"), ("f16", "bf16"), ("bf16", "bf16"),
              ("i32",), ("i32", "bf16")]
    for combo in combos:
        j = jpolicy.widest_float_dtype(_args(combo, False, "jax"))
        t = policy.widest_float_dtype(_args(combo, False, "torch"))
        assert (None if j is None else jnp.dtype(j).name) == (
            None if t is None else str(t).replace("torch.", ""))


def test_no_policy_and_disable_casts():
    x = torch.ones(4, 4)
    assert policy.apply_op_policy("linear", (x,))[0][0].dtype == torch.float32
    pol = policy.CastPolicy()
    with policy.autocast(pol):
        assert policy.current_policy() is pol
        assert policy.apply_op_policy("linear", (x,))[0][0].dtype \
            == torch.float16
        with policy.disable_casts():
            assert policy.casts_disabled()
            assert policy.apply_op_policy("linear", (x,))[0][0].dtype \
                == torch.float32
    assert policy.current_policy() is None and not policy.casts_disabled()
    disabled = policy.CastPolicy(enabled=False)
    with policy.autocast(disabled):
        assert policy.apply_op_policy("linear", (x,))[0][0].dtype \
            == torch.float32


def test_register_half_function_on_user_module():
    """A registration reaches the policies active now and, replayed, one
    made later (the JAX test's module, ``tests/test_policy.py``)."""
    mod = types.SimpleNamespace(myop=lambda x: x)
    pol = policy.CastPolicy()
    n0 = len(policy._pending_registrations)
    try:
        policy.register_half_function(mod, "myop")
        x = torch.ones(4)
        with policy.autocast(pol):
            assert mod.myop(x).dtype == torch.float32
        pol2 = policy.CastPolicy()
        policy.replay_registrations(pol2)
        with policy.autocast(pol2):
            assert mod.myop(x).dtype == torch.float16
        assert mod.myop(x).dtype == torch.float32     # no active policy
        mod2 = types.SimpleNamespace(f=lambda x: x, p=lambda a, b: a + b)
        policy.register_float_function(mod2, "f")
        policy.register_promote_function(mod2, "p")
        pol3 = policy.CastPolicy()
        policy.replay_registrations(pol3)
        with policy.autocast(pol3):
            assert mod2.f(x.half()).dtype == torch.float32
            assert mod2.p(x.half(), x).dtype == torch.float32
    finally:
        del policy._pending_registrations[n0:]


def test_decorators():
    @policy.half_function
    def h(x):
        return x

    @policy.float_function
    def f(x):
        return x

    @policy.promote_function
    def p(a, b):
        return a, b

    x32, x16 = torch.ones(2), torch.ones(2, dtype=torch.float16)
    with policy.autocast(policy.CastPolicy()):
        assert h(x32).dtype == torch.float16
        assert f(x16).dtype == torch.float32
        assert [t.dtype for t in p(x16, x32)] == [torch.float32] * 2
    assert h(x32).dtype == torch.float32
    assert f(x16).dtype == torch.float16


# ---------------------------------------------------------------------------
# the torch-function mode
# ---------------------------------------------------------------------------

def test_mode_casts_torch_ops_in_a_scope():
    a = torch.randn(3, 4)
    b = torch.randn(3, 4, dtype=torch.float16)
    w = torch.randn(5, 4)
    idx = torch.tensor([0, 2])
    with policy.autocast(policy.CastPolicy()):
        assert torch.nn.functional.linear(a, w).dtype == torch.float16
        assert (a @ w.t()).dtype == torch.float16
        assert torch.softmax(b, -1).dtype == torch.float32
        assert b.sum().dtype == torch.float32
        assert (a + b).dtype == torch.float32 and (b + a).dtype == \
            torch.float32
        assert (2.0 * b).dtype == torch.float16          # reflected, one dtype
        assert torch.cat([a, b]).dtype == torch.float32
        assert torch.cat([idx, idx]).dtype == torch.int64   # integers alone
        assert torch.index_select(a, 0, idx).dtype == torch.float32
        c = b.clone()
        c += a                      # in place: runs as torch runs it
        assert c.dtype == torch.float16
        c.mul_(a)
        assert c.dtype == torch.float16
        assert torch.relu(b).dtype == torch.float16    # on no list
    assert torch.nn.functional.linear(a, w).dtype == torch.float32
    assert policy._mode == [] and policy._policy_stack == []


def test_one_cast_per_call(monkeypatch):
    """The ops inside one mapped torch call (``F.cross_entropy``'s
    ``log_softmax`` and ``nll_loss``) are not seen again."""
    seen = []
    orig = policy.CastPolicy.cast_args

    def rec(self, op, args, kwargs=None):
        seen.append(op)
        return orig(self, op, args, kwargs)
    monkeypatch.setattr(policy.CastPolicy, "cast_args", rec)
    logits = torch.randn(4, 5, dtype=torch.float16)
    with policy.autocast(policy.CastPolicy()):
        loss = torch.nn.functional.cross_entropy(logits, torch.tensor(
            [0, 1, 2, 3]))
    assert seen == ["cross_entropy"] and loss.dtype == torch.float32


def test_module_scope_and_exceptions():
    class Boom(nn.Module):
        def forward(self, x):
            raise ValueError("boom")

    model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    opt = FusedSGD(list(model.parameters()), lr=0.1)
    model, opt = amp.initialize(model, opt, opt_level="O1", verbosity=0)
    x = torch.randn(3, 4)
    assert model(x).dtype == torch.float16
    # outside a module call nothing is cast
    assert torch.nn.functional.linear(x, model[0].weight).dtype \
        == torch.float32
    with pytest.raises(ValueError, match="boom"):
        nn.Sequential(nn.Linear(4, 4), Boom())(x)
    assert policy._frames == [] and policy._policy_stack == [] \
        and policy._mode == []
    assert model(x).dtype == torch.float16
    with amp.disable_casts():
        assert model(x).dtype == torch.float32
    # the weights and their gradients stay fp32
    with amp.scale_loss(model(x).float().sum(), opt) as scaled:
        scaled.backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())


def test_reset_removes_the_session():
    model = nn.Sequential(nn.Linear(4, 8), nn.Linear(8, 2))
    opt = FusedSGD(list(model.parameters()), lr=0.1)
    model, opt = amp.initialize(model, opt, opt_level="O1", verbosity=0)
    assert policy._hooks and _amp_state.ambient_policy is not None
    port_reset()
    assert not policy._hooks and _amp_state.ambient_policy is None
    plain = nn.Linear(4, 2)
    assert plain(torch.randn(3, 4)).dtype == torch.float32
    # a fresh O2 session clears O1's ambient policy and hooks too
    model2 = nn.Sequential(nn.Linear(4, 8))
    amp.initialize(model2, FusedSGD(list(model2.parameters()), lr=0.1),
                   opt_level="O1", verbosity=0)
    assert policy._hooks
    model3 = nn.Sequential(nn.Linear(4, 8))
    amp.initialize(model3, FusedSGD(list(model3.parameters()), lr=0.1),
                   opt_level="O2", verbosity=0)
    assert not policy._hooks and _amp_state.ambient_policy is None


def test_fused_steps_run_outside_the_session_policy():
    """make_train_step and make_gan_train_step cast only by their
    half_dtype, as the JAX steps run their forwards outside the tape's
    policy, even while an O1 session is on."""
    from apex_tpu_torch.training import make_gan_train_step, make_train_step
    m = nn.Sequential(nn.Linear(4, 8))
    amp.initialize(m, FusedSGD(list(m.parameters()), lr=0.1),
                   opt_level="O1", verbosity=0)
    assert m(torch.randn(2, 4)).dtype == torch.float16
    seen = []

    def loss_fn(out, y):
        seen.append(out.dtype)
        return ((out - y) ** 2).mean()
    net = nn.Sequential(nn.Linear(4, 2))
    step = make_train_step(net, FusedSGD(list(net.parameters()), lr=0.1),
                           loss_fn)
    step(torch.randn(3, 4), torch.randn(3, 2))
    d, g = nn.Sequential(nn.Linear(2, 1)), nn.Sequential(nn.Linear(4, 2))

    def d_loss(r, f):
        seen.append(r.dtype)
        return (r - 1).pow(2).mean() + f.pow(2).mean()
    gan = make_gan_train_step(
        d, g, FusedAdam(list(d.parameters())), FusedAdam(list(g.parameters())),
        d_loss, lambda f: (f - 1).pow(2).mean(), loss_scale=1.0)
    gan(torch.randn(3, 2), torch.randn(3, 4))
    assert seen == [torch.float32, torch.float32]


# ---------------------------------------------------------------------------
# the op-dtype trace of one O1 forward, op for op
# ---------------------------------------------------------------------------

def _recorder(monkeypatch, pol_cls, side):
    trace = []
    orig = pol_cls.cast_args

    def rec(self, op, args, kwargs=None):
        a, k = orig(self, op, args, kwargs)
        cat = self.category_of(op)
        if side == "jax":
            leaves_in = [x for x in jax.tree_util.tree_leaves(
                (args, kwargs)) if hasattr(x, "dtype")
                and jnp.issubdtype(x.dtype, jnp.floating)]
            ins = {jnp.dtype(x.dtype).name for x in leaves_in}
            outs = sorted({jnp.dtype(x.dtype).name
                           for x in jax.tree_util.tree_leaves((a, k))
                           if hasattr(x, "dtype")
                           and jnp.issubdtype(x.dtype, jnp.floating)})
        else:
            ins = {str(x.dtype) for x in policy._float_leaves(
                (args, kwargs), [])}
            outs = sorted({str(x.dtype).replace("torch.", "")
                           for x in policy._float_leaves((a, k), [])})
        if cat in ("half", "float", "banned") or len(ins) > 1:
            trace.append((op, tuple(outs)))
        return a, k
    monkeypatch.setattr(pol_cls, "cast_args", rec)
    return trace


@functools.lru_cache(maxsize=None)
def _jax_resnet_sd():
    jnn.manual_seed(3)
    jm = jax_resnet.ResNet(jax_resnet.BasicBlock, [1, 1, 1, 1],
                           num_classes=10, small_input=True)
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _resnets():
    jnn.manual_seed(3)
    jm = jax_resnet.ResNet(jax_resnet.BasicBlock, [1, 1, 1, 1],
                           num_classes=10, small_input=True)
    tm = ResNet(BasicBlock, [1, 1, 1, 1], num_classes=10, small_input=True,
                device="cpu")
    return jm, from_jax_state_dict(tm, _jax_resnet_sd())


def _dcgan_example():
    spec = importlib.util.spec_from_file_location(
        "_dcgan_example", os.path.join(REPO, "examples", "dcgan",
                                       "main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NZ, NGF, NDF, GB = 16, 8, 8, 4


@functools.lru_cache(maxsize=None)
def _jax_dcgan_sds():
    ex = _dcgan_example()
    jnn.manual_seed(0)
    jg, jd = ex.build_generator(NZ, NGF), ex.build_discriminator(NDF)
    return ({k: np.asarray(v) for k, v in jg.state_dict().items()},
            {k: np.asarray(v) for k, v in jd.state_dict().items()})


def _dcgans():
    ex = _dcgan_example()
    jnn.manual_seed(0)
    jg, jd = ex.build_generator(NZ, NGF), ex.build_discriminator(NDF)
    gsd, dsd = _jax_dcgan_sds()
    tg = from_jax_state_dict(build_generator(NZ, NGF, device="cpu"), gsd)
    td = from_jax_state_dict(build_discriminator(NDF, device="cpu"), dsd)
    return jg, jd, tg, td


def test_resnet_o1_trace_matches_jax(monkeypatch):
    jm, tm = _resnets()
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 3, 16, 16)).astype(np.float32)
    y = r.integers(0, 10, (2,))
    jm, _ = jamp.initialize(jm, JaxFusedSGD(list(jm.parameters()), lr=0.1),
                            opt_level="O1", verbosity=0)
    tm, _ = amp.initialize(tm, FusedSGD(list(tm.parameters()), lr=0.1),
                           opt_level="O1", verbosity=0)
    jt = _recorder(monkeypatch, jpolicy.CastPolicy, "jax")
    tt = _recorder(monkeypatch, policy.CastPolicy, "torch")
    jout = jm(jnp.asarray(x))
    jloss = jnn.CrossEntropyLoss()(jout, jnp.asarray(y))
    tout = tm(torch.from_numpy(x))
    tloss = nn.CrossEntropyLoss()(tout, torch.from_numpy(y))
    assert len(tt) == 2 * 12 + 2 and tt == jt
    assert tout.dtype == torch.float16 and tloss.dtype == torch.float32
    assert jnp.dtype(jout.dtype).name == "float16"
    # fp16 convolutions on both sides: logits within fp16 rounding of the
    # batch-statistics forward, the loss within 1e-3
    assert _rel(tout, jout.value) < 2e-2
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)


def test_dcgan_o1_trace_matches_jax(monkeypatch):
    jg, jd, tg, td = _dcgans()
    z = np.random.default_rng(1).standard_normal((GB, NZ, 1, 1)).astype(
        np.float32)
    [jd, jg], _ = jamp.initialize(
        [jd, jg], [JaxFusedAdam(list(jd.parameters())),
                   JaxFusedAdam(list(jg.parameters()))],
        opt_level="O1", num_losses=3, verbosity=0)
    [td, tg], _ = amp.initialize(
        [td, tg], [FusedAdam(list(td.parameters())),
                   FusedAdam(list(tg.parameters()))],
        opt_level="O1", num_losses=3, verbosity=0)
    jt = _recorder(monkeypatch, jpolicy.CastPolicy, "jax")
    tt = _recorder(monkeypatch, policy.CastPolicy, "torch")
    jfake = jg(jnp.asarray(z))
    jout = jd(jfake)
    jloss = jnn.BCEWithLogitsLoss()(jout, jnp.ones((GB,), jnp.float32))
    tfake = tg(torch.from_numpy(z))
    tout = td(tfake)
    tloss = nn.BCEWithLogitsLoss()(tout, torch.ones(GB))
    assert len(tt) == 4 + 3 + 4 + 2 + 1 and tt == jt
    assert tfake.dtype == torch.float16 and tout.shape == (GB,)
    assert _rel(tfake, jfake.value) < 2e-2
    assert _rel(tout, jout.value) < 2e-2
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)


# ---------------------------------------------------------------------------
# the fused modules are one op
# ---------------------------------------------------------------------------

def _fused_pair(kind):
    """(JAX model, port model) of Linear(16, 16) then the fused module."""
    from apex_tpu.normalization import FusedLayerNorm as JLN
    from apex_tpu.normalization import FusedRMSNorm as JRMS

    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
    jnn.manual_seed(5)
    jfused, tfused = {"layer_norm": (JLN(16), FusedLayerNorm(16,
                                                            device="cpu")),
                      "rms_norm": (JRMS(16), FusedRMSNorm(16, device="cpu"))
                      }[kind]
    jm = jnn.Sequential(jnn.Linear(16, 16), jfused)
    tm = nn.Sequential(nn.Linear(16, 16), tfused)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(tm, sd)


@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_fused_norm_under_o1_matches_jax(kind, monkeypatch):
    jm, tm = _fused_pair(kind)
    x = np.random.default_rng(2).standard_normal((6, 16)).astype(np.float32)
    jm, _ = jamp.initialize(jm, JaxFusedSGD(list(jm.parameters()), lr=0.1),
                            opt_level="O1", verbosity=0)
    tm, _ = amp.initialize(tm, FusedSGD(list(tm.parameters()), lr=0.1),
                           opt_level="O1", verbosity=0)
    jt = _recorder(monkeypatch, jpolicy.CastPolicy, "jax")
    tt = _recorder(monkeypatch, policy.CastPolicy, "torch")
    jout, tout = jm(jnp.asarray(x)), tm(torch.from_numpy(x))
    assert tt == jt == [("linear", ("float16",))]
    assert str(tout.dtype).replace("torch.", "") == jnp.dtype(
        jout.dtype).name
    assert _rel(tout, jout.value) < 1e-3


def test_fused_ops_bodies_are_not_cast(monkeypatch):
    """SoftmaxCrossEntropyLoss and the attention module's body ask the
    policy nothing, as their JAX counterparts are single ops."""
    from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
    from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss

    seen = []
    orig = policy.CastPolicy.cast_args

    def rec(self, op, args, kwargs=None):
        seen.append(op)
        return orig(self, op, args, kwargs)
    monkeypatch.setattr(policy.CastPolicy, "cast_args", rec)

    class Head(nn.Module):
        def forward(self, logits, labels):
            return SoftmaxCrossEntropyLoss.apply(logits, labels, 0.1, -1,
                                                 True)
    handle = amp.init()
    logits = torch.randn(6, 11, dtype=torch.float16)
    labels = torch.randint(0, 11, (6,))
    losses = Head()(logits, labels)
    with amp.disable_casts():
        want = Head()(logits, labels)
    assert seen == [] and losses.dtype == torch.float32
    torch.testing.assert_close(losses, want, rtol=0, atol=0)
    attn = SelfMultiheadAttn(16, 2, device="cpu")
    q = torch.randn(5, 2, 16)
    out = attn(q, q, q)[0]
    assert seen == [] and out.dtype == torch.float32
    handle._deactivate()


# ---------------------------------------------------------------------------
# the O1 loops against JAX
# ---------------------------------------------------------------------------

def test_resnet_o1_loop_matches_jax():
    jm, tm = _resnets()
    r = np.random.default_rng(4)
    x = r.standard_normal((4, 3, 16, 16)).astype(np.float32)
    y = r.integers(0, 10, (4,))
    jopt = JaxFusedSGD(list(jm.parameters()), lr=0.05, momentum=0.9,
                       weight_decay=5e-4)
    topt = FusedSGD(list(tm.parameters()), lr=0.05, momentum=0.9,
                    weight_decay=5e-4)
    jm, jopt = jamp.initialize(jm, jopt, opt_level="O1", verbosity=0)
    tm, topt = amp.initialize(tm, topt, opt_level="O1", verbosity=0)
    jl, tl = [], []
    for _ in range(4):
        loss = jnn.CrossEntropyLoss()(jm(jnp.asarray(x)), jnp.asarray(y))
        with jamp.scale_loss(loss, jopt) as scaled:
            scaled.backward()
        jopt.step()
        jopt.zero_grad()
        jl.append(float(loss))
        loss = nn.CrossEntropyLoss()(tm(torch.from_numpy(x)),
                                     torch.from_numpy(y))
        with amp.scale_loss(loss, topt) as scaled:
            scaled.backward()
        topt.step()
        topt.zero_grad()
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]
    jsd = jm.state_dict()
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32
        assert _rel(p, np.asarray(jsd[name])) < RTOL, name


def _dcgan_loop(side, nets, iters, plant_at):
    """The three-loss iteration of examples/dcgan/main_amp.py; returns the
    losses and, per iteration, whether each optimizer skipped and the
    three scales."""
    g, d = nets
    if side == "jax":
        A, opt_cls = jamp, JaxFusedAdam
        crit = jnn.BCEWithLogitsLoss()

        def tensor(a):
            return jnp.asarray(a)

        def full(v):
            return jnp.full((GB,), v, jnp.float32)

        def plant(p):
            p.grad = p.grad.at[(0,) * p.grad.ndim].set(jnp.inf)

        def scales():
            from apex_tpu.amp._amp_state import _amp_state as st
            return tuple(s.loss_scale() for s in st.loss_scalers)
    else:
        A, opt_cls = amp, FusedAdam
        crit = nn.BCEWithLogitsLoss()

        def tensor(a):
            return torch.from_numpy(a)

        def full(v):
            return torch.full((GB,), v)

        def plant(p):
            p.grad[(0,) * p.grad.dim()] = float("inf")

        def scales():
            return tuple(s.loss_scale() for s in _amp_state.loss_scalers)
    optD = opt_cls(list(d.parameters()), lr=2e-4, betas=(0.5, 0.999))
    optG = opt_cls(list(g.parameters()), lr=2e-4, betas=(0.5, 0.999))
    [d, g], [optD, optG] = A.initialize([d, g], [optD, optG],
                                        opt_level="O1", num_losses=3,
                                        verbosity=0)
    r = np.random.default_rng(7)
    losses, hist = [], []
    for it in range(iters):
        real = tensor(r.standard_normal((GB, 3, 32, 32)).astype(np.float32))
        noise = tensor(r.standard_normal((GB, NZ, 1, 1)).astype(np.float32))
        optD.zero_grad()
        errD_real = crit(d(real), full(1.0))
        with A.scale_loss(errD_real, optD, loss_id=0) as s:
            s.backward()
        fake = g(noise)
        errD_fake = crit(d(fake.detach()), full(0.0))
        with A.scale_loss(errD_fake, optD, loss_id=1) as s:
            s.backward()
            if it == plant_at:
                plant(next(iter(d.parameters())))
        d_skip = optD._amp_stash.already_patched
        optD.step()
        optG.zero_grad()
        errG = crit(d(fake), full(1.0))
        with A.scale_loss(errG, optG, loss_id=2) as s:
            s.backward()
        g_skip = optG._amp_stash.already_patched
        optG.step()
        losses.append((float(errD_real), float(errD_fake), float(errG)))
        hist.append((d_skip, g_skip, scales()))
    return losses, hist, (g, d)


def test_dcgan_o1_three_loss_loop_matches_jax():
    jg, jd, tg, td = _dcgans()
    jl, jh, (jg, jd) = _dcgan_loop("jax", (jg, jd), 4, plant_at=1)
    tl, th, (tg, td) = _dcgan_loop("port", (tg, td), 4, plant_at=1)
    # the histories agree entry for entry; at iteration 1 the planted
    # gradient skips D's step only and halves scaler 1 only (at this
    # width the last convolution's fp16 weight gradient also overflows at
    # 2^16 by itself in iteration 0, on both sides)
    assert th == jh
    (d0, g0, s0), (d1, g1, s1) = th[0], th[1]
    assert d1 and not g1
    assert s1 == (s0[0], s0[1] / 2, s0[2])
    np.testing.assert_allclose(np.array(tl), np.array(jl), rtol=RTOL)
    for tnet, jnet in ((tg, jg), (td, jd)):
        jsd = jnet.state_dict()
        for name, p in tnet.named_parameters():
            assert p.dtype == torch.float32
            assert _rel(p, np.asarray(jsd[name])) < RTOL, name


def test_ddp_applies_the_casts_once(monkeypatch):
    import torch.distributed as dist

    from apex_tpu_torch import parallel
    from apex_tpu_torch.parallel.distributed import DistributedDataParallel
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    parallel.init_distributed(f"127.0.0.1:{port}", num_processes=1,
                              process_id=0, device="cpu", timeout_s=60)
    try:
        torch.manual_seed(0)
        model = nn.Sequential(nn.Linear(10, 32), nn.ReLU(), nn.Linear(32, 2))
        opt = FusedSGD(list(model.parameters()), lr=0.1, momentum=0.9)
        model, opt = amp.initialize(model, opt, opt_level="O1", verbosity=0)
        ddp = DistributedDataParallel(model)
        assert ddp._amp_policy is model._amp_policy
        trace = _recorder(monkeypatch, policy.CastPolicy, "torch")
        x = torch.randn(8, 10)
        out = ddp(x)
        assert trace == [("linear", ("float16",))] * 2
        assert out.dtype == torch.float16
        # the example's toy loop: MSE, 20 steps, the loss falls
        y = torch.randn(8, 2)
        losses = []
        for _ in range(20):
            loss = nn.MSELoss()(ddp(x), y)
            opt.zero_grad()
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            opt.step()
            losses.append(float(loss))
        assert loss.dtype == torch.float32 and losses[-1] < losses[0]
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the legacy API: amp.init, AmpHandle, OptimWrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mlp_sd():
    jnn.manual_seed(7)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _mlp():
    m = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    return from_jax_state_dict(m, _jax_mlp_sd())


def _data(seed=0):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal((8, 16)).astype(np.float32)),
            torch.from_numpy(r.integers(0, 4, (8,))))


def test_legacy_loop_matches_jax():
    jnn.manual_seed(7)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    jh = jamp.init()
    jopt = jh.wrap_optimizer(JaxFusedSGD(list(jm.parameters()), lr=0.1))
    jl = []
    x, y = _data()
    for _ in range(5):
        loss = jnn.CrossEntropyLoss()(jm(jnp.asarray(x.numpy())),
                                      jnp.asarray(y.numpy()))
        with jopt.scale_loss(loss) as scaled:
            scaled.backward()
        jopt.step()
        jopt.zero_grad()
        jl.append(float(loss))
    jh._deactivate()
    model = _mlp()
    handle = amp.init(verbose=False)
    opt = handle.wrap_optimizer(FusedSGD(list(model.parameters()), lr=0.1))
    assert isinstance(opt, OptimWrapper)
    tl = []
    for _ in range(5):
        out = model(x)
        assert out.dtype == torch.float16
        loss = nn.CrossEntropyLoss()(out, y)
        with opt.scale_loss(loss) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        tl.append(float(loss))
    handle._deactivate()
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]


def test_scale_loss_scales_by_scaler():
    handle = amp.init()
    model = _mlp()
    opt = handle.wrap_optimizer(FusedSGD(list(model.parameters()), lr=0.1))
    x, y = _data()
    loss = nn.CrossEntropyLoss()(model(x), y)
    with opt.scale_loss(loss) as scaled:
        np.testing.assert_allclose(float(scaled), float(loss) * 2.0 ** 16,
                                   rtol=1e-6)
        scaled.backward()
    handle._deactivate()


def test_multi_loss_grads_accumulate():
    """Two losses through num_loss=2 give the gradients of their sum
    computed without amp, within fp16 tolerances."""
    handle = amp.init()
    model = _mlp()
    params = list(model.parameters())
    opt = handle.wrap_optimizer(FusedSGD(params, lr=0.1), num_loss=2)
    (x1, y1), (x2, y2) = _data(1), _data(2)
    with opt.scale_loss(nn.CrossEntropyLoss()(model(x1), y1)) as scaled:
        scaled.backward()
    with opt.scale_loss(nn.CrossEntropyLoss()(model(x2), y2)) as scaled:
        scaled.backward()
    amp_grads = [p.grad.clone() for p in params]
    opt.zero_grad()
    handle._deactivate()
    model2 = _mlp()
    loss = nn.CrossEntropyLoss()(model2(x1), y1) \
        + nn.CrossEntropyLoss()(model2(x2), y2)
    loss.backward()
    for a, p in zip(amp_grads, model2.parameters()):
        np.testing.assert_allclose(_np(a), _np(p.grad), rtol=2e-2, atol=3e-4)


def test_overflow_skips_step_and_halves_scale():
    handle = amp.init()
    model = _mlp()
    params = list(model.parameters())
    opt = handle.wrap_optimizer(FusedSGD(params, lr=0.1))
    x, y = _data()
    before = [p.detach().clone() for p in params]
    scale0 = opt._loss_scaler[0].loss_scale()
    loss = nn.CrossEntropyLoss()(model(x), y) * 1.0e38
    with opt.scale_loss(loss) as scaled:
        scaled.backward()
    assert opt._skip_next[0] is True
    opt.step()
    opt.zero_grad()
    handle._deactivate()
    assert all(torch.equal(p, b) for p, b in zip(params, before))
    assert opt._loss_scaler[0].loss_scale() == scale0 / 2.0
    assert opt._skip_next[0] is False


def test_overflow_streak_halves_scale_each_skip():
    handle = amp.init()
    model = _mlp()
    params = list(model.parameters())
    opt = handle.wrap_optimizer(FusedSGD(params, lr=0.1))
    x, y = _data()
    before = [p.detach().clone() for p in params]
    for k in range(1, 4):
        loss = nn.CrossEntropyLoss()(model(x), y) * 1.0e38
        with opt.scale_loss(loss) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        assert opt._loss_scaler[0].loss_scale() == 2.0 ** (16 - k)
        assert all(torch.equal(p, b) for p, b in zip(params, before))
    loss = nn.CrossEntropyLoss()(model(x), y)
    with opt.scale_loss(loss) as scaled:
        scaled.backward()
    opt.step()
    handle._deactivate()
    assert opt._loss_scaler[0].loss_scale() == 2.0 ** 13
    assert any(not torch.equal(p, b) for p, b in zip(params, before))


def test_disabled_handle_is_passthrough():
    handle = amp.init(enabled=False)
    assert not handle.is_active() and not policy._hooks
    model = _mlp()
    opt = handle.wrap_optimizer(FusedSGD(list(model.parameters()), lr=0.1))
    x, y = _data()
    loss = nn.CrossEntropyLoss()(model(x), y)
    assert loss.dtype == torch.float32
    with opt.scale_loss(loss) as scaled:
        assert scaled is loss
        scaled.backward()
    opt.step()


def test_attribute_forwarding_and_closure():
    handle = amp.init(enabled=False)
    inner = FusedSGD([nn.Parameter(torch.zeros(2, 2))], lr=0.25)
    opt = handle.wrap_optimizer(inner)
    assert opt.param_groups is inner.param_groups
    assert opt.param_groups[0]["lr"] == 0.25
    handle = amp.init()
    opt = handle.wrap_optimizer(
        FusedSGD([nn.Parameter(torch.zeros(2, 2))], lr=0.1))
    with pytest.raises(NotImplementedError):
        opt.step(closure=lambda: None)
    with pytest.raises(RuntimeError, match="no longer supported"):
        handle.scale_loss(None, None)
    handle._deactivate()


def test_disable_casts_suppresses_ambient_policy():
    handle = amp.init()
    model = _mlp()
    x, _ = _data()
    assert model(x).dtype == torch.float16
    with handle._disable_casts():
        assert not handle.is_active()
        assert model(x).dtype == torch.float32
    with amp.disable_casts():
        assert model(x).dtype == torch.float32
    assert model(x).dtype == torch.float16
    with pytest.raises(ValueError):
        with handle._disable_casts():
            raise ValueError("boom")
    assert handle.is_active()
    handle._deactivate()
    assert not policy._hooks and model(x).dtype == torch.float32


def test_static_loss_scale_threads_through():
    handle = amp.init(loss_scale=128.0)
    model = _mlp()
    opt = handle.wrap_optimizer(FusedSGD(list(model.parameters()), lr=0.1))
    assert opt._loss_scaler[0].dynamic is False
    assert opt._loss_scaler[0].loss_scale() == 128.0
    x, y = _data()
    loss = nn.CrossEntropyLoss()(model(x), y)
    with opt.scale_loss(loss) as scaled:
        np.testing.assert_allclose(float(scaled), float(loss) * 128.0,
                                   rtol=1e-6)
        scaled.backward()
    opt.step()
    handle._deactivate()


def test_banned_under_o1_and_allowed():
    model = nn.Sequential(nn.Linear(4, 1), nn.Sigmoid())
    opt = FusedSGD(list(model.parameters()), lr=0.1)
    model, opt = amp.initialize(model, opt, opt_level="O1", verbosity=0)
    out = model(torch.ones(4, 4))
    # the criterion has no tag: the ambient policy covers it
    with pytest.raises(NotImplementedError, match="binary_cross_entropy"):
        nn.BCELoss()(out, torch.ones(4, 1))
    port_reset()
    handle = amp.init(allow_banned=True)
    out = model(torch.ones(4, 4))
    loss = nn.BCELoss()(out.float(), torch.ones(4, 1))
    assert torch.isfinite(loss)
    handle._deactivate()
