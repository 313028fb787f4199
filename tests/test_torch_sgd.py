"""The port's momentum SGD against the JAX package's, on the CPU.

``kernels.multi_tensor.fused_sgd`` on CPU tensors runs its plain version
(``fused_sgd_reference``), which is held bit for bit to the JAX package's
eager per-tensor loop ``ops.multi_tensor.sgd_unfused`` and within 1e-6 of
max(1, |ref|) to the Pallas ``fused_sgd`` in interpret mode (the Pallas
body rounds differently in the last bit: ROADMAP queue C).  Beside it: the
flag's skip, ``multi_tensor_sgd`` through ``multi_tensor_applier``, the
wrapper's refusals, and the eager ``FusedSGD.step`` against the JAX
``FusedSGD``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import multi_tensor as jax_mt
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.nn.parameter import Parameter as JaxParameter
from apex_tpu.ops import multi_tensor as jax_ops
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD

from apex_tpu_torch import ops
from apex_tpu_torch.kernels import multi_tensor
from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.optimizers import FusedSGD

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16),
       "float16": (jnp.float16, torch.float16)}
# sizes that are no multiple of 4, one of 4, and a scalar
_SHAPES = [(37,), (8, 130), (3, 5, 7), (64,), ()]


def _t(j, dtype):
    """A JAX array as a writable torch CPU tensor of ``dtype`` (half values
    carried across exactly through fp32)."""
    return torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _lists(seed, gdtypes, copy=None):
    """``[grads, params, momenta(, model copies)]`` on both sides; the
    gradients take the dtypes in ``gdtypes`` in turn (a mixed list when
    there are several)."""
    r = np.random.default_rng(seed)
    gd = [gdtypes[i % len(gdtypes)] for i in range(len(_SHAPES))]
    gj = [jnp.asarray(r.normal(size=s), _DT[d][0])
          for s, d in zip(_SHAPES, gd)]
    pj = [jnp.asarray(r.normal(size=s), jnp.float32) for s in _SHAPES]
    mj = [jnp.asarray(r.normal(size=s) * 0.1, jnp.float32) for s in _SHAPES]
    jl = [gj, pj, mj]
    tl = [[_t(a, _DT[d][1]) for a, d in zip(gj, gd)],
          [_t(a, torch.float32) for a in pj],
          [_t(a, torch.float32) for a in mj]]
    if copy is not None:
        cj = [p.astype(_DT[copy][0]) for p in pj]
        jl.append(cj)
        tl.append([_t(a, _DT[copy][1]) for a in cj])
    return jl, tl


# (gradient dtypes, model copy, momentum, dampening, nesterov,
#  wd_after_momentum, first_run, scale, weight decay)
_CASES = [
    (("float32",), None, 0.9, 0.0, False, False, False, 1.0, 1e-4),
    (("bfloat16",), None, 0.9, 0.0, False, False, False, 1.0, 1e-4),
    (("float16",), None, 0.9, 0.0, True, True, False, 2.0, 1e-4),
    (("float32",), None, 0.0, 0.0, False, False, False, 1.0, 1e-4),
    (("bfloat16",), None, 0.9, 0.0, False, False, True, 1.0, 0.0),
    (("float32",), None, 0.9, 0.1, False, True, False, 2.0, 5e-4),
    (("bfloat16", "float32"), None, 0.9, 0.0, False, False, False, 1.0, 1e-4),
    (("float32",), "float16", 0.9, 0.0, False, False, False, 2.0, 1e-4),
    (("float16",), "float16", 0.9, 0.0, True, False, False, 1 / 1024, 1e-4),
    (("float32",), "bfloat16", 0.9, 0.0, False, True, True, 1.0, 1e-4),
    (("float32", "bfloat16"), "bfloat16", 0.0, 0.0, False, False, False, 2.0,
     0.0),
]


@pytest.mark.parametrize("case", _CASES, ids=[
    f"g={'+'.join(c[0])}-copy={c[1]}-mom={c[2]}-damp={c[3]}-nest={c[4]}-"
    f"wdafter={c[5]}-first={c[6]}-scale={c[7]:g}-wd={c[8]}" for c in _CASES])
def test_fused_sgd_matches_jax(case):
    gd, copy, mom, damp, nesterov, wd_after, first_run, scale, wd = case
    jl, tl = _lists(len(gd) * 7 + int(mom * 10) + int(first_run), gd, copy)
    m_before = [t.clone() for t in tl[2]]
    args = (wd, mom, damp, 0.1, nesterov, first_run, wd_after, scale)
    flag_j = jnp.zeros((), jnp.int32)
    want = jax_ops.sgd_unfused(flag_j, jl, *args)
    with force_mode("interpret"):
        pallas = jax_mt.fused_sgd(flag_j, jl, *args)
    unfused = ops.sgd_unfused(ops.zero_flag("cpu"), tl, *args)
    out = multi_tensor.fused_sgd(ops.zero_flag("cpu"), tl, *args)
    assert int(out[0]) == 0 and len(out) == len(want) == len(tl)
    for got in (out[1:], unfused[1:]):
        for lst_g, lst_w, lst_k in zip(got, want[1:], pallas[1:]):
            for a, w, k in zip(lst_g, lst_w, lst_k):
                assert a.dtype == _DT[str(w.dtype)][1]
                np.testing.assert_array_equal(_np(a), _np(w))
                k = _np(k)
                err = np.abs(_np(a) - k).max(initial=0.0)
                assert err <= 1e-6 * max(1.0, np.abs(k).max(initial=0.0))
    # in place: the returned tensors are the ones passed in
    assert all(a is b for lst, tls in zip(out[1:], tl[1:])
               for a, b in zip(lst, tls))
    if mom == 0.0:
        assert all(torch.equal(a, b) for a, b in zip(tl[2], m_before))


@pytest.mark.parametrize("depth", [3, 4])
def test_fused_sgd_skips_on_the_flag_through_the_applier(depth):
    """A set flag leaves params, momenta and the model copy as they were,
    on both sides; ``multi_tensor_sgd`` reaches the kernel's wrapper
    through ``multi_tensor_applier``."""
    jl, tl = _lists(11, ("bfloat16", "float32"),
                    "float16" if depth == 4 else None)
    before = [[t.clone() for t in lst] for lst in tl[1:]]
    args = (1e-4, 0.9, 0.0, 0.1, False, False, False, 1.0)
    flag = torch.ones((), dtype=torch.int32)
    out = multi_tensor_applier(ops.multi_tensor_sgd, flag, tl, *args)
    assert out[0] is flag
    want = jax_ops.sgd_unfused(jnp.ones((), jnp.int32), jl, *args)
    for lst, old, w in zip(tl[1:], before, want[1:]):
        for a, b, c in zip(lst, old, w):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(_np(a), _np(c))
    skipped = ops.sgd_unfused(flag, tl, *args)
    assert all(torch.equal(a, b) for lst, old in zip(skipped[1:], before)
               for a, b in zip(lst, old))
    multi_tensor_applier(ops.multi_tensor_sgd, ops.zero_flag("cpu"), tl,
                         *args)
    assert not torch.equal(tl[1][0], before[0][0])


def test_sgd_scalars_and_wrapper_refusals():
    s = multi_tensor.sgd_scalars(0.1, 1e-4, 0.5, 0.9, 0.1, "cpu")
    want = np.float32([0.1, 1e-4, 0.5, 0.9, 1.0 - 0.1])
    np.testing.assert_array_equal(s.numpy(), want)
    lr = torch.tensor(0.05)
    s = multi_tensor.sgd_scalars(lr, 0.0, 2.0, 0.9, 0.0, "cpu")
    np.testing.assert_array_equal(s.numpy(), np.float32([0.05, 0, 2, 0.9, 1]))
    with pytest.raises(TypeError, match="momentum"):
        multi_tensor.sgd_scalars(0.1, 0.0, 1.0, torch.tensor(0.9), 0.0, "cpu")

    _, tl = _lists(1, ("float32",))
    flag = ops.zero_flag("cpu")
    args = (0.0, 0.9, 0.0, 0.1, False, False, False)
    with pytest.raises(ValueError, match="depth 3 or 4"):
        multi_tensor.fused_sgd(flag, tl[:2], *args)
    with pytest.raises(ValueError, match="lengths differ"):
        multi_tensor.fused_sgd(flag, [tl[0], tl[1][:2], tl[2]], *args)
    with pytest.raises(TypeError, match="int32"):
        multi_tensor.fused_sgd(torch.zeros(()), tl, *args)
    with pytest.raises(TypeError, match="momentum 0 must be float32"):
        multi_tensor.fused_sgd(
            flag, [tl[0], tl[1], [m.double() for m in tl[2]]], *args)
    with pytest.raises(TypeError, match="model param 0 dtype"):
        multi_tensor.fused_sgd(flag, tl + [[p.clone() for p in tl[1]]], *args)
    with pytest.raises(TypeError, match="the params of one list share"):
        multi_tensor.fused_sgd(
            flag, [tl[0], [tl[1][0].half()] + tl[1][1:], tl[2]], *args)
    with pytest.raises(ValueError, match="shape"):
        multi_tensor.fused_sgd(flag, [tl[0], [tl[1][1]] + tl[1][1:], tl[2]],
                               *args)
    # a dense layout that the param's place in every list shares (here
    # transposed) is updated where it lies, as a contiguous list is; a
    # gradient in another layout than its param is refused, not copied
    moved = [[tl[0][1].t()], [tl[1][1].clone().t()], [tl[2][1].clone().t()]]
    flat = [[t.contiguous() for t in lst] for lst in moved]
    multi_tensor.fused_sgd(flag, moved, *args)
    multi_tensor.fused_sgd(flag, flat, *args)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(moved, flat))
    assert not moved[1][0].is_contiguous()
    with pytest.raises(ValueError, match="gradient 0 has strides"):
        multi_tensor.fused_sgd(
            flag, [[tl[0][1].t().contiguous()], [tl[1][1].t()],
                   [tl[2][1].t()]], *args)
    assert multi_tensor.fused_sgd(flag, [[], [], []], *args) == (flag, [], [])


def test_eager_fused_sgd_matches_jax_over_two_groups():
    """Three ``step()`` calls over two param groups (nesterov and plain
    momentum, weight decay before and after it): params and momentum
    buffers within fp32 rounding of the JAX ``FusedSGD``, whose step runs
    compiled, where XLA may contract a product and a sum into one
    rounding."""
    r = np.random.default_rng(9)
    shapes = [(5, 3), (7,), (4, 4), (6,)]
    init = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[r.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    groups = [dict(lr=0.1, weight_decay=1e-2, nesterov=True),
              dict(lr=0.03, weight_decay=0.0, dampening=0.1)]
    for wd_after in (False, True):
        jp = [JaxParameter(jnp.asarray(a)) for a in init]
        tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
        jopt = JaxFusedSGD([{"params": jp[:2], **groups[0]},
                            {"params": jp[2:], **groups[1]}], lr=0.1,
                           momentum=0.9, wd_after_momentum=wd_after)
        topt = FusedSGD([{"params": tp[:2], **groups[0]},
                         {"params": tp[2:], **groups[1]}], lr=0.1,
                        momentum=0.9, wd_after_momentum=wd_after)
        for gs in grads:
            for p, g in zip(jp, gs):
                p.grad = jnp.asarray(g)
            for p, g in zip(tp, gs):
                p.grad = torch.from_numpy(g)
            jopt.step()
            topt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b.data),
                                       rtol=1e-6, atol=1e-7)
            mom = topt.state[a]["momentum_buffer"]
            assert mom.dtype == torch.float32
            np.testing.assert_allclose(
                mom.numpy(), np.asarray(jopt.state[b]["momentum_buffer"]),
                rtol=1e-6, atol=1e-7)
    topt.zero_grad()
    assert all(p.grad is None for p in tp)
    for kw, msg in ((dict(lr=-1.0), "Invalid learning rate"),
                    (dict(lr=0.1, momentum=-0.5), "Invalid momentum"),
                    (dict(lr=0.1, weight_decay=-1.0), "Invalid weight_decay"),
                    (dict(lr=0.1, nesterov=True), "Nesterov momentum")):
        with pytest.raises(ValueError, match=msg):
            FusedSGD(tp, **kw)
        with pytest.raises(ValueError, match=msg):
            JaxFusedSGD(jp, **kw)


def test_fused_sgd_flag_skips_the_eager_step():
    p = torch.nn.Parameter(torch.ones(5))
    opt = FusedSGD([p], lr=0.1, momentum=0.9)
    p.grad = torch.ones(5)
    opt._overflow_buf.fill_(1)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(5))
    opt._overflow_buf.zero_()
    opt.step()
    assert torch.allclose(p.detach(), torch.full((5,), 0.9))
