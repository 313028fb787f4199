"""The norm backwards' two routes and their sums' dtype, on the CPU.

The LayerNorm and RMSNorm backward kernels (``csrc/layer_norm.cu``,
``csrc/rms_norm.cu``) run only on the card, where ``chip_smoke.py`` holds
both routes against the plain versions.  Here: which calls
:func:`~apex_tpu_torch.kernels.layer_norm.norm_route` sends to the ``vec``
route by the addresses of g, x, dx and the weight; that every backward
route has a launch counter beside the totals; that the wrappers hand the C
entry points the right pointers, dtype codes, route, workspace rows and,
to the column-sum entry point, the dtype the sums are asked in (through a
stand-in for the built library); and that the autograd Functions return
dgamma, dbeta and dw in the weight's dtype, against ``jax.vjp`` of the
JAX package's ``fused_layer_norm_affine`` / ``fused_rms_norm_affine``
(Pallas kernels in interpret mode).  Tolerances: bf16 and fp16 sums within
one unit in the last place of the weight's dtype at the largest sum (fp32
sums of the same terms in another order, rounded once on each side); fp32
sums 1e-5 of max(1, max |ref|), as every fp32 sum in another order here
(the two forwards' statistics are themselves an fp32 step or so apart, so
the sums land a few fp32 steps apart); dx 1e-5 in fp32, 2e-2 in bf16
(rounded to bf16 on both sides from fp32 values that agree to 1e-5).
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.normalization import fused_layer_norm_affine as jax_ln_affine
from apex_tpu.normalization import fused_rms_norm_affine as jax_rms_affine

from apex_tpu_torch.kernels import dispatch, layer_norm, rms_norm
from apex_tpu_torch.normalization import (fused_layer_norm_affine,
                                          fused_rms_norm_affine)

torch.set_num_threads(2)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
_JAX = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}
_BASES = (0, 1 << 20, 1 << 21, 4096)        # g, x, dx, w: all aligned


@pytest.mark.parametrize("dtype,n,moved,want", [
    (BF16, 768, None, "vec"),             # the GPT, Llama and BERT steps
    (F16, 768, None, "vec"),              # amp O2
    (F32, 768, None, "vec"),              # the fp32 step
    (F32, 1004, None, "vec"),             # n % 4 == 0
    (BF16, 16384, None, "vec"),           # the widest row
    (BF16, 1001, None, "scalar"),         # n % 8
    (BF16, 1004, None, "scalar"),         # n % 8 == 4
    (F32, 1002, None, "scalar"),
    (BF16, 16392, None, "scalar"),        # beyond MAX_N
    (BF16, 768, 0, "scalar"),             # g 2 bytes past a boundary
    (BF16, 768, 1, "scalar"),             # x
    (BF16, 768, 2, "scalar"),             # dx
    (BF16, 768, 3, "scalar"),             # w
    (F32, 768, 3, "scalar"),              # w 8 bytes past
])
def test_backward_route_from_dtype_width_and_each_address(dtype, n, moved,
                                                          want):
    addresses = list(_BASES)
    if moved is not None:
        addresses[moved] += 2 if dtype != F32 else 8
    assert layer_norm.norm_route(dtype, n, *addresses) == want


def test_every_backward_route_has_a_counter():
    names = {f"{kind}_backward_rows{route}" for kind in ("ln", "rms")
             for route in ("", "_scalar", "_vec")}
    names |= {"ln_backward_cols", "rms_backward_cols"}
    assert names <= set(dispatch.counts())


class _Lib:
    """Stands in for a built norm library: records the backward entry
    points' arguments, gives ``parts`` rows of partial sums and returns
    ``err`` from the row entry point."""

    def __init__(self, parts=7, err=0):
        self.calls, self.parts, self.err = [], parts, err
        self.apex_strerror = lambda code: b"a stand-in error"

    def _rows(self, name, args):
        self.calls.append((name, args))
        return self.err

    def _cols(self, name, args):
        self.calls.append((name, args))
        return 0

    def _parts(self, name, args):
        self.calls.append((name, args))
        return self.parts

    def __getattr__(self, name):
        kind = ("_parts" if name.endswith("_parts") else
                "_cols" if name.endswith("_cols") else "_rows")
        return lambda *args: getattr(self, kind)(name, args)


@pytest.fixture
def stub(monkeypatch):
    """The wrappers' launch path on CPU tensors (the device rule answering
    "launch"), with a stand-in library, no CUDA device context, stream 0
    and an empty cache of workspace rows."""
    def install(mod, **kw):
        lib = _Lib(**kw)
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        monkeypatch.setattr(mod, "use_kernel", lambda *tensors: True)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=0))
        mod._bwd_parts.cache_clear()
        return lib
    yield install
    layer_norm._bwd_parts.cache_clear()
    rms_norm._bwd_parts.cache_clear()


def _misaligned(rows, n, dtype):
    """A contiguous (rows, n) tensor whose base is 2 bytes past a 16-byte
    boundary."""
    base = torch.randn(rows * n + 8).to(dtype)
    off = 1 if base.data_ptr() % 16 == 0 else 0
    return base[off:off + rows * n].view(rows, n)


def _ln_inputs(rows, n, x_dt, w_dt, misaligned):
    x = _misaligned(rows, n, x_dt) if misaligned else \
        torch.randn(rows, n).to(x_dt)
    g = torch.randn(rows, n).to(x_dt)
    w = None if w_dt is None else torch.randn(n).to(w_dt)
    mean = torch.zeros(rows, 1)
    return g, x, mean, torch.ones(rows, 1), w


@pytest.mark.parametrize("n,x_dt,w_dt,misaligned,route", [
    (768, BF16, BF16, False, "vec"),       # the GPT and BERT steps
    (768, F16, F32, False, "vec"),         # amp O2: fp32 LayerNorm
    (768, F32, BF16, False, "vec"),
    (768, BF16, None, False, "vec"),       # no weight
    (1001, BF16, F16, False, "scalar"),
    (768, BF16, BF16, True, "scalar"),
])
@pytest.mark.parametrize("sum_dt", [F32, BF16])
def test_ln_backward_wrapper_arguments(stub, n, x_dt, w_dt, misaligned,
                                       route, sum_dt):
    lib = stub(layer_norm)
    g, x, mean, rstd, w = _ln_inputs(16, n, x_dt, w_dt, misaligned)
    dispatch.reset_counts()
    out = layer_norm._backward(g, x, mean, rstd, w, sum_dt)
    calls = dict(lib.calls)
    assert [c[0] for c in lib.calls] == ["apex_ln_bwd_parts", "apex_ln_bwd"] \
        + (["apex_ln_bwd_cols"] if w is not None else [])
    rc = layer_norm.ROUTES.index(route)
    assert calls["apex_ln_bwd_parts"] == (16, n, dispatch.dtype_code(x_dt),
                                          rc)
    (gp, xp, mp, rp, wp, wc, dxp, pwp, pbp, parts, rows, width, xc, rcode,
     stream) = calls["apex_ln_bwd"]
    assert (gp, xp, mp, rp) == tuple(t.data_ptr() for t in (g, x, mean, rstd))
    assert dxp == out[0].data_ptr() and out[0].dtype == x_dt
    assert (parts, rows, width, xc, rcode, stream) == (
        7, 16, n, dispatch.dtype_code(x_dt), rc, 0)
    c = dispatch.counts()
    assert c["ln_backward_rows"] == c[f"ln_backward_rows_{route}"] == 1
    if w is None:
        assert (wp, wc, pwp, pbp) == (None, 0, None, None)
        assert len(out) == 1 and sum(c.values()) == 2
        return
    assert (wp, wc) == (w.data_ptr(), dispatch.dtype_code(w_dt))
    assert pwp is not None and pbp is not None and pwp != pbp
    cw, cb, dwp, dbp, cparts, cn, odt, cstream = calls["apex_ln_bwd_cols"]
    assert (cw, cb, cparts, cn, cstream) == (pwp, pbp, 7, n, 0)
    assert odt == dispatch.dtype_code(sum_dt)
    _, dw, db = out
    assert (dwp, dbp) == (dw.data_ptr(), db.data_ptr())
    assert dw.dtype == db.dtype == sum_dt and dw.shape == (n,)
    assert c["ln_backward_cols"] == 1 and sum(c.values()) == 3


@pytest.mark.parametrize("n,x_dt,w_dt,misaligned,route", [
    (768, BF16, BF16, False, "vec"),       # the Llama step
    (768, F32, F32, False, "vec"),
    (768, F16, BF16, False, "vec"),
    (768, BF16, None, False, "vec"),
    (1001, F32, BF16, False, "scalar"),
    (768, BF16, F32, True, "scalar"),
])
@pytest.mark.parametrize("sum_dt", [F32, F16])
def test_rms_backward_wrapper_arguments(stub, n, x_dt, w_dt, misaligned,
                                        route, sum_dt):
    lib = stub(rms_norm, parts=5)
    g, x, _, rstd, w = _ln_inputs(8, n, x_dt, w_dt, misaligned)
    dispatch.reset_counts()
    out = rms_norm._backward(g, x, rstd, w, sum_dt)
    calls = dict(lib.calls)
    assert [c[0] for c in lib.calls] == ["apex_rms_bwd_parts",
                                         "apex_rms_bwd"] \
        + (["apex_rms_bwd_cols"] if w is not None else [])
    rc = layer_norm.ROUTES.index(route)
    assert calls["apex_rms_bwd_parts"] == (8, n, dispatch.dtype_code(x_dt),
                                           rc)
    (gp, xp, rp, wp, wc, dxp, pwp, parts, rows, width, xc, rcode,
     stream) = calls["apex_rms_bwd"]
    assert (gp, xp, rp, dxp) == (g.data_ptr(), x.data_ptr(),
                                 rstd.data_ptr(), out[0].data_ptr())
    assert (parts, rows, width, xc, rcode, stream) == (
        5, 8, n, dispatch.dtype_code(x_dt), rc, 0)
    c = dispatch.counts()
    assert c["rms_backward_rows"] == c[f"rms_backward_rows_{route}"] == 1
    if w is None:
        assert (wp, wc, pwp) == (None, 0, None)
        assert len(out) == 1 and sum(c.values()) == 2
        return
    assert (wp, wc) == (w.data_ptr(), dispatch.dtype_code(w_dt))
    cw, dwp, cparts, cn, odt, cstream = calls["apex_rms_bwd_cols"]
    assert (cw, cparts, cn, cstream) == (pwp, 5, n, 0)
    assert odt == dispatch.dtype_code(sum_dt)
    assert dwp == out[1].data_ptr() and out[1].dtype == sum_dt
    assert c["rms_backward_cols"] == 1 and sum(c.values()) == 3


def test_public_backwards_ask_for_fp32_sums(stub):
    """ln_backward and rms_backward keep returning fp32 sums, as their JAX
    twins do."""
    for mod, call in ((layer_norm, lambda g, x, m, r, w:
                       layer_norm.ln_backward(g, x, m, r, w)),
                      (rms_norm, lambda g, x, m, r, w:
                       rms_norm.rms_backward(g, x, r, w))):
        lib = stub(mod)
        out = call(*_ln_inputs(4, 768, BF16, BF16, False))
        assert lib.calls[-1][1][-2] == dispatch.dtype_code(F32)
        assert all(s.dtype == F32 for s in out[1:])


def test_workspace_rows_are_asked_per_route_and_dtype(stub):
    """_bwd_parts is keyed on the route and x's dtype: a call of another
    route or dtype asks the library again."""
    lib = stub(layer_norm)
    for x_dt, misaligned in ((BF16, False), (BF16, False), (BF16, True),
                             (F32, False)):
        layer_norm._backward(*_ln_inputs(4, 768, x_dt, BF16, misaligned),
                             F32)
    asked = [args for name, args in lib.calls
             if name == "apex_ln_bwd_parts"]
    assert asked == [(4, 768, 1, 1), (4, 768, 1, 0), (4, 768, 0, 1)]


def test_a_failed_vec_launch_raises_and_counts_nothing(stub):
    """A vec launch the entry point refuses raises; the wrapper never
    tries the scalar route instead, and launches no column sums."""
    for mod, call in ((layer_norm, lambda g, x, m, r, w:
                       layer_norm._backward(g, x, m, r, w, BF16)),
                      (rms_norm, lambda g, x, m, r, w:
                       rms_norm._backward(g, x, r, w, BF16))):
        lib = stub(mod, err=1)
        dispatch.reset_counts()
        with pytest.raises(RuntimeError, match="vec route"):
            call(*_ln_inputs(4, 768, BF16, BF16, False))
        assert [name for name, _ in lib.calls][1:] == [
            f"apex_{'ln' if mod is layer_norm else 'rms'}_bwd"]
        assert not any(dispatch.counts().values())


def test_a_refused_grid_raises(stub):
    lib = stub(rms_norm, parts=0)
    g, x, _, rstd, w = _ln_inputs(4, 768, BF16, BF16, False)
    with pytest.raises(RuntimeError, match="no grid"):
        rms_norm._backward(g, x, rstd, w, F32)
    assert [name for name, _ in lib.calls] == ["apex_rms_bwd_parts"]


@pytest.mark.parametrize("w_dt", [F32, BF16, F16])
def test_plain_sums_in_the_weight_dtype_are_the_fp32_sums_rounded(w_dt):
    r = np.random.default_rng(11)
    x = torch.tensor(r.normal(1.0, 2.0, (32, 256)), dtype=F32).to(BF16)
    g = torch.tensor(r.normal(size=(32, 256)), dtype=F32).to(BF16)
    w = torch.tensor(r.normal(1.0, 0.3, 256), dtype=F32).to(w_dt)
    _, mean, rstd = layer_norm.ln_forward_reference(x, None, None, 1e-5)
    full = layer_norm.ln_backward_reference(g, x, mean, rstd, w)
    low = layer_norm.ln_backward_reference(g, x, mean, rstd, w, w_dt)
    assert torch.equal(low[0], full[0])
    for a, b in zip(low[1:], full[1:]):
        assert b.dtype == F32 and a.dtype == w_dt
        assert torch.equal(a, b.to(w_dt))
    full = rms_norm.rms_backward_reference(g, x, rstd, w)
    low = rms_norm.rms_backward_reference(g, x, rstd, w, w_dt)
    assert torch.equal(low[0], full[0]) and full[1].dtype == F32
    assert low[1].dtype == w_dt and torch.equal(low[1], full[1].to(w_dt))


def _ulps_at_max(got, ref):
    """Max |got - ref| in units in the last place of ref's dtype at max
    |ref|."""
    r = ref.double()
    top = r.abs().max().item()
    unit = torch.finfo(ref.dtype).eps * 2.0 ** np.floor(np.log2(top))
    return (got.double() - r).abs().max().item() / unit


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("x_dt", [F32, BF16])
@pytest.mark.parametrize("w_dt", [F32, BF16, F16])
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_autograd_sums_in_the_weight_dtype_match_jax(kind, x_dt, w_dt):
    """The Functions' dgamma, dbeta and dw come out in the weight's dtype,
    at the module note's tolerance of jax.vjp through the JAX package's
    custom_vjp (which casts its fp32 sums to the weight's dtype)."""
    rows, n = 16, 256
    r = np.random.default_rng(100 + 7 * (kind == "rms") + 3 * (x_dt == F32)
                              + {F32: 0, BF16: 1, F16: 2}[w_dt])
    x = torch.tensor(r.normal(0.5, 2.0, (rows, n)), dtype=F32).to(x_dt)
    dy = torch.tensor(r.normal(size=(rows, n)), dtype=F32).to(x_dt)
    w = torch.tensor(r.normal(1.0, 0.3, n), dtype=F32).to(w_dt)
    b = torch.tensor(r.normal(0.0, 0.3, n), dtype=F32).to(w_dt)
    jx, jdy = (jnp.asarray(_np(t), _JAX[x_dt]) for t in (x, dy))
    jw, jb = (jnp.asarray(_np(t), _JAX[w_dt]) for t in (w, b))
    xt = x.clone().requires_grad_(True)
    params = [w.clone().requires_grad_(True)]
    if kind == "ln":
        params.append(b.clone().requires_grad_(True))
        yt = fused_layer_norm_affine(xt, *params, (n,), 1e-5)
        fn = lambda x_, w_, b_: jax_ln_affine(x_, w_, b_, (n,), 1e-5)  # noqa: E731
        args = (jx, jw, jb)
    else:
        yt = fused_rms_norm_affine(xt, params[0], (n,), 1e-6)
        fn = lambda x_, w_: jax_rms_affine(x_, w_, (n,), 1e-6)  # noqa: E731
        args = (jx, jw)
    yt.backward(dy)
    with force_mode("interpret"):
        _, vjp = jax.vjp(fn, *args)
        grads = vjp(jdy)
    for p, jg in zip(params, grads[1:]):
        assert p.grad.dtype == w_dt and jg.dtype == _JAX[w_dt]
        ref = torch.tensor(np.asarray(jg, np.float32)).to(w_dt)
        if w_dt == F32:
            scale = max(1.0, ref.abs().max().item())
            assert (p.grad - ref).abs().max().item() <= 1e-5 * scale
        else:
            assert _ulps_at_max(p.grad, ref) <= 1.0
    tol = 1e-5 if x_dt == F32 else 2e-2
    assert xt.grad.dtype == x_dt
    np.testing.assert_allclose(_np(xt.grad), np.asarray(grads[0], np.float32),
                               rtol=tol, atol=tol)
