"""The norm forwards' two routes and their parameters' dtypes, on the CPU.

The LayerNorm and RMSNorm forward kernels (``csrc/layer_norm.cu``,
``csrc/rms_norm.cu``) run only on the card, where ``chip_smoke.py`` holds
both routes against the plain versions.  Here: which calls
:func:`norm_route` sends to the ``vec`` route; that every route has a
launch counter and the totals still count; that the wrappers hand the
affine parameters to the C entry points uncast, with their own dtype codes,
and the route :func:`norm_route` picks (through a stand-in for the built
library); and that the plain versions, with the parameters in another dtype
than x's, match the Pallas kernels in interpret mode at width 768.
Tolerances: the fp32 statistics 1e-5 (sums in another order); y 1e-5 in
fp32 and 1e-2 in half precision (rounded on both sides from fp32 values
that agree to 1e-5, so one half-precision step apart at most).
"""
import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import layer_norm as jax_ln
from apex_tpu.kernels import rms_norm as jax_rms

from apex_tpu_torch.kernels import dispatch, layer_norm, rms_norm

torch.set_num_threads(2)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
_JAX = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}
_SEED = {F32: 0, BF16: 1, F16: 2}


@pytest.mark.parametrize("dtype,n,addresses,want", [
    (BF16, 768, (0, 1 << 20, 4096, 4096 + 1536), "vec"),    # the train steps
    (F32, 768, (0, 1 << 20, 4096), "vec"),                  # generate
    (F16, 768, (16, 48, 4096), "vec"),                      # amp O2 / O3
    (F32, 4, (0, 16), "vec"),                               # one chunk
    (BF16, 8, (0, 16), "vec"),
    (BF16, 16384, (0, 32), "vec"),                          # the widest row
    (BF16, 1001, (0, 1 << 20), "scalar"),                   # n % 8
    (BF16, 1004, (0, 1 << 20), "scalar"),                   # n % 8 == 4
    (F32, 1004, (0, 1 << 20), "vec"),                       # n % 4 == 0
    (F32, 1002, (0, 1 << 20), "scalar"),
    (F16, 12, (0, 16), "scalar"),
    (BF16, 16392, (0, 32), "scalar"),                       # beyond MAX_N
    (BF16, 768, (2, 1 << 20), "scalar"),                    # x misaligned
    (F32, 768, (0, 8), "scalar"),                           # y misaligned
    (BF16, 768, (0, 16, 4096 + 2), "scalar"),               # w misaligned
    (F16, 768, (0, 16, 4096, 24), "scalar"),                # b misaligned
])
def test_route_is_chosen_from_dtype_width_and_alignment(dtype, n, addresses,
                                                        want):
    assert layer_norm.norm_route(dtype, n, *addresses) == want


def test_every_route_has_a_counter():
    assert layer_norm.ROUTES == ("scalar", "vec")
    assert rms_norm.norm_route is layer_norm.norm_route
    names = {f"{kind}_forward{route}" for kind in ("ln", "rms")
             for route in ("", "_scalar", "_vec")}
    assert names <= set(dispatch.counts())


class _Lib:
    """Stands in for a built norm library: records each forward entry
    point's arguments and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

        def strerror(code):
            return b"a stand-in error"
        self.apex_strerror = strerror

    def apex_ln_fwd(self, *args):
        self.calls.append(("ln", args))
        return self.err

    def apex_rms_fwd(self, *args):
        self.calls.append(("rms", args))
        return self.err


@pytest.fixture
def stub(monkeypatch):
    """The wrappers' launch path on CPU tensors, with a stand-in library,
    no CUDA device context and stream 0."""
    def install(mod, err=0):
        lib = _Lib(err)
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda: types.SimpleNamespace(cuda_stream=0))
        return lib
    return install


def _misaligned(rows, n, dtype):
    """A contiguous (rows, n) tensor whose base is 2 bytes past a
    16-byte boundary."""
    base = torch.zeros(rows * n + 8, dtype=dtype)
    off = 1 if base.data_ptr() % 16 == 0 else 0
    return base[off:off + rows * n].view(rows, n)


@pytest.mark.parametrize("n,x_dt,w_dt,b_dt,misaligned,route", [
    (768, BF16, BF16, BF16, False, "vec"),       # the GPT and BERT steps
    (768, F16, F32, F32, False, "vec"),          # amp O2: fp32 LayerNorm
    (768, F32, BF16, F16, False, "vec"),
    (1001, BF16, BF16, F32, False, "scalar"),
    (768, BF16, BF16, BF16, True, "scalar"),
])
def test_ln_wrapper_hands_parameters_uncast(stub, n, x_dt, w_dt, b_dt,
                                            misaligned, route):
    lib = stub(layer_norm)
    x = _misaligned(16, n, x_dt) if misaligned else torch.randn(16, n) \
        .to(x_dt)
    w, b = torch.randn(n).to(w_dt), torch.randn(n).to(b_dt)
    dispatch.reset_counts()
    y, mean, rstd = layer_norm._launch(x, w, b, 1e-5)
    ((kind, args),) = lib.calls
    xp, wp, wc, bp, bc, yp, mp, rp, rows, width, eps, xc, rc, stream = args
    assert kind == "ln" and (rows, width, stream) == (16, n, 0)
    assert (xp, wp, bp) == (x.data_ptr(), w.data_ptr(), b.data_ptr())
    assert (yp, mp, rp) == (y.data_ptr(), mean.data_ptr(), rstd.data_ptr())
    assert (xc, wc, bc) == tuple(dispatch.dtype_code(t.dtype)
                                 for t in (x, w, b))
    assert eps == pytest.approx(1e-5)
    assert rc == layer_norm.ROUTES.index(route)
    c = dispatch.counts()
    assert c["ln_forward"] == c[f"ln_forward_{route}"] == 1
    assert sum(c.values()) == 2


@pytest.mark.parametrize("n,x_dt,w_dt,misaligned,route", [
    (768, BF16, BF16, False, "vec"),             # the Llama step
    (768, F32, F32, False, "vec"),               # generate
    (768, F16, BF16, False, "vec"),
    (1001, F32, BF16, False, "scalar"),
    (768, F32, F32, True, "scalar"),
    (768, BF16, None, False, "vec"),             # no weight
])
def test_rms_wrapper_hands_weight_uncast(stub, n, x_dt, w_dt, misaligned,
                                         route):
    lib = stub(rms_norm)
    x = _misaligned(8, n, x_dt) if misaligned else torch.randn(8, n).to(x_dt)
    w = None if w_dt is None else torch.randn(n).to(w_dt)
    dispatch.reset_counts()
    y, rstd = rms_norm._launch(x, w, 1e-6)
    ((kind, args),) = lib.calls
    xp, wp, wc, yp, rp, rows, width, eps, xc, rc, stream = args
    assert kind == "rms" and (rows, width, stream) == (8, n, 0)
    assert (xp, yp, rp) == (x.data_ptr(), y.data_ptr(), rstd.data_ptr())
    assert wp == (None if w is None else w.data_ptr())
    assert wc == (0 if w is None else dispatch.dtype_code(w.dtype))
    assert xc == dispatch.dtype_code(x.dtype)
    assert rc == layer_norm.ROUTES.index(route)
    c = dispatch.counts()
    assert c["rms_forward"] == c[f"rms_forward_{route}"] == 1
    assert sum(c.values()) == 2


def test_a_failed_launch_raises_and_counts_nothing(stub):
    """A vec launch the entry point refuses raises; the wrapper never
    tries the scalar route instead."""
    lib = stub(layer_norm, err=1)
    x = torch.randn(4, 768).to(BF16)
    w = torch.ones(768, dtype=BF16)
    dispatch.reset_counts()
    with pytest.raises(RuntimeError, match="vec route"):
        layer_norm._launch(x, w, w, 1e-5)
    assert len(lib.calls) == 1 and not any(dispatch.counts().values())
    lib = stub(rms_norm, err=1)
    with pytest.raises(RuntimeError, match="vec route"):
        rms_norm._launch(x, w, 1e-6)
    assert len(lib.calls) == 1 and not any(dispatch.counts().values())


def test_argtypes_match_the_entry_points(monkeypatch):
    """The ctypes signatures the wrappers declare: pointers as void*, the
    dtype codes, route, sizes and workspace rows as int (the library itself
    is built on the card)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    monkeypatch.setattr(layer_norm._build, "load",
                        lambda name: libs.setdefault(
                            name, types.SimpleNamespace(**{
                                fn: types.SimpleNamespace() for fn in (
                                    "apex_ln_fwd", "apex_ln_bwd_parts",
                                    "apex_ln_bwd", "apex_ln_bwd_cols",
                                    "apex_rms_fwd", "apex_rms_bwd_parts",
                                    "apex_rms_bwd", "apex_rms_bwd_cols")})))
    for mod in (layer_norm, rms_norm):
        mod._lib.cache_clear()
        try:
            mod._lib()
        finally:
            mod._lib.cache_clear()
    assert libs["layer_norm"].apex_ln_fwd.argtypes == [
        p, p, i, p, i, p, p, p, i, i, f, i, i, p]
    assert libs["rms_norm"].apex_rms_fwd.argtypes == [
        p, p, i, p, p, i, i, f, i, i, p]
    # the backwards: (rows, n, dtype, route) -> parts; the row kernel with
    # its route; the column sums with the dtype they are written in
    assert libs["layer_norm"].apex_ln_bwd_parts.argtypes == [i, i, i, i]
    assert libs["layer_norm"].apex_ln_bwd.argtypes == [
        p, p, p, p, p, i, p, p, p, i, i, i, i, i, p]
    assert libs["layer_norm"].apex_ln_bwd_cols.argtypes == [
        p, p, p, p, i, i, i, p]
    assert libs["rms_norm"].apex_rms_bwd_parts.argtypes == [i, i, i, i]
    assert libs["rms_norm"].apex_rms_bwd.argtypes == [
        p, p, p, p, i, p, p, i, i, i, i, i, p]
    assert libs["rms_norm"].apex_rms_bwd_cols.argtypes == [p, p, i, i, i, p]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("x_dt,w_dt,b_dt", [
    (BF16, F32, BF16), (F16, BF16, F32), (F32, BF16, F16)])
def test_ln_plain_version_with_parameters_in_own_dtypes(x_dt, w_dt, b_dt):
    rows, n = 16, 768
    r = np.random.default_rng(768 + _SEED[x_dt])
    x = torch.tensor(r.normal(1.0, 2.0, (rows, n)), dtype=F32).to(x_dt)
    w = torch.tensor(r.normal(size=n), dtype=F32).to(w_dt)
    b = torch.tensor(r.normal(size=n), dtype=F32).to(b_dt)
    yj, mj, rj = jax_ln.ln_forward(
        jnp.asarray(_np(x), _JAX[x_dt]), jnp.asarray(_np(w), _JAX[w_dt]),
        jnp.asarray(_np(b), _JAX[b_dt]), 1e-5, interpret=True)
    yt, mt, rt = layer_norm.ln_forward(x, w, b, 1e-5)
    assert yt.dtype == x_dt and mt.dtype == rt.dtype == F32
    np.testing.assert_allclose(_np(mt), np.asarray(mj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(rt), np.asarray(rj), rtol=1e-5, atol=1e-5)
    tol = 1e-5 if x_dt == F32 else 1e-2
    np.testing.assert_allclose(_np(yt), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("x_dt,w_dt", [(BF16, F32), (F16, BF16), (F32, BF16)])
def test_rms_plain_version_with_weight_in_own_dtype(x_dt, w_dt):
    rows, n = 16, 768
    r = np.random.default_rng(769 + _SEED[x_dt])
    x = torch.tensor(r.normal(0.5, 2.0, (rows, n)), dtype=F32).to(x_dt)
    w = torch.tensor(1 + 0.3 * r.normal(size=n), dtype=F32).to(w_dt)
    yj, rj = jax_rms.rms_forward(jnp.asarray(_np(x), _JAX[x_dt]),
                                 jnp.asarray(_np(w), _JAX[w_dt]), 1e-6,
                                 interpret=True)
    yt, rt = rms_norm.rms_forward(x, w, 1e-6)
    assert yt.dtype == x_dt and rt.dtype == F32
    np.testing.assert_allclose(_np(rt), np.asarray(rj), rtol=1e-5, atol=1e-5)
    tol = 1e-5 if x_dt == F32 else 1e-2
    np.testing.assert_allclose(_np(yt), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)

