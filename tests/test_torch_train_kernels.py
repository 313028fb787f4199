"""The training slice's kernel modules against the JAX package's.

The same numpy-seeded inputs go through the JAX function (Pallas in
interpret mode on the CPU, or its per-tensor loop) and through the port's
wrapper on CPU tensors, which takes the kernel's plain PyTorch version: the
LayerNorm and flash-attention backward, the multi-tensor Adam update, and
autograd through the port's ``FusedLayerNorm`` and ``flash_attention``
against ``jax.grad`` of the JAX functionals.  The CUDA kernels themselves
run only on the card (``chip_smoke.py`` holds them against these plain
versions); the host-side table the Adam kernel reads is built and checked
here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import attn_funcs as jax_attn_funcs
from apex_tpu.kernels import attention as jax_attn
from apex_tpu.kernels import layer_norm as jax_ln
from apex_tpu.kernels import multi_tensor as jax_mt
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.normalization import fused_layer_norm as jax_ln_plain
from apex_tpu.normalization import fused_layer_norm_affine as jax_ln_affine
from apex_tpu.ops import multi_tensor as jax_ops

from apex_tpu_torch import ops
from apex_tpu_torch.contrib.multihead_attn import attn_funcs
from apex_tpu_torch.kernels import attention, dispatch, layer_norm, \
    multi_tensor
from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.normalization import fused_layer_norm, \
    fused_layer_norm_affine
from torch_products import value_products

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch CPU tensor of ``dtype``
    (bf16 rounding done once, by JAX, and carried across exactly)."""
    jd, td = _DT[dtype]
    j = jnp.asarray(a, jd)
    return j, _t(j, td)


def _t(j, dtype=torch.float32):
    """A JAX array as a writable torch CPU tensor of ``dtype``."""
    return torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scaled_close(got, want, tol):
    """max |got - want| / max(1, max |want|) <= tol."""
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, f"scaled error {err} > {tol}"


# -- LayerNorm backward -----------------------------------------------------

@pytest.mark.parametrize("dtype,affine,wdtype,rows,n", [
    ("float32", True, "float32", 37, 64),
    ("float32", False, None, 37, 64),
    ("float32", True, "float32", 5, 300),     # ragged rows, ragged width
    ("bfloat16", True, "bfloat16", 21, 96),   # the O2 path: bf16 weights
    ("bfloat16", False, None, 21, 96),
])
def test_ln_backward_matches_jax(dtype, affine, wdtype, rows, n):
    r = np.random.default_rng(rows + n)
    xj, xt = _pair(r.normal(1.0, 2.0, (rows, n)), dtype)
    gj, gt = _pair(r.normal(size=(rows, n)), dtype)
    wj = wt = bj = None
    if affine:
        wj, wt = _pair(r.normal(1.0, 0.5, n), wdtype)
        bj = jnp.zeros(n, wj.dtype)
    with force_mode("interpret"):
        _, mj, rj = jax_ln.ln_forward(xj, wj, bj, 1e-5, interpret=True)
        want = jax_ln.ln_backward(gj, xj, mj, rj, wj, interpret=True)
    got = layer_norm.ln_backward(gt, xt, _t(mj), _t(rj), wt)
    assert len(got) == len(want) == (3 if affine else 1)
    assert got[0].dtype == xt.dtype and got[0].shape == (rows, n)
    # dx: fp32 arithmetic, sums in another order; a bf16 dx may round to a
    # neighbouring value.  dgamma/dbeta: fp32 sums over the rows
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=tol, atol=tol)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and a.shape == (n,)
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


# -- flash-attention backward -----------------------------------------------

def _bias(r, kind, bh, sq, sk):
    if kind is None:
        return None
    if kind == "keypad":                        # (BH, 1, Sk), -1e30 pads
        b = np.zeros((bh, 1, sk), np.float32)
        for i in range(bh):
            b[i, 0, sk - 1 - i % 3:] = -1e30
        return b
    return r.normal(size=(1, sq, sk)).astype(np.float32)   # (1, Sq, Sk)


@pytest.mark.parametrize("dtype,causal,bias,window,sq,sk,d", [
    ("float32", True, None, None, 24, 24, 16),
    ("float32", False, "keypad", None, 20, 20, 16),
    ("float32", True, "full", None, 16, 16, 32),
    ("float32", True, None, 5, 32, 32, 16),
    ("float32", True, None, None, 13, 13, 8),      # Sq not a multiple of 8
    ("float32", False, "full", None, 12, 20, 16),  # Sq != Sk
    ("float32", True, None, None, 12, 20, 16),     # causal, Sq < Sk
    ("float32", True, None, None, 20, 12, 16),     # causal, Sq > Sk
    ("bfloat16", True, None, None, 24, 24, 16),
])
def test_flash_backward_matches_jax(dtype, causal, bias, window, sq, sk, d):
    r = np.random.default_rng(sq * 37 + sk)
    bh = 4
    qj, qt = _pair(r.normal(size=(bh, sq, d)), dtype)
    kj, kt = _pair(r.normal(size=(bh, sk, d)), dtype)
    vj, vt = _pair(r.normal(size=(bh, sk, d)), dtype)
    gj, gt = _pair(r.normal(size=(bh, sq, d)), dtype)
    b = _bias(r, bias, bh, sq, sk)
    bj = None if b is None else jnp.asarray(b)
    bt = None if b is None else torch.from_numpy(b)
    scale = d ** -0.5
    with force_mode("interpret"):
        oj, lj = jax_attn.flash_attention_fwd(qj, kj, vj, bj, scale, causal,
                                              interpret=True, window=window)
        want = jax_attn.flash_attention_bwd(qj, kj, vj, bj, oj, lj, gj,
                                            scale, causal, interpret=True,
                                            window=window)
    got = attention.flash_attention_bwd(qt, kt, vt, bt, _t(oj, qt.dtype),
                                        _t(lj), gt, scale, causal,
                                        window=window)
    # fp32 scores and sums in another order: 1e-5 of the largest gradient;
    # bf16 outputs may round to a neighbouring value
    tol = 1e-5 if dtype == "float32" else 2e-2
    for a, w, ref in zip(got, want, (qt, kt, vt)):
        assert a.dtype == ref.dtype and a.shape == ref.shape
        _scaled_close(a, w, tol)


def test_flash_backward_plain_version_is_the_autograd_of_the_forward():
    """The explicit backward (probabilities recomputed from lse) equals
    torch autograd through the materialising forward."""
    r = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(r.normal(size=(3, 17, 8)).astype(
        np.float32)) for _ in range(4))
    bias = torch.from_numpy(r.normal(size=(1, 17, 17)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = attention.flash_attention_reference(*leaves, bias, 0.3, True,
                                                   6)
    want = torch.autograd.grad(out, leaves, g)
    got = attention.flash_attention_bwd_reference(q, k, v, bias, out.detach(),
                                                  lse.detach(), g, 0.3, True,
                                                  6)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


# -- autograd through the modules -------------------------------------------

@pytest.mark.parametrize("affine,dtype", [(True, "float32"),
                                          (False, "float32"),
                                          (True, "bfloat16")])
def test_layer_norm_autograd_matches_jax_grad(affine, dtype):
    r = np.random.default_rng(4)
    shape, n = (3, 5, 48), 48
    xj, xt = _pair(r.normal(0.5, 1.5, shape), dtype)
    wj, wt = _pair(r.normal(1.0, 0.3, n), dtype)
    bj, bt = _pair(r.normal(0.0, 0.3, n), dtype)

    def jloss(x, w, b):
        y = (jax_ln_affine(x, w, b, (n,), 1e-5) if affine
             else jax_ln_plain(x, (n,), 1e-5))
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))
    with force_mode("interpret"):
        want = jax.grad(jloss, argnums=(0, 1, 2))(xj, wj, bj)
    leaves = [t.clone().requires_grad_(True) for t in (xt, wt, bt)]
    y = (fused_layer_norm_affine(leaves[0], leaves[1], leaves[2], (n,), 1e-5)
         if affine else fused_layer_norm(leaves[0], (n,), 1e-5))
    torch.sin(y.float()).sum().backward()
    tol = 1e-5 if dtype == "float32" else 2e-2
    for t, w in zip(leaves if affine else leaves[:1], want):
        assert t.grad.dtype == t.dtype
        _scaled_close(t.grad, w, tol)
    if not affine:
        assert leaves[1].grad is None and leaves[2].grad is None


@pytest.mark.parametrize("causal,window,with_bias", [(True, 4, True),
                                                     (False, None, True),
                                                     (True, None, False)])
def test_flash_attention_autograd_matches_jax_grad(causal, window, with_bias):
    r = np.random.default_rng(5)
    q, k, v = (r.normal(size=(2, 3, 10, 8)).astype(np.float32)
               for _ in range(3))
    bias = (r.normal(size=(2, 1, 10)).astype(np.float32) if with_bias
            else None)

    def jloss(q, k, v):
        out = jax_attn_funcs.flash_attention(
            q, k, v, bias=None if bias is None else jnp.asarray(bias),
            causal=causal, sliding_window=window)
        return jnp.sum(jnp.sin(out))
    with force_mode("interpret"):
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                       (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    bt = None if bias is None else torch.from_numpy(bias)
    out = attn_funcs.flash_attention(*leaves, bias=bt, causal=causal,
                                     sliding_window=window)
    torch.sin(out).sum().backward()
    for t, w in zip(leaves, want):
        _scaled_close(t.grad, w, 1e-5)


def test_grad_off_forward_saves_nothing_and_matches():
    """With grad off (generation) the functional forms call the forward
    kernels without the autograd Functions: same values, no graph."""
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.normal(size=(4, 6, 32)).astype(np.float32))
    w, b = (torch.from_numpy(r.normal(size=32).astype(np.float32))
            .requires_grad_(True) for _ in range(2))
    q, k, v = (torch.from_numpy(r.normal(size=(2, 3, 9, 8))
                                .astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    with value_products():      # the calls' products alike
        with_grad = (fused_layer_norm_affine(x, w, b, (32,)),
                     attn_funcs.flash_attention(q, k, v, causal=True))
        got = {}
        for mode in (torch.no_grad, torch.inference_mode):
            with mode():
                got[mode] = (fused_layer_norm_affine(x, w, b, (32,)),
                             attn_funcs.flash_attention(q, k, v,
                                                        causal=True))
    assert all(t.grad_fn is not None for t in with_grad)
    for outs in got.values():
        for a, want in zip(outs, with_grad):
            assert a.grad_fn is None
            assert torch.equal(a, want.detach())


# -- multi-tensor Adam ------------------------------------------------------

_SHAPES = [(37,), (8, 130), (3, 5, 7), (64,)]


def _adam_lists(seed, gdtype):
    r = np.random.default_rng(seed)
    gj = [jnp.asarray(r.normal(size=s), _DT[gdtype][0]) for s in _SHAPES]
    pj = [jnp.asarray(r.normal(size=s), jnp.float32) for s in _SHAPES]
    mj = [jnp.asarray(r.normal(size=s) * 0.1, jnp.float32) for s in _SHAPES]
    vj = [jnp.asarray(np.abs(r.normal(size=s)) * 0.01, jnp.float32)
          for s in _SHAPES]
    tl = [[_t(a, _DT[gdtype][1]) for a in gj]] + [[_t(a) for a in lst]
                                                  for lst in (pj, mj, vj)]
    return [gj, pj, mj, vj], tl


@pytest.mark.parametrize("step_kind", ["int", "tensor"])
@pytest.mark.parametrize("mode,bias_correction,wd", [
    (0, True, 0.01), (1, True, 0.01), (0, False, 0.0), (1, True, 0.1)])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_fused_adam_matches_jax(gdtype, mode, bias_correction, wd,
                                step_kind):
    """The plain version, in place, is bitwise the JAX package's
    per-tensor loop (``adam_unfused``), and so is the port's
    ``adam_unfused``.  JAX's Pallas kernel (interpret mode) differs from
    that loop in the last bits (ROADMAP queue C), so against it the
    comparison is within fp32 rounding."""
    jl, tl = _adam_lists(100 * mode + int(1000 * wd) + len(gdtype), gdtype)
    jstep = 7 if step_kind == "int" else jnp.asarray(7, jnp.int32)
    tstep = 7 if step_kind == "int" else torch.tensor(7, dtype=torch.int32)
    args = (1e-3, 0.9, 0.999, 1e-8)
    tail = (mode, bias_correction, wd)
    flag_j = jnp.zeros((), jnp.int32)
    want = jax_ops.adam_unfused(flag_j, jl, *args, jstep, *tail)
    with force_mode("interpret"):
        pallas = jax_mt.fused_adam(flag_j, jl, *args, jstep, *tail)
    unfused = ops.adam_unfused(ops.zero_flag("cpu"), tl, *args, tstep, *tail)
    flag, ps, ms, vs = multi_tensor.fused_adam(ops.zero_flag("cpu"), tl,
                                               *args, tstep, *tail)
    assert int(flag) == 0
    for got in ((ps, ms, vs), unfused[1:]):
        for lst_g, lst_w, lst_k in zip(got, want[1:], pallas[1:]):
            for a, w, k in zip(lst_g, lst_w, lst_k):
                np.testing.assert_array_equal(_np(a), _np(w))
                np.testing.assert_allclose(_np(a), _np(k), rtol=1e-5,
                                           atol=1e-7)
    # in place: the returned tensors are the ones passed in
    assert all(a is b for a, b in zip(ps, tl[1]))


def test_fused_adam_skips_on_the_flag_and_ops_dispatch_to_it():
    _, tl = _adam_lists(3, "bfloat16")
    before = [[t.clone() for t in lst] for lst in tl[1:]]
    flag = torch.ones((), dtype=torch.int32)
    out = multi_tensor_applier(ops.multi_tensor_adam, flag, tl, 1e-3, 0.9,
                               0.999, 1e-8, 3, 1, True, 0.1)
    assert out[0] is flag
    for lst, old in zip(tl[1:], before):
        for a, b in zip(lst, old):
            assert torch.equal(a, b)
    ops.multi_tensor_adam(ops.zero_flag("cpu"), tl, 1e-3, 0.9, 0.999, 1e-8,
                          3, 1, True, 0.1)
    assert not torch.equal(tl[1][0], before[0][0])


def test_adam_scalars_follow_the_jax_expressions():
    s = multi_tensor.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 5, True, 0.0,
                                  "cpu")
    want = np.array([1e-3, 0.0, 0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-8,
                     1.0 - 0.9 ** 5, 1.0 - 0.999 ** 5], np.float32)
    np.testing.assert_array_equal(s.numpy(), want)
    dev = multi_tensor.adam_scalars(1e-3, 0.9, 0.999, 1e-8,
                                    torch.tensor(5, dtype=torch.int32), True,
                                    0.0, "cpu")
    bc = 1.0 - jnp.asarray([0.9, 0.999], jnp.float32) ** jnp.float32(5)
    np.testing.assert_allclose(dev.numpy()[7:], np.asarray(bc), rtol=2e-7)
    np.testing.assert_array_equal(dev.numpy()[:7], want[:7])
    off = multi_tensor.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 5, False, 0.1,
                                    "cpu")
    assert off[multi_tensor.BC1] == 1.0 and off[multi_tensor.BC2] == 1.0
    assert abs(float(off[multi_tensor.WD]) - 0.1) < 1e-8


def test_adam_kernel_table_maps_chunks_to_tensors():
    """The device table the Adam kernel reads: p, m, v addresses, sizes,
    and one (tensor, offset) pair per chunk; empty tensors get no chunk; a
    second call with the same tensors returns the kept table."""
    sizes = [0, 5, 130, 64]
    ps = [torch.zeros(s) for s in sizes]
    ms = [torch.zeros(s) for s in sizes]
    vs = [torch.zeros(s) for s in sizes]
    table, nc = multi_tensor._table(ps, ms, vs, 64)
    t = table.numpy()
    nt = len(sizes)
    assert nc == 5
    addrs = t[:3 * nt].reshape(3, nt)
    for row, lst in zip(addrs, (ps, ms, vs)):
        assert list(row) == [x.data_ptr() for x in lst]
    assert list(t[3 * nt:4 * nt]) == sizes
    chunks = t[4 * nt:].reshape(-1, 2).tolist()
    assert chunks == [[1, 0], [2, 0], [2, 64], [2, 128], [3, 0]]
    assert multi_tensor._table(ps, ms, vs, 64)[0] is table


# -- what the wrappers refuse, and the device rule --------------------------

def test_backward_and_adam_wrappers_refuse_what_the_kernels_cannot_take():
    q = torch.zeros(2, 8, 16)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        attention.flash_attention_bwd(q, q, q, None, q, lse, q, 0.25, True,
                                      dropout_p=0.1)
    big = torch.zeros(2, 8, 160)
    with pytest.raises(ValueError, match="head dim 160"):
        attention.flash_attention_bwd(big, big, big, None, big,
                                      torch.zeros(2, 8), big, 0.1, True)
    with pytest.raises(ValueError, match="lse must be fp32"):
        attention.flash_attention_bwd(q, q, q, None, q, lse.double(), q,
                                      0.25, True)
    with pytest.raises(ValueError, match="g shape"):
        attention.flash_attention_bwd(q, q, q, None, q, lse, q[:, :4], 0.25,
                                      True)
    x = torch.zeros(4, 32)
    stats = torch.zeros(4, 1)
    with pytest.raises(ValueError, match="mean must be fp32"):
        layer_norm.ln_backward(x, x, torch.zeros(4), stats, None)
    with pytest.raises(TypeError, match="dtype"):
        layer_norm.ln_backward(x.double(), x, stats, stats, None)
    with pytest.raises(ValueError, match="g shape"):
        layer_norm.ln_backward(x[:2], x, stats, stats, None)

    flag = torch.zeros((), dtype=torch.int32)
    g, p = [torch.zeros(3)], [torch.zeros(3)]
    with pytest.raises(TypeError, match="param 0 dtype torch.float64"):
        multi_tensor.fused_adam(flag, [g, [p[0].double()], p, p], 1e-3,
                                0.9, 0.999, 1e-8, 1, 1, True, 0.0)
    with pytest.raises(TypeError, match="exp_avgs of one list share"):
        multi_tensor.fused_adam(flag, [g * 2, p * 2, [p[0], p[0].half()],
                                       p * 2], 1e-3, 0.9, 0.999, 1e-8, 1, 1,
                                True, 0.0)
    with pytest.raises(TypeError, match="share a dtype"):
        multi_tensor.fused_adam(flag, [[g[0], g[0].bfloat16()], p * 2,
                                       p * 2, p * 2], 1e-3, 0.9, 0.999,
                                1e-8, 1, 1, True, 0.0)
    with pytest.raises(TypeError, match="noop_flag"):
        multi_tensor.fused_adam(flag.long(), [g, p, p, p], 1e-3, 0.9, 0.999,
                                1e-8, 1, 1, True, 0.0)
    with pytest.raises(ValueError, match="mode"):
        multi_tensor.fused_adam(flag, [g, p, p, p], 1e-3, 0.9, 0.999, 1e-8,
                                1, 2, True, 0.0)
    with pytest.raises(ValueError, match="shape"):
        multi_tensor.fused_adam(flag, [g, [torch.zeros(4)], p, p], 1e-3, 0.9,
                                0.999, 1e-8, 1, 1, True, 0.0)
    with pytest.raises(ValueError, match="4 lists|lists"):
        multi_tensor.fused_adam(flag, [g, p, p], 1e-3, 0.9, 0.999, 1e-8, 1,
                                1, True, 0.0)
    with pytest.raises(TypeError, match="eps must be a Python number"):
        multi_tensor.adam_scalars(1e-3, 0.9, 0.999, torch.tensor(1e-8), 1,
                                  True, 0.0, "cpu")


def test_cpu_tensors_launch_no_kernel():
    dispatch.reset_counts()
    x = torch.randn(3, 16)
    y, mean, rstd = layer_norm.ln_forward(x, torch.ones(16), torch.zeros(16),
                                          1e-5)
    layer_norm.ln_backward(x, x, mean, rstd, torch.ones(16))
    q = torch.randn(2, 8, 16)
    out, lse = attention.flash_attention_fwd(q, q, q, None, 0.25, True)
    attention.flash_attention_bwd(q, q, q, None, out, lse, q, 0.25, True)
    _, tl = _adam_lists(1, "float32")
    multi_tensor.fused_adam(ops.zero_flag("cpu"), tl, 1e-3, 0.9, 0.999,
                            1e-8, 1, 1, True, 0.0)
    assert set(dispatch.counts()) >= {
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
        "ln_backward_rows", "ln_backward_cols", "fused_adam"}
    assert not any(dispatch.counts().values())
