"""The tensor-core route of the flash-attention kernels, on the CPU.

The ``tc`` kernels (``csrc/flash_attention_tc.cu``) run only on the card,
where ``chip_smoke.py`` holds them against the plain versions and against
the route's plain model.  Here: which calls :func:`flash_route` sends to the
route, that every route and kernel has a launch counter, that the model of
the route's rounding (:func:`flash_attention_tc_reference`,
:func:`flash_attention_bwd_tc_reference`) is the plain version bit for bit
at fp32 input, and that in bf16 and fp16 it stays within the card's
tolerances of the JAX Pallas kernels in interpret mode (out 2e-2 of
max(1, |ref|), lse 2e-5, dq/dk/dv 1e-2 of max |ref|); and that the
wrappers still refuse what they refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import _get_current_function_mode_stack
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from apex_tpu.kernels import attention as jax_attn
from apex_tpu.kernels.dispatch import force_mode

from apex_tpu_torch.kernels import attention
from apex_tpu_torch.kernels.dispatch import counts
from torch_products import value_ops

torch.set_num_threads(2)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,d,addresses,want", [
    (BF16, 64, (0, 1 << 20, 4096), "tc"),              # GPT, Llama, BERT
    (F16, 64, (16, 48, 4096, 256), "tc"),              # amp O2 / O3
    (F32, 64, (0, 1 << 20, 4096), "simt"),             # tc would be TF32
    (BF16, 40, (0, 1 << 20, 4096), "simt"),
    (BF16, 128, (0, 1 << 20, 4096), "simt"),
    (F16, 32, (0, 1 << 20, 4096), "simt"),
    (F32, 128, (0, 1 << 20, 4096), "simt"),
    (BF16, 64, (8, 1 << 20, 4096), "simt"),            # q's base misaligned
    (BF16, 64, (0, 1 << 20, 4098), "simt"),            # v's base misaligned
    (F16, 64, (0, 16, 32, 2), "simt"),                 # dO's base misaligned
])
def test_route_is_chosen_from_dtype_head_dim_and_alignment(dtype, d,
                                                           addresses, want):
    assert attention.flash_route(dtype, d, *addresses) == want


def test_every_route_and_kernel_has_a_counter():
    names = {f"flash_attention_{kern}{route}"
             for kern in ("fwd", "bwd_dq", "bwd_dkv")
             for route in ("", "_simt", "_tc")}
    assert names <= set(counts())
    assert attention.ROUTES == ("simt", "tc")


def _case(seed, bh, sq, sk, d=64, bias=None):
    """q, k, v, dO (fp32 numpy) and a bias: None, "keypad" (the last keys
    of each head masked at -1e30) or "full" (1, Sq, Sk)."""
    r = np.random.default_rng(seed)
    q, k, v, g = (r.normal(size=(bh, s, d)).astype(np.float32)
                  for s in (sq, sk, sk, sq))
    b = None
    if bias == "keypad":
        b = np.zeros((bh, 1, sk), np.float32)
        for i in range(bh):
            b[i, 0, sk - 1 - (7 * i) % (sk // 2):] = -1e30
    elif bias == "full":
        b = r.normal(size=(1, sq, sk)).astype(np.float32)
    return q, k, v, g, b


# (bh, sq, sk, causal, bias, window, dropout_p, offsets)
CASES = [
    (4, 128, 128, True, None, None, 0.0, (0, 0)),
    (8, 96, 96, False, "keypad", None, 0.0, (0, 0)),
    (4, 200, 200, True, None, 16, 0.0, (0, 0)),
    (3, 72, 130, False, "full", None, 0.0, (0, 0)),
    (3, 150, 64, True, None, None, 0.0, (0, 0)),
    (4, 128, 128, True, None, None, 0.1, (1000, 37)),
    (8, 96, 96, False, "keypad", None, 0.1, (5, 2 ** 31 - 40)),
]


def _ids(case):
    bh, sq, sk, causal, bias, window, p, _ = case
    return (f"{bh}x{sq}x{sk}-causal{int(causal)}-{bias}-w{window}-p{p}")


def _drop(p, offsets, seed=-99):
    if not p:
        return {}
    return dict(dropout_p=p, dropout_seed=seed, dropout_row_off=offsets[0],
                dropout_col_off=offsets[1])


@pytest.fixture
def products_by_value():
    """Every op in the attention module's plain versions and tc models
    (the products q.k^T, p.v, dp, dq, dk, dv, and ``logsumexp``, softmax,
    the reductions and elementwise ops beside them) is a pure function of
    its operands' values for the test (``torch_products.value_ops``), so
    the two models under comparison take the same bits wherever they apply
    the same op to the same values, and differ wherever an op or an operand
    does.

    (torch's CPU arithmetic is not promised to give the same bits twice:
    whole runs of the suite found the first case's ``lse`` apart with
    ``out`` equal, so the ``logsumexp`` beside an equal softmax, when only
    q.k^T was shared between the models, and the case failed again in a
    whole run with every product shared; neither was reproduced alone.)

    No torch-function or dispatch mode may be active on entry: a mode that
    an earlier test left on the stack would rewrite the arithmetic of both
    models."""
    assert not _get_current_function_mode_stack(), \
        f"torch-function modes active: {_get_current_function_mode_stack()}"
    assert not _get_current_dispatch_mode_stack(), \
        f"dispatch modes active: {_get_current_dispatch_mode_stack()}"
    with value_ops():
        yield


def _assert_same(name, got, want):
    """``got`` equals ``want`` bit for bit, or a message that says where
    and by how much they differ."""
    assert got.dtype == want.dtype and got.shape == want.shape, \
        f"{name}: {got.dtype}{tuple(got.shape)} against " \
        f"{want.dtype}{tuple(want.shape)}"
    if torch.equal(got, want):
        return
    diff = (got.double() - want.double()).abs()
    diff = torch.where(torch.isnan(diff), torch.inf, diff)
    at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    raise AssertionError(
        f"{name}: {int((got != want).sum())} of {got.numel()} elements "
        f"differ; the largest at {tuple(int(i) for i in at)}: "
        f"{got[at].item()!r} against {want[at].item()!r} "
        f"({diff[at].item():.3e}); torch threads {torch.get_num_threads()}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tc_models_are_the_plain_versions_at_fp32(case, products_by_value):
    bh, sq, sk, causal, bias, window, p, offsets = case
    q, k, v, g, b = map(lambda a: None if a is None else torch.from_numpy(a),
                        _case(sq + sk, bh, sq, sk, bias=bias))
    drop = _drop(p, offsets)
    args = (q, k, v, b, 0.125, causal, window)
    # the tc model's one rounding, of p (forward) and ds (backward) to the
    # input dtype, is no rounding at fp32
    probe = torch.rand(3, 5)
    assert attention._operand(probe, q.dtype) is probe
    out, lse = attention.flash_attention_reference(*args, **drop)
    tout, tlse = attention.flash_attention_tc_reference(*args, **drop)
    _assert_same("out", tout, out)
    _assert_same("lse", tlse, lse)
    want = attention.flash_attention_bwd_reference(
        q, k, v, b, out, lse, g, 0.125, causal, window, **drop)
    got = attention.flash_attention_bwd_tc_reference(
        q, k, v, b, out, lse, g, 0.125, causal, window, **drop)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == F32
        _assert_same(name, a, w)


def _to_jax(a, dtype):
    return jnp.asarray(a).astype({BF16: jnp.bfloat16, F16: jnp.float16}[dtype])


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tc_models_match_pallas_kernels(case, dtype):
    """The route's rounding of p and ds stays within the card's tolerances
    of the JAX kernels, which keep them in fp32, on the same 16-bit inputs;
    the backward on the JAX forward's out and lse, fed to both sides."""
    bh, sq, sk, causal, bias, window, p, offsets = case
    q, k, v, g, b = _case(3 * sq + sk, bh, sq, sk, bias=bias)
    scale = 64 ** -0.5
    drop = _drop(p, offsets)
    jdrop = dict(drop)
    if p:
        jdrop.update(dropout_seed=jnp.int32(drop["dropout_seed"]),
                     dropout_col_off=(offsets[1] + 2 ** 31) % 2 ** 32
                     - 2 ** 31)
    jq, jk, jv, jg = (_to_jax(a, dtype) for a in (q, k, v, g))
    jb = None if b is None else jnp.asarray(b)
    with force_mode("interpret"):
        jo, jl = jax_attn.flash_attention_fwd(jq, jk, jv, jb, scale, causal,
                                              interpret=True, window=window,
                                              **jdrop)
        jgrads = jax_attn.flash_attention_bwd(jq, jk, jv, jb, jo, jl, jg,
                                              scale, causal, interpret=True,
                                              window=window, **jdrop)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tb = None if b is None else torch.from_numpy(b)
    out, lse = attention.flash_attention_tc_reference(
        tq, tk, tv, tb, scale, causal, window, **drop)
    assert out.dtype == dtype and lse.dtype == F32
    w = _np(jo)
    assert (np.abs(out.float().numpy() - w).max()
            / max(1.0, np.abs(w).max())) <= 2e-2
    w = _np(jl)
    assert np.abs(lse.numpy() - w).max() / max(1.0, np.abs(w).max()) <= 2e-5
    tout = torch.from_numpy(_np(jo)).to(dtype)
    grads = attention.flash_attention_bwd_tc_reference(
        tq, tk, tv, tb, tout, torch.from_numpy(_np(jl)), tg, scale, causal,
        window, **drop)
    for a, jw in zip(grads, jgrads):
        assert a.dtype == dtype
        w = _np(jw)
        assert np.abs(a.float().numpy() - w).max() <= 1e-2 * np.abs(w).max()


@pytest.mark.parametrize("call,err,match", [
    (lambda z: attention.flash_attention_fwd(
        z(2, 8, 160), z(2, 8, 160), z(2, 8, 160), None, 1.0, True),
     ValueError, "head dim 160"),
    (lambda z: attention.flash_attention_fwd(
        z(2, 8, 64), z(2, 8, 64, dtype=F16), z(2, 8, 64), None, 1.0, True),
     TypeError, "dtypes differ"),
    (lambda z: attention.flash_attention_fwd(
        z(2, 8, 64, dtype=torch.int32), z(2, 8, 64, dtype=torch.int32),
        z(2, 8, 64, dtype=torch.int32), None, 1.0, True),
     TypeError, "not supported"),
    (lambda z: attention.flash_attention_fwd(
        z(2, 64, 8).transpose(1, 2), z(2, 8, 64), z(2, 8, 64), None, 1.0,
        True), ValueError, "contiguous"),
    (lambda z: attention.flash_attention_fwd(
        z(2, 8, 64), z(2, 9, 64), z(2, 8, 64), None, 1.0, True),
     ValueError, "do not match"),
    (lambda z: attention.flash_attention_fwd(
        z(2, 8, 64), z(2, 8, 64), z(2, 8, 64), z(2, 3, 8, dtype=F32), 1.0,
        True), ValueError, "bias shape"),
    (lambda z: attention.flash_attention_fwd(
        z(2, 8, 64), z(2, 8, 64), z(2, 8, 64), None, 1.0, True, window=0),
     ValueError, "window"),
    (lambda z: attention.flash_attention_bwd(
        z(2, 8, 64), z(2, 8, 64), z(2, 8, 64), None, z(2, 8, 64),
        z(2, 8, dtype=BF16), z(2, 8, 64), 1.0, True),
     ValueError, "lse must be fp32"),
    (lambda z: attention.flash_attention_bwd(
        z(2, 8, 64), z(2, 8, 64), z(2, 8, 64), None, z(2, 7, 64),
        z(2, 8, dtype=F32), z(2, 8, 64), 1.0, True),
     ValueError, "out shape"),
])
def test_wrappers_still_refuse_what_they_refused(call, err, match):
    def z(*shape, dtype=BF16):
        return torch.zeros(shape, dtype=dtype)
    with pytest.raises(err, match=match):
        call(z)
