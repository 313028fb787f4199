"""The port's xentropy kernels and losses against the JAX package's.

``xent_forward`` / ``xent_backward`` (the plain versions, which CPU tensors
take) against the Pallas kernels in interpret mode; the autograd
``softmax_cross_entropy_loss`` against the JAX ``custom_vjp`` under
interpret mode; the chunked LM-head loss against the JAX one.  Inputs are
made with numpy from a seed and handed to both.  Tolerances are the JAX
xentropy tests' own: ``rtol=1e-5, atol=1e-6`` in fp32 and ``rtol=2e-2,
atol=2e-3`` in bf16/fp16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import chunked_lm_head_loss as jax_chunked
from apex_tpu.contrib.xentropy import make_chunked_lm_loss as jax_make_chunked
from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss as jax_sxe
from apex_tpu.kernels import xentropy as jax_k
from apex_tpu.kernels.dispatch import force_mode

from apex_tpu_torch.contrib.xentropy import (SoftmaxCrossEntropyLoss,
                                             chunked_lm_head_loss,
                                             make_chunked_lm_loss,
                                             softmax_cross_entropy_loss)
from apex_tpu_torch.contrib.xentropy.chunked import _chunk_rows
from apex_tpu_torch.kernels import counts, reset_counts
from apex_tpu_torch.kernels import xentropy as k

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-3),
          "float16": (jnp.float16, torch.float16, 2e-2, 2e-3)}


def _case(rows, c, dtype, padding_idx, masked, seed=0):
    """Logits (numpy fp32 holding values of ``dtype``) and labels: a few
    rows at ``padding_idx``, one label past C, one negative non-padding
    label, and with ``masked`` the last columns of some rows at -1e30."""
    r = np.random.default_rng(seed)
    x = r.normal(0, 3, (rows, c)).astype(np.float32)
    if masked:
        x[::3, c - 41:] = -1e30
        x[5, :c // 2] = -1e30
    jd = DTYPES[dtype][0]
    x = np.array(jnp.asarray(x, jd).astype(jnp.float32))
    lab = r.integers(0, c, rows)
    lab[[2, 9, 30]] = padding_idx
    lab[4] = c + 3
    lab[7] = -5 if padding_idx != -5 else -6
    if masked:
        lab[0] = c - 2          # a label on a masked column
    return x, lab.astype(np.int64)


def _both(x, lab, dtype):
    jd, td = DTYPES[dtype][:2]
    return (jnp.asarray(x, jd), jnp.asarray(lab, jnp.int32),
            torch.from_numpy(x).to(td), torch.from_numpy(lab))


def _close(got, want, dtype, what):
    rtol, atol = DTYPES[dtype][2:]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("padding_idx", [0, -1])
@pytest.mark.parametrize("c,masked", [(1003, False), (1024, True)])
def test_kernels_match_pallas_interpret(dtype, smoothing, padding_idx, c,
                                        masked):
    x, lab = _case(37, c, dtype, padding_idx, masked)
    jx, jl, tx, tl = _both(x, lab, dtype)
    jloss, jlse = jax_k.xent_forward(jx, jl, smoothing, padding_idx,
                                     interpret=True)
    tloss, tlse, live = k.xent_forward(tx, tl, smoothing, padding_idx)
    assert tloss.dtype == tlse.dtype == torch.float32
    _close(tloss, jloss, "float32", "losses")
    _close(tlse, jlse, "float32", "lse")
    assert (tloss[[2, 9, 30]] == 0).all()
    want_live = (x > -1e29).sum(1) if smoothing else np.full(37, c)
    np.testing.assert_array_equal(live.numpy(), want_live)

    r = np.random.default_rng(1)
    gm = r.uniform(0.5, 1.5, 37).astype(np.float32)
    gm[lab == padding_idx] = 0.0
    lse = np.asarray(jlse)
    jdx = jax_k.xent_backward(jx, jl, jnp.asarray(lse), jnp.asarray(gm),
                              smoothing, interpret=True)
    tdx = k.xent_backward(tx, tl, torch.from_numpy(lse),
                          torch.from_numpy(gm), smoothing, live)
    assert tdx.dtype == tx.dtype and tdx.shape == tx.shape
    _close(tdx.float(), jnp.asarray(jdx, jnp.float32), dtype, "dlogits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("half_to_float", [False, True])
def test_softmax_cross_entropy_loss_matches_jax(dtype, smoothing,
                                                half_to_float):
    x, lab = _case(37, 1003, dtype, 0, True, seed=2)
    x = x.reshape(37, 1, 1003)
    lab = lab.reshape(37, 1)
    jx, jl, tx, tl = _both(x, lab, dtype)
    w = np.random.default_rng(3).uniform(0.5, 1.5, (37, 1)).astype(
        np.float32)

    def jloss(v):
        out = jax_sxe(v, jl, smoothing, 0, half_to_float)
        return (out.astype(jnp.float32) * w).sum(), out

    with force_mode("interpret"):
        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jx)
    tx.requires_grad_(True)
    tout = softmax_cross_entropy_loss(tx, tl, smoothing, 0, half_to_float)
    assert tout.dtype == (torch.float32 if half_to_float else tx.dtype)
    (tout.float() * torch.from_numpy(w)).sum().backward()
    _close(tout.detach().float(), jnp.asarray(jout, jnp.float32), dtype,
           "losses")
    _close(tx.grad.float(), jnp.asarray(jgrad, jnp.float32), dtype, "grad")
    assert (tx.grad[[2, 9, 30]] == 0).all()     # padding rows
    same = SoftmaxCrossEntropyLoss.apply(tx.detach(), tl, smoothing, 0,
                                         half_to_float)
    assert torch.equal(same, tout.detach())


def test_loss_launches_each_kernel_once_per_pass_on_cpu_tensors():
    """On CPU tensors the wrappers take the plain versions and count no
    launch; the autograd Function calls the forward once and the backward
    once."""
    reset_counts()
    x = torch.randn(4, 7, requires_grad=True)
    softmax_cross_entropy_loss(x, torch.tensor([1, 2, 0, 6]), 0.0, -1,
                               True).sum().backward()
    assert counts()["xent_forward"] == counts()["xent_backward"] == 0
    with pytest.raises(ValueError, match="labels"):
        k.xent_forward(torch.zeros(3, 4), torch.zeros(2, dtype=torch.long),
                       0.0, 0)
    with pytest.raises(TypeError, match="dtype"):
        k.xent_forward(torch.zeros(3, 4, dtype=torch.float64),
                       torch.zeros(3, dtype=torch.long), 0.0, 0)


def _chunked_case(n_rows, e, v, dtype, seed):
    r = np.random.default_rng(seed)
    h = r.normal(0, 1, (n_rows, e)).astype(np.float32)
    w = r.normal(0, 0.2, (v, e)).astype(np.float32)
    jd = DTYPES[dtype][0]
    h = np.array(jnp.asarray(h, jd).astype(jnp.float32))
    w = np.array(jnp.asarray(w, jd).astype(jnp.float32))
    lab = r.integers(0, v, n_rows).astype(np.int64)
    return h, w, lab


@pytest.mark.parametrize("case", [
    # (rows, chunk_rows, logical_vocab, smoothing, dtype)
    (24, None, None, 0.0, "float32"),          # one chunk
    (29, 8, None, 0.0, "float32"),             # 4 chunks, a remainder
    (29, 8, 101, 0.1, "float32"),              # padded head, smoothing
    (24, 7, None, 0.0, "bfloat16"),            # bf16 head and hidden
])
def test_chunked_lm_head_loss_matches_jax(case):
    n, chunk, lv, smoothing, dtype = case
    e, v = 32, 128 if lv else 103
    h, w, lab = _chunked_case(n, e, v, dtype, seed=n)
    if lv:
        lab = lab % lv
    lab[[1, 5]] = -100
    jd, td = DTYPES[dtype][:2]
    gw = np.random.default_rng(9).uniform(0.5, 1.5, n).astype(np.float32)

    def jfn(hh, ww):
        per = jax_chunked(hh, ww, jnp.asarray(lab, jnp.int32), smoothing,
                          -100, lv, chunk)
        return (per * gw).sum(), per

    with force_mode("interpret"):
        (_, jper), (jdh, jdw) = jax.value_and_grad(
            jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(h, jd),
                                               jnp.asarray(w, jd))
    th = torch.from_numpy(h).to(td).requires_grad_(True)
    tw = torch.from_numpy(w).to(td).requires_grad_(True)
    tper = chunked_lm_head_loss(th, tw, torch.from_numpy(lab), smoothing,
                                -100, lv, chunk)
    assert tper.dtype == torch.float32 and tper.shape == (n,)
    (tper * torch.from_numpy(gw)).sum().backward()
    assert th.grad.dtype == tw.grad.dtype == td
    _close(tper.detach(), jper, dtype, "losses")
    _close(th.grad.float(), jnp.asarray(jdh, jnp.float32), dtype, "dhidden")
    _close(tw.grad.float(), jnp.asarray(jdw, jnp.float32), dtype, "dweight")
    assert (tper[[1, 5]] == 0).all()


def test_make_chunked_lm_loss_means_over_padding_rows_like_jax():
    """The mean is over all rows, padding rows included (the JAX package's
    denominator, not torch's ignore_index mean)."""
    b, s, e, v = 2, 9, 16, 50
    h, w, _ = _chunked_case(b * s, e, v, "float32", seed=4)
    ids = np.random.default_rng(5).integers(0, v, (b, s))
    ids[0, 3:6] = -1
    jl = jax_make_chunked(padding_idx=-1, chunk_rows=5)(
        (jnp.asarray(h.reshape(b, s, e)), jnp.asarray(w)), jnp.asarray(ids))
    tl = make_chunked_lm_loss(padding_idx=-1, chunk_rows=5)(
        (torch.from_numpy(h.reshape(b, s, e)), torch.from_numpy(w)),
        torch.from_numpy(ids))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    per = chunked_lm_head_loss(torch.from_numpy(h.reshape(b, s, e))[:, :-1],
                               torch.from_numpy(w),
                               torch.from_numpy(ids)[:, 1:], padding_idx=-1)
    assert (per == 0).sum() == 3
    np.testing.assert_allclose(float(tl), float(per.sum()) / per.numel(),
                               rtol=1e-6)


@pytest.mark.parametrize("n,v,want", [
    (16368, 50257, 1023), (16368, 50304, 1023), (2046, 50257, 1023),
    (100, 50257, 100), (5000, 70000, 834), (4092, 50257, 1023)])
def test_chunk_rows_default_rule(n, v, want):
    assert _chunk_rows(n, v, None) == want
    assert _chunk_rows(n, v, 7) == min(7, n)
