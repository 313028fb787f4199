"""The port's fused LM-head + cross-entropy (apex_tpu_torch.kernels.
lm_head_xent) and vocab-chain loss (apex_tpu_torch.kernels.vocab_chain)
against the JAX package's.

The plain versions (which CPU tensors take) and the port's autograd
``fused_lm_head_xent`` against the JAX ``fused_lm_head_xent`` under
``force_mode("interpret")`` (its Pallas kernels in interpret mode) and its
``jax.grad``, as ``tests/test_lm_head_xent.py`` runs it.  Vocabularies are
not a multiple of the Pallas kernel's 128-column block, and labels include
-1 and V, which match no column in the kernel (target 0, loss = lse).
Inputs are made with numpy from a seed and handed to both.  Tolerances:
1e-5 relative to the largest entry in fp32 (sums in another order); in
bf16 the gradients are rounded to bf16 on both sides from fp32 values that
agree to 1e-5, so they may land one bf16 step apart: 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.kernels.lm_head_xent import fused_lm_head_xent as jax_fused
from apex_tpu.kernels.vocab_chain import vocab_chain_loss as jax_vocab_chain

from apex_tpu_torch.contrib.xentropy import chunked_lm_head_loss
from apex_tpu_torch.kernels import counts, reset_counts
from apex_tpu_torch.kernels import lm_head_xent as k
from apex_tpu_torch.kernels.vocab_chain import vocab_chain_loss

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _case(n, v, e, dtype, seed):
    """x (n, e), emb (v, e) as fp32 numpy holding values of ``dtype``,
    labels with -1 and v among them, and per-row loss weights."""
    r = np.random.default_rng(seed)
    jd = DTYPES[dtype][0]
    x = np.array(jnp.asarray(r.normal(0, 1.0, (n, e)), jd)
                 .astype(jnp.float32))
    emb = np.array(jnp.asarray(r.normal(0, 0.3, (v, e)), jd)
                   .astype(jnp.float32))
    lab = r.integers(0, v, n)
    lab[1] = -1
    lab[3] = v
    lab[4] = v - 1
    gw = r.normal(0, 1, n).astype(np.float32)
    return x, emb, lab.astype(np.int64), gw


def _scaled(got, want, tol):
    """|got - want| within ``tol`` of max(1, max |want|)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _jax_side(x, emb, lab, gw, jd):
    """The JAX kernels in interpret mode: losses and the gradients of
    sum(losses * gw)."""
    jx, je = jnp.asarray(x, jd), jnp.asarray(emb, jd)
    jl = jnp.asarray(lab, jnp.int32)
    with force_mode("interpret"):
        per = jax_fused(jx, je, jl)
        gx, ge = jax.grad(lambda a, b: jnp.sum(
            jax_fused(a, b, jl) * jnp.asarray(gw)), argnums=(0, 1))(jx, je)
    return per, gx, ge


@pytest.mark.parametrize("n,v,e", [(16, 300, 32), (40, 301, 64),
                                   (128, 257, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_pallas_kernels(n, v, e, dtype):
    jd, td, tol = DTYPES[dtype]
    x, emb, lab, gw = _case(n, v, e, dtype, seed=n + v + e)
    per, gx, ge = _jax_side(x, emb, lab, gw, jd)
    tx, te = torch.from_numpy(x).to(td), torch.from_numpy(emb).to(td)
    tl = torch.from_numpy(lab)
    reset_counts()
    loss, lse = k.lm_head_xent_forward(tx, te, tl)
    assert loss.dtype == lse.dtype == torch.float32
    _scaled(loss, per, 1e-5)
    # a label outside [0, V) matches no column: its loss is the row's lse
    for i in (1, 3):
        assert float(loss[i]) == float(lse[i])
    dx, demb = k.lm_head_xent_backward(tx, te, tl, lse,
                                       torch.from_numpy(gw))
    assert dx.dtype == demb.dtype == td
    _scaled(dx.float(), np.asarray(gx, np.float32), tol)
    _scaled(demb.float(), np.asarray(ge, np.float32), tol)
    assert not any(counts().values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_jax_grad(dtype):
    jd, td, tol = DTYPES[dtype]
    x, emb, lab, gw = _case(24, 299, 40, dtype, seed=7)
    per, gx, ge = _jax_side(x, emb, lab, gw, jd)
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    te = torch.from_numpy(emb).to(td).requires_grad_(True)
    loss = k.fused_lm_head_xent(tx, te, torch.from_numpy(lab))
    (loss * torch.from_numpy(gw)).sum().backward()
    _scaled(loss.detach(), per, 1e-5)
    assert tx.grad.dtype == te.grad.dtype == td
    _scaled(tx.grad.float(), np.asarray(gx, np.float32), tol)
    _scaled(te.grad.float(), np.asarray(ge, np.float32), tol)


def test_labels_out_of_range_follow_the_kernel_arm():
    """-1 and V give loss = lse and no one-hot in the gradient; the JAX
    package's substrate fallback would wrap -1 to the last column."""
    x, emb, lab, _ = _case(8, 130, 16, "float32", seed=8)
    tx, te = torch.from_numpy(x), torch.from_numpy(emb)
    tl = torch.from_numpy(lab)
    loss, lse = k.lm_head_xent_forward_reference(tx, te, tl)
    s = tx @ te.t()
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=1))
    for i in range(8):
        want = lse[i] - (s[i, lab[i]] if 0 <= lab[i] < 130 else 0.0)
        torch.testing.assert_close(loss[i], want)
    g = torch.ones(8)
    dx, _ = k.lm_head_xent_backward_reference(tx, te, tl, lse, g)
    p = torch.softmax(s, dim=1)
    torch.testing.assert_close(dx[1], p[1] @ te)        # label -1
    torch.testing.assert_close(dx[3], p[3] @ te)        # label V


def test_vocab_chain_plain_ce_takes_the_kernel_arm_and_zeroes_padding():
    x, emb, lab, _ = _case(30, 211, 32, "float32", seed=9)
    lab[[0, 7, 12]] = -100                                # padding rows
    hidden = torch.from_numpy(x).reshape(3, 10, 32).requires_grad_(True)
    w = torch.from_numpy(emb).requires_grad_(True)
    labels = torch.from_numpy(lab).reshape(3, 10)
    per = vocab_chain_loss(hidden, w, labels)
    assert per.shape == (3, 10) and per.dtype == torch.float32
    flat = per.reshape(-1)
    assert float(flat[0].detach()) == float(flat[7].detach()) \
        == float(flat[12].detach()) == 0.0
    want = k.lm_head_xent_forward_reference(
        hidden.detach().reshape(30, 32), w.detach(), torch.from_numpy(lab))[0]
    keep = torch.from_numpy(lab != -100)
    torch.testing.assert_close(flat.detach()[keep], want[keep])
    per.sum().backward()
    assert float(hidden.grad.reshape(30, 32)[[0, 7, 12]].abs().max()) == 0.0
    # the JAX package's vocab chain on the same inputs
    with force_mode("interpret"):
        jper, (jgh, jgw) = jax.value_and_grad(
            lambda a, b: jnp.sum(jax_vocab_chain(
                a, b, jnp.asarray(lab.reshape(3, 10)))), argnums=(0, 1))(
            jnp.asarray(x.reshape(3, 10, 32)), jnp.asarray(emb))
    _scaled(per.sum().detach(), jper, 1e-5)
    _scaled(hidden.grad, np.asarray(jgh), 1e-5)
    _scaled(w.grad, np.asarray(jgw), 1e-5)


@pytest.mark.parametrize("kw", [dict(smoothing=0.1),
                                dict(logical_vocab=200)])
def test_vocab_chain_routes_smoothing_and_padded_heads_to_the_chunked_loss(
        kw, monkeypatch):
    x, emb, lab, _ = _case(20, 211, 32, "float32", seed=10)
    lab = np.clip(lab, 0, 199)
    hidden, w = torch.from_numpy(x), torch.from_numpy(emb)
    labels = torch.from_numpy(lab)

    def refuse(*a, **k_):
        raise AssertionError("the kernel arm was taken")
    monkeypatch.setattr("apex_tpu_torch.kernels.vocab_chain."
                        "fused_lm_head_xent", refuse)
    got = vocab_chain_loss(hidden, w, labels, padding_idx=-1, **kw)
    want = chunked_lm_head_loss(hidden, w, labels, padding_idx=-1, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with force_mode("interpret"):
        jwant = jax_vocab_chain(jnp.asarray(x), jnp.asarray(emb),
                                jnp.asarray(lab), padding_idx=-1, **kw)
    _scaled(got, np.asarray(jwant), 1e-5)


def test_wrappers_refuse_what_the_kernels_cannot_take():
    x, emb = torch.zeros(4, 8), torch.zeros(10, 8)
    lab = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match=r"x \(N, E\)"):
        k.lm_head_xent_forward(x, torch.zeros(10, 7), lab)
    with pytest.raises(ValueError, match="labels shape"):
        k.lm_head_xent_forward(x, emb, torch.zeros(3, dtype=torch.long))
    with pytest.raises(TypeError, match="integers"):
        k.lm_head_xent_forward(x, emb, torch.zeros(4))
    with pytest.raises(TypeError, match="not supported"):
        k.lm_head_xent_forward(x.double(), emb, lab)
    with pytest.raises(ValueError, match="lse shape"):
        k.lm_head_xent_backward(x, emb, lab, torch.zeros(3), torch.ones(4))
    # what only the kernel refuses: two dtypes, strided rows
    with pytest.raises(TypeError, match="one dtype"):
        k._kernel_args(x, emb.bfloat16(), lab, "lm_head_xent_forward")
    with pytest.raises(ValueError, match="contiguous"):
        k._kernel_args(torch.zeros(8, 4).t(), emb, lab,
                       "lm_head_xent_forward")
    assert k._kernel_args(x, emb, lab, "f").dtype == torch.int32


# the tensor-core route: which calls take it, and a model of its numerics

@pytest.mark.parametrize("dtype,e,addresses,want", [
    (torch.bfloat16, 768, (0, 1 << 20), "tc"),       # the Llama loss
    (torch.bfloat16, 8, (16, 48), "tc"),
    (torch.bfloat16, 520, (256, 4096), "tc"),         # a ragged last chunk
    (torch.float32, 768, (0, 1 << 20), "simt"),       # tc would be TF32
    (torch.float16, 768, (0, 1 << 20), "simt"),       # dl below fp16's range
    (torch.bfloat16, 100, (0, 1 << 20), "simt"),      # E * 2 not a multiple of 16
    (torch.bfloat16, 776, (0, 1 << 20), "simt"),      # own tile too wide
    (torch.bfloat16, 2048, (0, 1 << 20), "simt"),
    (torch.bfloat16, 768, (8, 1 << 20), "simt"),      # x's base misaligned
    (torch.bfloat16, 768, (0, 2), "simt"),            # emb's base misaligned
])
def test_route_is_chosen_from_dtype_width_and_alignment(dtype, e, addresses,
                                                        want):
    assert k.lmx_route(dtype, e, *addresses) == want


def test_every_route_and_kernel_has_a_counter():
    names = {f"lm_head_xent_{kern}_{route}" for kern in ("fwd", "dx", "demb")
             for route in k.ROUTES}
    assert names <= set(counts())
    assert k.ROUTES.index("simt") == 0 and k.ROUTES.index("tc") == 1


def _tc_model(x, emb, lab, g):
    """What the tensor-core kernels compute: fp32 logits of the bf16
    inputs, loss and lse in fp32, dl in fp32 rounded to bf16 before both
    products, which sum in fp32 and round to bf16."""
    s = x.float() @ emb.float().t()
    lse = torch.logsumexp(s, dim=1)
    hit = (torch.arange(emb.shape[0])[None, :] == lab[:, None]).float()
    loss = lse - (s * hit).sum(dim=1)
    dl = (g[:, None] * (torch.exp(s - lse[:, None]) - hit)).bfloat16()
    dx = (dl.float() @ emb.float()).bfloat16()
    demb = (dl.float().t() @ x.float()).bfloat16()
    return loss, lse, dx, demb


@pytest.mark.parametrize("n,v,e", [(40, 301, 64), (77, 517, 104)])
def test_tc_numerics_model_matches_pallas_kernels(n, v, e):
    """The bf16 dl of the tensor-core route stays within the 1e-2 that the
    card's checks hold dx and demb to, against the JAX kernels in interpret
    mode, with labels -1 and V; g of the size a mean over N gives."""
    x, emb, lab, _ = _case(n, v, e, "bfloat16", seed=3 * n + e)
    g = np.full(n, 1.0 / n, np.float32)
    per, gx, ge = _jax_side(x, emb, lab, g, jnp.bfloat16)
    loss, lse, dx, demb = _tc_model(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(emb).bfloat16(),
        torch.from_numpy(lab), torch.from_numpy(g))
    _scaled(loss, per, 1e-5)
    for i in (1, 3):
        assert float(loss[i]) == float(lse[i])
    for got, want in ((dx, gx), (demb, ge)):
        want = np.asarray(want, np.float32)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= 1e-2 * float(np.abs(want).max())
