"""Attention dropout in the flash kernels, against the JAX package's.

The mask is a counter-based hash of (seed, batch*head, global row, global
column); the port's plain version (``dropout_keep_reference``) must be the
JAX package's bit for bit, for negative and extreme seeds and for offsets
that wrap 32 bits.  Then the kernels' wrappers (their plain versions on
CPU tensors) against the JAX kernels in interpret mode, forward and
backward, at the same seed and offsets; ``flash_attention`` with autograd
against ``jax.grad``; and ``self_attn_func``, whose seed is drawn from the
caller's generator, against the JAX ``flash_attention`` fed the same seed.
The CUDA kernels run only on the card, where ``chip_smoke.py`` holds their
masks against this plain version entry by entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import attn_funcs as jax_attn_funcs
from apex_tpu.kernels import attention as jax_attn
from apex_tpu.kernels.dispatch import force_mode

from apex_tpu_torch.contrib.multihead_attn import attn_funcs
from apex_tpu_torch.kernels import attention

torch.set_num_threads(2)


def _wrap32(x):
    """An int as the int32 the JAX package holds it in."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


@pytest.mark.parametrize("seed", [0, -7, 2 ** 31 - 1, -2 ** 31, 123456789])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.9])
def test_dropout_mask_equals_jax_bit_for_bit(seed, rate):
    for row_off, col_off in ((0, 0), (1000, 37), (2 ** 31 - 5, -3),
                             (2 ** 32 - 9, 2 ** 32 + 5)):
        want = np.asarray(jax_attn.dropout_keep_reference(
            3, 9, 13, jnp.int32(seed), rate, _wrap32(row_off),
            _wrap32(col_off)))
        got = attention.dropout_keep_reference(3, 9, 13, seed, rate,
                                               row_off, col_off)
        assert got.dtype == torch.float32 and got.shape == (3, 9, 13)
        np.testing.assert_array_equal(got.numpy(), want)
        # a tensor seed (as self_attn_func draws it) gives the same mask
        t_seed = torch.tensor(_wrap32(seed), dtype=torch.int32)
        assert torch.equal(attention.dropout_keep_reference(
            3, 9, 13, t_seed, rate, row_off, col_off), got)
    kept = (got != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 0.2


def test_dropout_constants_are_the_jax_packages():
    for rate in (0.1, 0.5, 1e-9, 0.999999):
        thresh, scale = attention.dropout_constants(rate)
        assert thresh == min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)
        assert scale == float(np.float32(1.0 / (1.0 - rate)))


def _qkv(r, bh, sq, sk, d):
    return [r.normal(size=(bh, s, d)).astype(np.float32)
            for s in (sq, sk, sk, sq)]


@pytest.mark.parametrize("causal,with_bias,sq,sk,offsets", [
    (True, False, 80, 80, (0, 0)),
    (False, True, 130, 130, (1000, 37)),
    (True, True, 80, 130, (-5, 2 ** 31 - 40)),
])
def test_kernel_wrappers_match_jax_kernels_with_dropout(causal, with_bias, sq,
                                                        sk, offsets):
    r = np.random.default_rng(sq + sk)
    bh, d, rate, seed = 4, 16, 0.2, -99
    q, k, v, g = _qkv(r, bh, sq, sk, d)
    bias = r.normal(size=(1, sq, sk)).astype(np.float32) if with_bias \
        else None
    drop = dict(dropout_p=rate, dropout_seed=seed,
                dropout_row_off=offsets[0], dropout_col_off=offsets[1])
    jdrop = dict(drop, dropout_seed=jnp.int32(seed),
                 dropout_col_off=_wrap32(offsets[1]))
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    scale = d ** -0.5
    with force_mode("interpret"):
        jo, jl = jax_attn.flash_attention_fwd(
            *map(jnp.asarray, (q, k, v)), jb, scale, causal, interpret=True,
            **jdrop)
        want = jax_attn.flash_attention_bwd(
            *map(jnp.asarray, (q, k, v)), jb, jo, jl, jnp.asarray(g), scale,
            causal, interpret=True, **jdrop)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    to, tl = attention.flash_attention_fwd(tq, tk, tv, tb, scale, causal,
                                           **drop)
    got = attention.flash_attention_bwd(tq, tk, tv, tb, to, tl, tg, scale,
                                        causal, **drop)
    # fp32 on both sides, sums in another order: 1e-5 of the largest value
    for a, w in [(to, jo), (tl, jl)] + list(zip(got, want)):
        w = np.asarray(w)
        err = np.abs(a.numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= 1e-5, err
    # without dropout the result differs: the mask did something
    plain, _ = attention.flash_attention_fwd(tq, tk, tv, tb, scale, causal)
    assert (plain - to).abs().max() > 1e-3


@pytest.mark.parametrize("causal,with_bias,s", [(True, False, 80),
                                                (False, True, 130)])
def test_flash_attention_autograd_with_dropout_matches_jax(causal, with_bias,
                                                           s):
    r = np.random.default_rng(s)
    q, k, v = (r.normal(size=(2, 2, s, 16)).astype(np.float32)
               for _ in range(3))
    bias = r.normal(size=(2, 1, s)).astype(np.float32) if with_bias \
        else None
    seed = 2 ** 31 - 1

    def jloss(q, k, v):
        out = jax_attn_funcs.flash_attention(
            q, k, v, bias=None if bias is None else jnp.asarray(bias),
            causal=causal, dropout_p=0.1, dropout_seed=jnp.int32(seed))
        return jnp.sum(jnp.sin(out))
    with force_mode("interpret"):
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                       (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attn_funcs.flash_attention(
        *leaves, bias=None if bias is None else torch.from_numpy(bias),
        causal=causal, dropout_p=0.1, dropout_seed=seed)
    torch.sin(out).sum().backward()
    for t, w in zip(leaves, want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= 1e-5, err


def test_self_attn_func_draws_its_seed_from_the_generator():
    """The flash path's seed is one int32 from the caller's generator: the
    same draw from a clone of that generator, fed to the JAX
    ``flash_attention`` between the same projections, gives the same
    output; the next call draws a fresh seed, so another mask."""
    r = np.random.default_rng(21)
    t, b, heads, e = 40, 2, 4, 32
    x = torch.from_numpy(r.normal(size=(t, b, e)).astype(np.float32))
    w_in = torch.from_numpy((r.normal(size=(3 * e, e)) * 0.2)
                            .astype(np.float32))
    w_out = torch.from_numpy((r.normal(size=(e, e)) * 0.2)
                             .astype(np.float32))
    scale = (e // heads) ** -0.5
    gen = torch.Generator().manual_seed(5)
    clone = torch.Generator().set_state(gen.get_state())
    got = attn_funcs.self_attn_func(False, True, heads, scale, x, w_in,
                                    w_out, dropout_prob=0.25, generator=gen,
                                    use_flash=True)
    again = attn_funcs.self_attn_func(False, True, heads, scale, x, w_in,
                                      w_out, dropout_prob=0.25,
                                      generator=gen, use_flash=True)
    assert not torch.allclose(got, again)

    seed = attn_funcs.draw_dropout_seed(clone)
    assert seed.dtype == torch.int32 and seed.shape == ()
    q3, k3, v3 = attn_funcs._split_interleaved_qkv(
        torch.matmul(x, w_in.t()), t, b, heads, e // heads)
    q4, k4, v4 = (jnp.asarray(a.reshape(b, heads, t, e // heads).numpy())
                  for a in (q3, k3, v3))
    with force_mode("interpret"):
        ctx4 = jax_attn_funcs.flash_attention(
            q4, k4, v4, scale=scale, dropout_p=0.25,
            dropout_seed=jnp.int32(int(seed)))
    ctx = torch.from_numpy(np.array(ctx4)).reshape(b * heads, t, -1)
    want = torch.matmul(ctx.transpose(0, 1).reshape(t, b, e), w_out.t())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    # outside training, or at p = 0, nothing is drawn
    state = gen.get_state()
    attn_funcs.self_attn_func(False, False, heads, scale, x, w_in, w_out,
                              dropout_prob=0.25, generator=gen,
                              use_flash=True)
    assert torch.equal(gen.get_state(), state)


def test_dropout_arguments_are_checked_as_in_jax():
    q = torch.zeros(2, 8, 16)
    for call in (lambda: attention.flash_attention_fwd(
                     q, q, q, None, 0.25, True, dropout_p=0.1),
                 lambda: attention.flash_attention_bwd(
                     q, q, q, None, q, q[..., 0], q, 0.25, True,
                     dropout_p=0.1),
                 lambda: attn_funcs.flash_attention(
                     q[None], q[None], q[None], dropout_p=0.1)):
        with pytest.raises(ValueError, match="requires dropout_seed"):
            call()
    for p in (1.0, -0.1):
        with pytest.raises(ValueError, match=r"in \[0, 1\)"):
            attn_funcs.flash_attention(q[None], q[None], q[None],
                                       dropout_p=p, dropout_seed=1)
    # p = 0 ignores the seed: the plain attention
    a = attn_funcs.flash_attention(q[None] + 1, q[None], q[None] + 2,
                                   dropout_p=0.0, dropout_seed=3)
    assert torch.equal(a, attn_funcs.flash_attention(
        q[None] + 1, q[None], q[None] + 2))
