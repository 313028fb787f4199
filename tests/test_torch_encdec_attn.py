"""Encoder-decoder attention of the port (``encdec_attn_func``,
``EncdecMultiheadAttn``) against the JAX package's.

On both impls (the flash path, its Pallas kernels in interpret mode, and
the materializing one), without a mask, with a key-padding mask and with a
time mask at Sq != Sk: the output and the gradients of the inputs and the
weights (``jax.grad`` against autograd, fp32, within 1e-5 of the largest
value).  The module with and without ``include_norm_add``, its weights
carried across by ``from_jax_state_dict``.  The flash path's dropout at Sq
!= Sk: the seed drawn from the caller's generator, fed to the JAX
``flash_attention`` between the same projections, gives the same output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.contrib.multihead_attn import \
    EncdecMultiheadAttn as JaxEncdec
from apex_tpu.contrib.multihead_attn import attn_funcs as jax_attn_funcs
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.nn.modules import Ctx

from apex_tpu_torch.contrib.multihead_attn import EncdecMultiheadAttn, \
    attn_funcs
from apex_tpu_torch.models import from_jax_state_dict

torch.set_num_threads(2)

TQ, TK, B, E, HEADS = 9, 17, 2, 32, 4
SCALE = (E // HEADS) ** -0.5


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err


def _mask(kind):
    """None, a key-padding mask (B, TK) or a time mask (TQ, TK), True where
    excluded; every query keeps some keys."""
    if kind == "keypad":
        m = np.zeros((B, TK), bool)
        m[1, 11:] = True
        return m
    if kind == "time":
        return np.arange(TK)[None, :] > np.arange(TQ)[:, None] + 4
    return None


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(TQ, B, E), f(TK, B, E), f(E, E) * 0.3, f(2 * E, E) * 0.3,
            f(E, E) * 0.3, f(TQ, B, E))


@pytest.mark.parametrize("impl", ["fast", "default"])
@pytest.mark.parametrize("kind", [None, "keypad", "time"])
def test_encdec_attn_func_and_gradients_match_jax(impl, kind):
    xq, xkv, wq, wkv, wo, g = _inputs()
    mask = _mask(kind)
    use_time = kind == "time"
    use_flash = impl == "fast"

    def jloss(*args):
        out = jax_attn_funcs.encdec_attn_func(
            use_time, True, HEADS, SCALE, *args,
            None if mask is None else jnp.asarray(mask), 0.0,
            use_flash=use_flash)
        return jnp.sum(out * jnp.asarray(g)), out
    with force_mode("interpret"):
        (_, jout), jgrads = jax.value_and_grad(
            jloss, argnums=tuple(range(5)), has_aux=True)(
                *map(jnp.asarray, (xq, xkv, wq, wkv, wo)))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (xq, xkv, wq, wkv, wo)]
    out = attn_funcs.encdec_attn_func(
        use_time, True, HEADS, SCALE, *leaves,
        None if mask is None else torch.from_numpy(mask), 0.0,
        use_flash=use_flash)
    assert out.shape == (TQ, B, E)
    _close(out.detach().numpy(), jout)
    (out * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, jgrads):
        _close(t.grad.numpy(), w)
    if kind == "keypad":
        # the padded keys of sequence 2 change nothing
        xkv2 = xkv.copy()
        xkv2[11:, 1] += 3.0
        other = attn_funcs.encdec_attn_func(
            False, True, HEADS, SCALE, leaves[0],
            torch.from_numpy(xkv2), *leaves[2:], torch.from_numpy(mask),
            use_flash=use_flash)
        np.testing.assert_allclose(other[:, 1].detach().numpy(),
                                   out[:, 1].detach().numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("impl,norm_add", [("fast", False), ("fast", True),
                                           ("default", True)])
def test_module_and_its_gradients_match_jax(impl, norm_add):
    jnn.manual_seed(4)
    jm = JaxEncdec(E, HEADS, dropout=0.0, include_norm_add=norm_add,
                   impl=impl)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(EncdecMultiheadAttn(
        E, HEADS, dropout=0.0, include_norm_add=norm_add, impl=impl,
        device="cpu"), sd)
    xq, xkv, *_, g = _inputs(1)
    kp = _mask("keypad")
    params = list(jm.parameters())
    names = [n for n, _ in jm.named_parameters()]

    def jloss(vals):
        ctx = Ctx(env={id(p): v for p, v in zip(params, vals)},
                  stats_out={}, training=True)
        out, none = jm.forward(ctx, jnp.asarray(xq), jnp.asarray(xkv),
                               key_padding_mask=jnp.asarray(kp))
        assert none is None
        return jnp.sum(out * jnp.asarray(g)), out
    with force_mode("interpret"):
        (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            [p.data for p in params])
    out, none = tm(torch.from_numpy(xq), torch.from_numpy(xkv),
                   key_padding_mask=torch.from_numpy(kp))
    assert none is None
    _close(out.detach().numpy(), jout)
    (out * torch.from_numpy(g)).sum().backward()
    tp = dict(tm.named_parameters())
    assert set(tp) == set(names)
    for n, w in zip(names, jgrads):
        _close(tp[n].grad.numpy(), w)


def test_flash_dropout_at_unequal_lengths_matches_jax_for_the_drawn_seed():
    """The seed is one int32 from the caller's generator: the same draw
    from a clone, fed to the JAX ``flash_attention`` between the same
    projections, gives the same output at Sq != Sk; the next call draws
    another seed; outside training nothing is drawn."""
    xq, xkv, wq, wkv, wo, _ = _inputs(2)
    kp = _mask("keypad")
    args = [torch.from_numpy(a) for a in (xq, xkv, wq, wkv, wo)]
    gen = torch.Generator().manual_seed(11)
    clone = torch.Generator().set_state(gen.get_state())
    got = attn_funcs.encdec_attn_func(False, True, HEADS, SCALE, *args,
                                      torch.from_numpy(kp), 0.3,
                                      generator=gen, use_flash=True)
    again = attn_funcs.encdec_attn_func(False, True, HEADS, SCALE, *args,
                                        torch.from_numpy(kp), 0.3,
                                        generator=gen, use_flash=True)
    assert not torch.allclose(got, again)
    seed = int(attn_funcs.draw_dropout_seed(clone))
    d = E // HEADS
    q = (xq @ wq.T).reshape(TQ, B * HEADS, d).swapaxes(0, 1)
    kv = (xkv @ wkv.T).reshape(TK, B * HEADS, 2, d)
    q4, k4, v4 = (a.reshape(B, HEADS, -1, d)
                  for a in (q, kv[:, :, 0].swapaxes(0, 1),
                            kv[:, :, 1].swapaxes(0, 1)))
    bias = np.where(kp, -1e30, 0.0).astype(np.float32)[:, None, :]
    with force_mode("interpret"):
        ctx4 = jax_attn_funcs.flash_attention(
            *map(jnp.asarray, (q4, k4, v4)), bias=jnp.asarray(bias),
            scale=SCALE, dropout_p=0.3, dropout_seed=jnp.int32(seed))
    ctx = np.asarray(ctx4).reshape(B * HEADS, TQ, d).swapaxes(0, 1)
    _close(got.numpy(), ctx.reshape(TQ, B, E) @ wo.T)
    plain = attn_funcs.encdec_attn_func(False, True, HEADS, SCALE, *args,
                                        torch.from_numpy(kp), 0.0,
                                        use_flash=True)
    assert (plain - got).abs().max() > 1e-3
    state = gen.get_state()
    attn_funcs.encdec_attn_func(False, False, HEADS, SCALE, *args,
                                torch.from_numpy(kp), 0.3, generator=gen,
                                use_flash=True)
    assert torch.equal(gen.get_state(), state)


def test_module_refusals_are_the_jax_packages():
    with pytest.raises(ValueError, match="does not support biases"):
        EncdecMultiheadAttn(E, HEADS, bias=True, device="cpu")
    with pytest.raises(ValueError, match="Unsupported impl"):
        EncdecMultiheadAttn(E, HEADS, impl="other", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        EncdecMultiheadAttn(E, HEADS, tensor_parallel_axis="model",
                            device="cpu")
    m = EncdecMultiheadAttn(E, HEADS, device="cpu")
    x = torch.zeros(TQ, B, E)
    with pytest.raises(ValueError, match="should not be both defined"):
        m(x, torch.zeros(TK, B, E),
          key_padding_mask=torch.from_numpy(_mask("keypad")),
          attn_mask=torch.from_numpy(_mask("time")))
