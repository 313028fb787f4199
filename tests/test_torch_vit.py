"""The port's Vision Transformer (``models.vit``) against the JAX
package's, on a tiny model (32 x 32 images, patch 8: 17 tokens; width 32,
4 heads, 10 classes) whose weights are carried across by
``from_jax_state_dict``.

The logits and every gradient of a loss over them, without and with
``remat`` on the port's side (fp32 within 1e-4 of the JAX model without
remat, which the JAX remat tests hold equal to its remat), the JAX side
taking its Pallas kernels' plain references on the CPU, as the JAX
package's own ViT tests do; three bf16 fused AdamW steps with
``F.cross_entropy`` against the JAX step's losses (2e-2: the frameworks
round bf16 activations at different places); the input-size errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.models import VitModel as JaxVit
from apex_tpu.nn import functional as JF
from apex_tpu.nn.modules import Ctx
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.models import VitModel, from_jax_state_dict, vit_base, \
    vit_small
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step

torch.set_num_threads(2)

CFG = dict(image_size=32, patch_size=8, hidden=32, layers=2, heads=4,
           num_classes=10)
B = 3


def _pair(**kw):
    cfg = {**CFG, **kw}
    jnn.manual_seed(8)
    jm = JaxVit(**cfg)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(VitModel(**cfg, device="cpu"), sd)
    return jm, tm


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err


def _images(seed=0, b=B, size=32):
    return np.random.default_rng(seed).standard_normal(
        (b, 3, size, size)).astype(np.float32)


X = _images()
G = np.random.default_rng(1).normal(size=(B, 10)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_result():
    """The JAX model's logits and gradients of sum(logits * G), and its
    state dict."""
    jm, _ = _pair()
    params = list(jm.parameters())

    def jloss(vals):
        ctx = Ctx(env={id(p): v for p, v in zip(params, vals)},
                  stats_out={}, training=True)
        logits = jm.forward(ctx, jnp.asarray(X))
        return jnp.sum(logits * jnp.asarray(G)), logits
    (_, logits), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [p.data for p in params])
    names = [n for n, _ in jm.named_parameters()]
    return logits, dict(zip(names, grads))


@pytest.mark.parametrize("remat", [False, True])
def test_logits_and_gradients_match_jax(jax_result, remat):
    jlogits, jgrads = jax_result
    _, tm = _pair(remat=remat)
    logits = tm(torch.from_numpy(X))
    assert logits.shape == (B, 10)
    _close(logits.detach().numpy(), jlogits)
    (logits * torch.from_numpy(G)).sum().backward()
    tp = dict(tm.named_parameters())
    assert set(tp) == set(jgrads)
    for n, w in jgrads.items():
        _close(tp[n].grad.numpy(), w)


def test_bf16_fused_adamw_steps_match_jax():
    """The bench's ViT step in miniature (one block, to keep the JAX
    step's compile short): bf16 half copies, static scale 1,
    FusedAdam(adam_w_mode, weight decay 0.05), cross entropy."""
    jm, tm = _pair(layers=1)
    kw = dict(lr=1e-3, adam_w_mode=True, weight_decay=0.05)
    jstep = jax_make_train_step(
        jm, JaxFusedAdam(list(jm.parameters()), **kw),
        lambda out, y: JF.cross_entropy(out, y), half_dtype=jnp.bfloat16,
        loss_scale=1.0)
    tstep = make_train_step(
        tm, FusedAdam(list(tm.parameters()), **kw),
        lambda out, y: F.cross_entropy(out, y), half_dtype=torch.bfloat16,
        loss_scale=1.0)
    x = _images(2, b=4)
    y = np.random.default_rng(3).integers(0, 10, (4,))
    want = [float(jstep(jnp.asarray(x), jnp.asarray(y))) for _ in range(3)]
    got = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0]


def test_geometries_and_input_size_errors():
    _, tm = _pair()
    with pytest.raises(ValueError, match="built for 16 patches, got 36"):
        tm(torch.from_numpy(_images(size=48)))
    with pytest.raises(ValueError, match="not divisible by patch_size"):
        VitModel(image_size=30, patch_size=8, device="cpu")
    for make, hidden, heads in ((vit_small, 384, 6), (vit_base, 768, 12)):
        m = make(num_classes=5, layers=1, device="cpu")
        assert m.pos_emb.shape == (197, hidden)
        assert m.blocks[0].attn.num_heads == heads
        assert m.patch_embed.weight.shape == (hidden, 3, 16, 16)
