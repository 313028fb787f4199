"""The port's int8 weights and KV caches (``apex_tpu_torch/inference/
quant.py``) against ``apex_tpu/inference/quant.py``, on the CPU.

* the absmax core stores the JAX function's ``q`` and ``scale`` byte for
  byte (fp32 and bf16 weights, per-row and per-position);
* ``quantize_int8`` selects the JAX package's weights and stores its bytes
  on GPT and Llama; the weights read back dequantized through their
  module's property, the embedding through ``gather_rows``;
* greedy ``generate`` over int8 weights and an int8 KV cache gives the
  JAX package's tokens, and its logits track the float model's;
* a train step over a quantized model, and a reparameterization of an
  int8 weight, raise the JAX package's ``ValueError``; LoRA sources stay
  float.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import quant as jq
from apex_tpu.models import gpt as jax_gpt

from apex_tpu_torch.inference import quant
from apex_tpu_torch.models import generate
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.reparameterization import (LoRA, apply_lora,
                                               apply_weight_norm,
                                               remove_reparameterization)
from apex_tpu_torch.training import make_train_step
from torch_decode_pairs import ids, pair

torch.set_num_threads(2)

FAMILIES = ("gpt", "llama")


def _x(seed, shape, scale=1.0):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32) * scale
    x[0] *= 1e3                  # a row far from the others
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absmax_stores_the_jax_bytes(dtype):
    x = torch.from_numpy(_x(0, (64, 48)))
    if dtype == torch.bfloat16:
        x = x.to(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    got = quant.quantize_tensor_int8(x)
    want = jq.quantize_tensor_int8(jx)
    assert got.q.dtype == torch.int8 and got.scale.dtype == dtype
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.float().numpy(),
                                  np.asarray(want.scale, np.float32))
    np.testing.assert_array_equal(got.dequant().float().numpy(),
                                  np.asarray(want.dequant(), np.float32))
    # the per-position core of the KV cache, over the last axis
    kv = torch.from_numpy(_x(1, (2, 3, 5, 16)))
    q, s = quant.absmax_int8(kv, -1, torch.float32)
    jqv, js = jq.absmax_int8(jnp.asarray(kv.numpy()), -1, jnp.float32)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="1-D"):
        quant.quantize_tensor_int8(torch.ones(8))


def test_int8_kv_cache_writes_the_jax_bytes():
    new = torch.from_numpy(_x(2, (2, 3, 4, 8)))
    cache = quant.make_kv_cache((2, 3, 10, 8), "int8", "cpu")
    jcache = jq.make_kv_cache((2, 3, 10, 8), "int8")
    for t0 in (0, 5):
        quant.kv_write(cache, new, (0, 0, torch.tensor(t0), 0))
        jcache = jq.kv_write(jcache, jnp.asarray(new.numpy()), (0, 0, t0, 0))
    np.testing.assert_array_equal(cache.q.numpy(), np.asarray(jcache.q))
    np.testing.assert_array_equal(cache.scale.numpy(),
                                  np.asarray(jcache.scale))
    np.testing.assert_array_equal(quant.kv_value(cache).numpy(),
                                  np.asarray(jq.kv_value(jcache)))


@pytest.mark.parametrize("family", FAMILIES)
def test_quantize_int8_stores_the_jax_bytes_and_decodes_as_jax(family):
    jm, tm = pair(family, seed=21)
    prompt = ids(3, 2, 6)
    with torch.no_grad():
        float_logits = tm(torch.from_numpy(prompt))
    jq.quantize_int8(jm, min_size=256)
    quant.quantize_int8(tm, min_size=256)
    assert not tm.training
    n = 0
    for name, p in jm.named_parameters():
        mod, _, leaf = name.rpartition(".")
        owner = tm.get_submodule(mod)
        if isinstance(p.data, jq.QuantTensor):
            assert leaf in quant.quantized_names(owner), name
            got = quant.raw(owner, leaf)
            np.testing.assert_array_equal(got.q.numpy(),
                                          np.asarray(p.data.q))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(p.data.scale))
            # the module's attribute reads the dequantized weight
            assert torch.equal(getattr(owner, leaf), got.dequant())
            n += 1
        else:
            assert leaf not in quant.quantized_names(owner), name
    assert n > 0 and not any(p.dim() >= 2 and p.numel() >= 256
                             for p in tm.parameters())
    want = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 8,
                                       cache_dtype="int8"))
    got = generate(tm, torch.from_numpy(prompt), 8, cache_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        q_logits = tm(torch.from_numpy(prompt))
    # int8 weights track the float logits (the JAX test's closeness)
    rel = (q_logits - float_logits).norm() / float_logits.norm()
    assert rel < 0.05
    with pytest.raises(ValueError, match="nothing was quantized"):
        quant.quantize_int8(pair(family, seed=1)[1], min_size=10 ** 9)


def test_gather_rows_dequantizes_only_the_selected_rows():
    table = torch.from_numpy(_x(4, (64, 16)))
    sel = torch.from_numpy(ids(5, 3, 5, v=64))
    assert torch.equal(quant.gather_rows(table, sel), table[sel])
    qt = quant.quantize_tensor_int8(table)
    assert torch.equal(quant.gather_rows(qt, sel), qt.dequant()[sel])


def test_quantized_models_are_inference_only():
    _, tm = pair("llama", seed=22)
    quant.quantize_int8(tm, min_size=256)
    opt = FusedAdam(list(tm.parameters()), lr=1e-4)
    with pytest.raises(ValueError, match="inference-only"):
        make_train_step(tm, opt, lambda o, y: o.float().mean())
    # a reparameterization of an int8 weight: the JAX package's error
    with pytest.raises(ValueError, match="int8-quantized weight"):
        apply_lora(tm.blocks[0].q_proj, "weight", r=2)
    with pytest.raises(ValueError, match="int8-quantized weight"):
        apply_weight_norm(tm.blocks[0].q_proj, "weight")
    apply_lora(tm, r=2)                 # the sweep skips int8 weights
    assert "weight_q" in tm.blocks[0].q_proj.state_dict()


def test_quantize_skips_lora_sources_and_quantizes_a_merge():
    _, tm = pair("llama", seed=23)
    apply_lora(tm, r=2, generator=torch.Generator().manual_seed(0))
    quant.quantize_int8(tm, min_size=1)
    for name, p in tm.named_parameters():
        if name.endswith(("_w0", "_lora_a", "_lora_b")):
            assert p.is_floating_point(), name
    assert "weight" in quant.quantized_names(tm.tok_emb)
    _, tm2 = pair("llama", seed=23)
    apply_lora(tm2, r=2, generator=torch.Generator().manual_seed(0))
    remove_reparameterization(tm2, LoRA, remove_all=True)
    quant.quantize_int8(tm2, min_size=1)
    assert not any(p.dim() >= 2 for p in tm2.parameters())
