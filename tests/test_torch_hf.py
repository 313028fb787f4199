"""The Hugging Face and torchvision converters of the port
(``apex_tpu_torch/models/hf.py``) against ``apex_tpu/models/hf.py``.

Neither ``transformers`` nor ``torchvision`` is installed, so the state
dicts are written out here, key by key in their layouts (GPT-2's Conv1D
``(in, out)`` weights and type-major ``c_attn``, Llama's ``(out, in)``
projections, torchvision's ResNet names with the batch norms' running
statistics), with values from ``numpy.random.default_rng``.  Each dict
goes through both packages' loaders; the port's logits must equal the JAX
model's within ``tests/test_hf_interop.py``'s tolerances (fp32, 2e-4 for
GPT-2, 3e-4 for Llama; ResNet there is exact between JAX models, 2e-4
across the packages), and greedy tokens must be equal.  Export after
import gives the dict back exactly, and the loaders refuse what the JAX
ones refuse.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt as jax_gpt
from apex_tpu.models import hf as jax_hf

from apex_tpu_torch.models import generate, hf

torch.set_num_threads(2)

VOCAB, HIDDEN, LAYERS, HEADS, POS = 97, 64, 2, 4, 32
L_VOCAB, L_HIDDEN, L_LAYERS, L_HEADS, L_KV, L_INTER = 211, 64, 2, 4, 2, 96


def _w(rng, *shape, s=0.05):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _gpt2_sd(seed=0, tied=True, prefix="transformer."):
    """``GPT2LMHeadModel.state_dict()``'s keys and shapes: Conv1D weights
    (in, out), c_attn's columns [Q | K | V], the causal-mask buffers, and
    the tied head."""
    rng = np.random.default_rng(seed)
    e = HIDDEN
    sd = {f"{prefix}wte.weight": _w(rng, VOCAB, e),
          f"{prefix}wpe.weight": _w(rng, POS, e),
          f"{prefix}ln_f.weight": 1 + _w(rng, e),
          f"{prefix}ln_f.bias": _w(rng, e)}
    for i in range(LAYERS):
        p = f"{prefix}h.{i}."
        sd.update({
            p + "ln_1.weight": 1 + _w(rng, e), p + "ln_1.bias": _w(rng, e),
            p + "attn.bias": np.tril(np.ones((POS, POS), np.float32))[
                None, None],
            p + "attn.c_attn.weight": _w(rng, e, 3 * e),
            p + "attn.c_attn.bias": _w(rng, 3 * e),
            p + "attn.c_proj.weight": _w(rng, e, e),
            p + "attn.c_proj.bias": _w(rng, e),
            p + "ln_2.weight": 1 + _w(rng, e), p + "ln_2.bias": _w(rng, e),
            p + "mlp.c_fc.weight": _w(rng, e, 4 * e),
            p + "mlp.c_fc.bias": _w(rng, 4 * e),
            p + "mlp.c_proj.weight": _w(rng, 4 * e, e),
            p + "mlp.c_proj.bias": _w(rng, e)})
    sd["lm_head.weight"] = sd[f"{prefix}wte.weight"] if tied \
        else _w(rng, VOCAB, e)
    return sd


def _llama_sd(seed=0, tied=False):
    """``LlamaForCausalLM.state_dict()``'s keys and shapes (GQA: k_proj and
    v_proj have L_KV heads' rows), with the rotary buffers; a tied
    checkpoint carries no ``lm_head.weight``."""
    rng = np.random.default_rng(seed)
    e, d = L_HIDDEN, L_HIDDEN // L_HEADS
    sd = {"model.embed_tokens.weight": _w(rng, L_VOCAB, e),
          "model.norm.weight": 1 + _w(rng, e)}
    for i in range(L_LAYERS):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": 1 + _w(rng, e),
            p + "post_attention_layernorm.weight": 1 + _w(rng, e),
            p + "self_attn.q_proj.weight": _w(rng, L_HEADS * d, e),
            p + "self_attn.k_proj.weight": _w(rng, L_KV * d, e),
            p + "self_attn.v_proj.weight": _w(rng, L_KV * d, e),
            p + "self_attn.o_proj.weight": _w(rng, e, L_HEADS * d),
            p + "self_attn.rotary_emb.inv_freq": _w(rng, d // 2),
            p + "mlp.gate_proj.weight": _w(rng, L_INTER, e),
            p + "mlp.up_proj.weight": _w(rng, L_INTER, e),
            p + "mlp.down_proj.weight": _w(rng, e, L_INTER)})
    if not tied:
        sd["lm_head.weight"] = _w(rng, L_VOCAB, e)
    return sd


def _resnet18_sd(seed=0, classes=10):
    """torchvision's ``resnet18`` state-dict names with a CIFAR stem (3x3
    conv1): BasicBlocks conv1/bn1/conv2/bn2, ``downsample.0`` (1x1 conv)
    and ``downsample.1`` (batch norm) where a stage changes width or
    stride, each batch norm with weight, bias, running_mean, running_var
    and an int64 num_batches_tracked; torch tensors as torch.load gives
    them."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = _w(rng, o, i, k, k, s=(2.0 / (i * k * k)) ** .5)

    def bn(name, c):
        sd.update({name + ".weight": 1 + _w(rng, c, s=0.1),
                   name + ".bias": _w(rng, c, s=0.1),
                   name + ".running_mean": _w(rng, c, s=0.1),
                   name + ".running_var": 1 + np.abs(_w(rng, c, s=0.2)),
                   name + ".num_batches_tracked": np.array(7, np.int64)})
    conv("conv1", 64, 3, 3)
    bn("bn1", 64)
    inp = 64
    for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2),
                                           (512, 2)), 1):
        for b in range(2):
            p = f"layer{li}.{b}."
            conv(p + "conv1", planes, inp, 3)
            bn(p + "bn1", planes)
            conv(p + "conv2", planes, planes, 3)
            bn(p + "bn2", planes)
            if b == 0 and (stride != 1 or inp != planes):
                conv(p + "downsample.0", planes, inp, 1)
                bn(p + "downsample.1", planes)
            inp = planes
    sd["fc.weight"] = _w(rng, classes, 512)
    sd["fc.bias"] = _w(rng, classes)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _ids(seed, b, s, v):
    return np.random.default_rng(seed).integers(0, v, (b, s))


def _logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids)).float().numpy()


def _jax_logits(model, ids):
    return np.asarray(model(jnp.asarray(ids)).value)


@pytest.mark.parametrize("prefix", ["transformer.", ""])
def test_gpt2_logits_and_greedy_tokens_equal_jax(prefix):
    sd = _gpt2_sd(seed=1, prefix=prefix)
    jm = jax_hf.gpt2_from_hf(sd, heads=HEADS)
    tm = hf.gpt2_from_hf(sd, heads=HEADS, device="cpu")
    assert not tm.training and tm.blocks[0].attn.num_heads == HEADS
    ids = _ids(2, 3, 17, VOCAB)
    np.testing.assert_allclose(_logits(tm, ids), _jax_logits(jm, ids),
                               rtol=2e-4, atol=2e-4)
    prompt = _ids(3, 2, 5, VOCAB)
    want = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 6))
    got = generate(tm, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gpt2_from_to_is_the_identity():
    sd = _gpt2_sd(seed=4)
    back = hf.gpt2_to_hf_state_dict(hf.gpt2_from_hf(sd, heads=HEADS,
                                                    device="cpu"))
    want = {k: v for k, v in sd.items() if not k.endswith(".attn.bias")}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # torch tensors (bf16 too, as checkpoints ship) load as their fp32
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tm = hf.gpt2_from_hf(tsd, heads=HEADS, device="cpu")
    np.testing.assert_array_equal(
        tm.blocks[1].fc2.weight.detach().numpy(),
        sd["transformer.h.1.mlp.c_proj.weight"].T)
    bf = hf.gpt2_from_hf({k: v.to(torch.bfloat16) for k, v in tsd.items()},
                         heads=HEADS, device="cpu")
    assert np.isfinite(_logits(bf, _ids(5, 1, 7, VOCAB))).all()


def test_gpt2_refusals_match_jax():
    for bad, match in ((_gpt2_sd(seed=5, tied=False), "not tied"),):
        for loader in (jax_hf.gpt2_from_hf,
                       lambda s, **k: hf.gpt2_from_hf(s, device="cpu", **k)):
            with pytest.raises(ValueError, match=match):
                loader(bad, heads=HEADS)
    sd = _gpt2_sd(seed=6)
    sd["transformer.h.0.mlp.c_fc.bias"] = np.zeros(3, np.float32)
    for loader in (jax_hf.gpt2_from_hf,
                   lambda s, **k: hf.gpt2_from_hf(s, device="cpu", **k)):
        with pytest.raises(ValueError, match="shape mismatch"):
            loader(sd, heads=HEADS)
    nobias = hf.gpt2_from_hf(_gpt2_sd(seed=7), heads=HEADS, device="cpu")
    nobias.blocks[0].attn.in_proj_bias = None
    with pytest.raises(ValueError, match="attention biases"):
        hf.gpt2_to_hf_state_dict(nobias)


@pytest.mark.parametrize("tied", [False, True])
def test_llama_logits_and_greedy_tokens_equal_jax(tied):
    sd = _llama_sd(seed=8, tied=tied)
    jm = jax_hf.llama_from_hf(sd, heads=L_HEADS)
    tm = hf.llama_from_hf(sd, heads=L_HEADS, device="cpu")
    assert tm.blocks[0].kv_heads == L_KV and not tm.training
    ids = _ids(9, 2, 13, L_VOCAB)
    np.testing.assert_allclose(_logits(tm, ids), _jax_logits(jm, ids),
                               rtol=3e-4, atol=3e-4)
    prompt = _ids(10, 2, 4, L_VOCAB)
    want = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 5))
    got = generate(tm, torch.from_numpy(prompt), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_llama_from_to_is_the_identity_and_refusals():
    sd = _llama_sd(seed=11)
    back = hf.llama_to_hf_state_dict(hf.llama_from_hf(sd, heads=L_HEADS,
                                                      device="cpu"))
    want = {k: v for k, v in sd.items() if "rotary_emb" not in k}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for loader in (jax_hf.llama_from_hf,
                   lambda s, **k: hf.llama_from_hf(s, device="cpu", **k)):
        with pytest.raises(ValueError, match="heads="):
            loader(sd)
        with pytest.raises(ValueError, match="not divisible"):
            loader(sd, heads=5)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        hf.mixtral_from_hf(sd)


def test_resnet_from_torch_equals_jax_and_round_trips():
    sd = _resnet18_sd(seed=12)
    jm = jax_hf.resnet_from_torch(sd)
    tm = hf.resnet_from_torch(sd, device="cpu")
    assert not tm.training and len(tm.layer2) == 2
    x = np.random.default_rng(13).standard_normal(
        (2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm(jnp.asarray(x)).value)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    own = tm.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert torch.equal(own[k].to(v.dtype), v), k
    # the imagenet example's checkpoint wrapper and DDP prefix
    ckpt = {"state_dict": {"module." + k: v for k, v in sd.items()},
            "epoch": 3}
    with torch.no_grad():
        np.testing.assert_array_equal(
            hf.resnet_from_torch(ckpt, device="cpu")(
                torch.from_numpy(x)).numpy(), got)


def test_resnet_from_torch_refuses_as_jax():
    sd = _resnet18_sd(seed=14)
    missing = dict(sd)
    del missing["layer1.0.bn1.weight"]
    extra = dict(sd)
    extra["layer9.0.conv1.weight"] = sd["conv1.weight"]
    wrong = dict(sd)
    wrong["fc.bias"] = torch.zeros(3)
    for bad, match in (({"foo.weight": sd["conv1.weight"]},
                        "does not look like"),
                       (missing, "missing parameter"), (extra, "no slot"),
                       (wrong, "shape mismatch")):
        for loader in (jax_hf.resnet_from_torch,
                       lambda s: hf.resnet_from_torch(s, device="cpu")):
            with pytest.raises(ValueError, match=match):
                loader(bad)
    old = {k: v for k, v in sd.items()
           if not k.endswith("num_batches_tracked")}
    assert not hf.resnet_from_torch(old, device="cpu").training
