"""Hugging Face and torchvision checkpoint interop, the PyTorch counterpart
of ``apex_tpu/models/hf.py``: load ``transformers`` GPT-2 weights into the
:mod:`.gpt` family and Llama/Mistral weights into :mod:`.llama`, export
both back, and load torchvision ResNets into :mod:`.resnet`.

Each loader takes a module with a ``state_dict()`` (and, for the head
counts, a ``config``) or a bare state dict of torch tensors or numpy
arrays; nothing here imports ``transformers`` or ``torchvision``.  The
layout rules are the JAX package's, kept here as a copy:

* HF GPT-2 linears are ``Conv1D``: weight ``(in, out)``, ``y = x W + b``,
  the transpose of ``nn.Linear.weight (out, in)``.
* HF packs QKV type-major: ``c_attn``'s columns are ``[Q(E) | K(E) |
  V(E)]``, head-major inside each.  The attention module here takes the
  reference's interleaved head-major rows ``[q_h | k_h | v_h]`` per head,
  so the loaded tensor is ``W.T`` reshaped ``(3, H, D, E)``, transposed to
  ``(H, 3, D, E)``; export inverts it.
* GPT-2's head is tied to ``wte``; an untied ``lm_head.weight`` is refused.

The models are built on the card unless ``device="cpu"`` is passed (the
models' own rule), in fp32, and returned in ``eval()`` mode.
"""
from __future__ import annotations

import numpy as np
import torch

from .._unported import PARALLEL, refuse


def _to_numpy(t):
    """A torch tensor or array as float32 numpy (torch tensors through
    ``.float()``: numpy has no bf16, the checkpoints' usual dtype)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _interleave_qkv(w_t, heads, head_dim):
    """HF type-major ``(3E, E)`` (already transposed from Conv1D) ->
    interleaved head-major ``(3E, E)``."""
    e = heads * head_dim
    return w_t.reshape(3, heads, head_dim, e).transpose(1, 0, 2, 3) \
              .reshape(3 * e, e)


def _interleave_qkv_bias(b, heads, head_dim):
    return b.reshape(3, heads, head_dim).transpose(1, 0, 2).reshape(-1)


def _deinterleave_qkv(w, heads, head_dim):
    """Interleaved head-major ``(3E, E)`` -> HF type-major ``(3E, E)``
    (the inverse of :func:`_interleave_qkv`)."""
    e = heads * head_dim
    return w.reshape(heads, 3, head_dim, e).transpose(1, 0, 2, 3) \
            .reshape(3 * e, e)


def _deinterleave_qkv_bias(b, heads, head_dim):
    return b.reshape(heads, 3, head_dim).transpose(1, 0, 2).reshape(-1)


def _put(param, value):
    """A checkpoint tensor into a parameter or buffer in place,
    shape-checked."""
    value = np.asarray(value, np.float32)
    if tuple(param.shape) != value.shape:
        raise ValueError(
            f"shape mismatch loading HF weights: model "
            f"{tuple(param.shape)} vs checkpoint {value.shape}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def gpt2_from_hf(src, dropout=0.1, attn_dropout=0.0, **model_kw):
    """A :class:`~.gpt.GptModel` carrying the weights of an HF GPT-2.

    ``src``: a ``GPT2LMHeadModel``-shaped module or its state dict; keys
    may carry the ``transformer.`` prefix.  The geometry is read from the
    tensors, the head count from ``src.config.n_head``, ``heads=``, or
    GPT-2's hidden / 64.  The attention biases select the attention
    module's materialising path (``attn_bias=True``), as in the JAX
    package.  Returns the model in ``eval()`` mode."""
    from .gpt import GptModel

    sd = src.state_dict() if hasattr(src, "state_dict") else dict(src)
    # strip "transformer.", drop the causal-mask buffers ("attn.bias" is
    # HF's triangle constant, not a parameter); the head aside for the tie
    # check
    norm, lm_head = {}, None
    for k, v in sd.items():
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        if k == "lm_head.weight":
            lm_head = _to_numpy(v)
            continue
        if k.endswith(".attn.bias") or k.endswith(".attn.masked_bias"):
            continue
        norm[k] = _to_numpy(v)

    wte = norm["wte.weight"]
    wpe = norm["wpe.weight"]
    if lm_head is not None and (lm_head.shape != wte.shape
                                or not np.array_equal(lm_head, wte)):
        raise ValueError(
            "checkpoint's lm_head.weight is not tied to wte.weight — "
            "this GPT family has a weight-tied head and cannot represent "
            "an untied checkpoint")
    vocab, hidden = wte.shape
    layers = 1 + max(int(k.split(".")[1]) for k in norm if k.startswith("h."))
    inter = norm["h.0.mlp.c_fc.weight"].shape[1]
    heads = model_kw.pop("heads", None)
    if heads is None:
        heads = getattr(getattr(src, "config", None), "n_head", None)
    if heads is None:
        heads = hidden // 64
    head_dim = hidden // heads

    model = GptModel(vocab_size=vocab, hidden=hidden, layers=layers,
                     heads=heads, intermediate=inter,
                     max_positions=wpe.shape[0], dropout=dropout,
                     attn_dropout=attn_dropout, attn_bias=True, **model_kw)

    _put(model.tok_emb.weight, wte)
    _put(model.pos_emb.weight, wpe)
    _put(model.ln_f.weight, norm["ln_f.weight"])
    _put(model.ln_f.bias, norm["ln_f.bias"])
    for i, blk in enumerate(model.blocks):
        p = f"h.{i}."
        _put(blk.ln1.weight, norm[p + "ln_1.weight"])
        _put(blk.ln1.bias, norm[p + "ln_1.bias"])
        _put(blk.ln2.weight, norm[p + "ln_2.weight"])
        _put(blk.ln2.bias, norm[p + "ln_2.bias"])
        _put(blk.attn.in_proj_weight,
             _interleave_qkv(norm[p + "attn.c_attn.weight"].T, heads,
                             head_dim))
        _put(blk.attn.in_proj_bias,
             _interleave_qkv_bias(norm[p + "attn.c_attn.bias"], heads,
                                  head_dim))
        _put(blk.attn.out_proj_weight, norm[p + "attn.c_proj.weight"].T)
        _put(blk.attn.out_proj_bias, norm[p + "attn.c_proj.bias"])
        _put(blk.fc1.weight, norm[p + "mlp.c_fc.weight"].T)
        _put(blk.fc1.bias, norm[p + "mlp.c_fc.bias"])
        _put(blk.fc2.weight, norm[p + "mlp.c_proj.weight"].T)
        _put(blk.fc2.bias, norm[p + "mlp.c_proj.bias"])
    model.eval()
    return model


def llama_from_hf(src, **model_kw):
    """A :class:`~.llama.LlamaModel` carrying the weights of an HF
    ``LlamaForCausalLM`` / ``MistralForCausalLM``.

    ``src``: the module (geometry from ``.config``) or a bare state dict,
    with ``heads=`` (and ``kv_heads=`` if grouped) and any of
    ``rope_theta`` / ``eps`` / ``max_positions`` that differ from the
    Llama defaults.  The linears are ``(out, in)`` on both sides.  A tied
    checkpoint (no ``lm_head.weight``) loads the embedding into the head,
    which is the tied forward."""
    norm, emb, geom, dflt = _llama_prelude(src, model_kw)
    inter = norm["layers.0.mlp.gate_proj.weight"].shape[0]

    from .llama import LlamaModel
    model = LlamaModel(
        intermediate=inter,
        max_positions=dflt("max_positions", "max_position_embeddings",
                           2048),
        rope_theta=dflt("rope_theta", "rope_theta", 10000.0),
        eps=dflt("eps", "rms_norm_eps", 1e-6),
        sliding_window=dflt("sliding_window", "sliding_window", None),
        **geom, **model_kw)

    _load_llama_trunk(model, norm, emb)
    for i, blk in enumerate(model.blocks):
        p = f"layers.{i}."
        for name in ("gate_proj", "up_proj", "down_proj"):
            _put(getattr(blk, name).weight,
                 norm[p + "mlp." + name + ".weight"])
    model.eval()
    return model


def _llama_prelude(src, model_kw):
    """The Llama loaders' front half: keys normalised (``model.``
    stripped, rotary buffers dropped), the geometry recovered with the
    heads / kv_heads checks, and the config-or-override resolver.
    Returns ``(norm, emb, geometry kwargs, dflt)``; pops the override keys
    from ``model_kw``."""
    sd = src.state_dict() if hasattr(src, "state_dict") else dict(src)
    norm = {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if k.endswith("rotary_emb.inv_freq"):
            continue
        norm[k] = _to_numpy(v)

    emb = norm["embed_tokens.weight"]
    vocab, hidden = emb.shape
    layers = 1 + max(int(k.split(".")[1]) for k in norm
                     if k.startswith("layers."))

    cfg = getattr(src, "config", None)
    heads = model_kw.pop("heads", None) \
        or getattr(cfg, "num_attention_heads", None)
    if heads is None:
        raise ValueError(
            "head count is not recoverable from a bare state dict — "
            "pass heads= (and kv_heads= for GQA checkpoints)")
    # q_proj has heads * head_dim rows (head_dim need not be hidden / heads)
    q_rows = norm["layers.0.self_attn.q_proj.weight"].shape[0]
    if q_rows % heads:
        raise ValueError(
            f"q_proj rows {q_rows} are not divisible by heads={heads} — "
            f"wrong heads=?")
    head_dim = q_rows // heads
    kv_rows = norm["layers.0.self_attn.k_proj.weight"].shape[0]
    kv_heads = model_kw.pop("kv_heads", None) or kv_rows // head_dim
    if kv_heads * head_dim != kv_rows:
        raise ValueError(
            f"k_proj rows {kv_rows} are not kv_heads*head_dim with "
            f"heads={heads} (head_dim {head_dim}) — wrong heads=?")

    def dflt(key, attr, fallback):
        v = model_kw.pop(key, None)
        if v is None:
            v = getattr(cfg, attr, None)
        return fallback if v is None else v

    geom = dict(vocab_size=vocab, hidden=hidden, layers=layers,
                heads=heads, kv_heads=kv_heads, head_dim=head_dim)
    return norm, emb, geom, dflt


def _load_llama_trunk(model, norm, emb):
    """The embedding, final norm, (possibly tied) head and every block's
    norms and attention projections."""
    _put(model.tok_emb.weight, emb)
    _put(model.norm.weight, norm["norm.weight"])
    _put(model.lm_head.weight, norm.get("lm_head.weight", emb))
    for i, blk in enumerate(model.blocks):
        p = f"layers.{i}."
        _put(blk.ln1.weight, norm[p + "input_layernorm.weight"])
        _put(blk.ln2.weight, norm[p + "post_attention_layernorm.weight"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _put(getattr(blk, name).weight,
                 norm[p + "self_attn." + name + ".weight"])


def gpt2_to_hf_state_dict(model):
    """A :class:`~.gpt.GptModel` as an HF ``GPT2LMHeadModel`` state dict
    (float32 numpy values, ``transformer.``-prefixed keys and the tied
    ``lm_head.weight``): the inverse of :func:`gpt2_from_hf`."""
    if getattr(model, "moe_axis", None) is not None:
        raise ValueError(
            "gpt2_to_hf_state_dict: MoE models have no GPT2LMHeadModel "
            "layout (export the dense family, or the experts separately)")
    heads = model.blocks[0].attn.num_heads
    head_dim = model.blocks[0].attn.head_dim
    attn0 = model.blocks[0].attn
    if attn0.in_proj_bias is None or attn0.out_proj_bias is None:
        raise ValueError(
            "gpt2_to_hf_state_dict requires attention biases (HF "
            "GPT-2's Conv1D projections always carry them) — build "
            "the model with attn_bias=True, as gpt2_from_hf does")
    sd = {}
    np32 = _to_numpy
    # a padded vocabulary's pad rows are the model's own: the checkpoint
    # carries the logical vocabulary
    sd["transformer.wte.weight"] = np32(
        model.tok_emb.weight)[:model.vocab_size]
    sd["transformer.wpe.weight"] = np32(model.pos_emb.weight)
    sd["transformer.ln_f.weight"] = np32(model.ln_f.weight)
    sd["transformer.ln_f.bias"] = np32(model.ln_f.bias)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    for i, blk in enumerate(model.blocks):
        p = f"transformer.h.{i}."
        sd[p + "ln_1.weight"] = np32(blk.ln1.weight)
        sd[p + "ln_1.bias"] = np32(blk.ln1.bias)
        sd[p + "ln_2.weight"] = np32(blk.ln2.weight)
        sd[p + "ln_2.bias"] = np32(blk.ln2.bias)
        sd[p + "attn.c_attn.weight"] = _deinterleave_qkv(
            np32(blk.attn.in_proj_weight), heads, head_dim).T
        sd[p + "attn.c_attn.bias"] = _deinterleave_qkv_bias(
            np32(blk.attn.in_proj_bias), heads, head_dim)
        sd[p + "attn.c_proj.weight"] = np32(blk.attn.out_proj_weight).T
        sd[p + "attn.c_proj.bias"] = np32(blk.attn.out_proj_bias)
        sd[p + "mlp.c_fc.weight"] = np32(blk.fc1.weight).T
        sd[p + "mlp.c_fc.bias"] = np32(blk.fc1.bias)
        sd[p + "mlp.c_proj.weight"] = np32(blk.fc2.weight).T
        sd[p + "mlp.c_proj.bias"] = np32(blk.fc2.bias)
    return sd


def llama_to_hf_state_dict(model):
    """A :class:`~.llama.LlamaModel` as an HF ``LlamaForCausalLM`` state
    dict (float32 numpy values): the inverse of :func:`llama_from_hf`."""
    if getattr(model, "moe_axis", None) is not None:
        raise ValueError(
            "llama_to_hf_state_dict: MoE models have no LlamaForCausalLM "
            "layout (export the dense family, or the experts separately)")
    sd = {}
    np32 = _to_numpy
    sd["model.embed_tokens.weight"] = np32(model.tok_emb.weight)
    sd["model.norm.weight"] = np32(model.norm.weight)
    sd["lm_head.weight"] = np32(model.lm_head.weight)
    for i, blk in enumerate(model.blocks):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = np32(blk.ln1.weight)
        sd[p + "post_attention_layernorm.weight"] = np32(blk.ln2.weight)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[p + "self_attn." + name + ".weight"] = \
                np32(getattr(blk, name).weight)
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[p + "mlp." + name + ".weight"] = \
                np32(getattr(blk, name).weight)
    return sd


def mixtral_from_hf(src, moe_axis="data", capacity_factor=8.0,
                    aux_weight=0.0, **model_kw):
    """The JAX package's Mixtral loader needs the mixture-of-experts
    blocks, which are not ported."""
    refuse("mixtral_from_hf (mixture-of-experts blocks)", PARALLEL)


def resnet_from_torch(src, **model_kw):
    """A :class:`~.resnet.ResNet` carrying the weights of a torchvision
    ResNet (18/34/50/101 and the like).

    ``src``: a module, a ``state_dict()`` mapping, or a ``torch.load``
    result (``state_dict`` / ``model`` wrappers and DDP ``module.``
    prefixes are unwrapped).  The block type, stage depths, class count
    and CIFAR or ImageNet stem are read from the tensors; the module tree
    takes torchvision's names, so the load is by name with shape checks,
    and missing or unexpected keys raise.  Returns the model in ``eval()``
    mode with the batch norms' running statistics loaded
    (``num_batches_tracked`` where present)."""
    from .resnet import BasicBlock, Bottleneck, ResNet

    sd = src.state_dict() if hasattr(src, "state_dict") else dict(src)
    for wrap in ("state_dict", "model"):
        if wrap in sd and not hasattr(sd[wrap], "shape"):
            sd = dict(sd[wrap])
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}

    for needed in ("conv1.weight", "fc.weight", "layer1.0.conv1.weight"):
        if needed not in sd:
            raise ValueError(
                f"state dict does not look like a torchvision ResNet: "
                f"missing '{needed}'")
    depths = [1 + max(int(k.split(".")[1]) for k in sd
                      if k.startswith(f"layer{i}."))
              for i in range(1, 5)]
    block = Bottleneck if "layer1.0.conv3.weight" in sd else BasicBlock
    num_classes = sd["fc.weight"].shape[0]
    small_input = sd["conv1.weight"].shape[-1] == 3
    model = ResNet(block, depths, num_classes=num_classes,
                   small_input=small_input, **model_kw)

    used = set()
    for name, p in model.named_parameters():
        if name not in sd:
            raise ValueError(f"checkpoint is missing parameter '{name}'")
        _put(p, _to_numpy(sd[name]))
        used.add(name)
    for name, b in model.named_buffers():
        if name not in sd:
            if name.endswith("num_batches_tracked"):
                continue    # old checkpoints lack the counter
            raise ValueError(f"checkpoint is missing buffer '{name}'")
        used.add(name)
        if name.endswith("num_batches_tracked"):
            b.fill_(int(sd[name]))
            continue
        v = _to_numpy(sd[name])
        if tuple(b.shape) != v.shape:
            raise ValueError(
                f"shape mismatch loading torch weights: buffer {name} "
                f"{tuple(b.shape)} vs checkpoint {v.shape}")
        _put(b, v)
    unexpected = sorted(set(sd) - used)
    if unexpected:
        raise ValueError(
            f"checkpoint carries keys this ResNet has no slot for: "
            f"{unexpected[:5]}{'...' if len(unexpected) > 5 else ''}")
    model.eval()
    return model


# the named variants share the generic loader, which reads the geometry
resnet50_from_torch = resnet_from_torch
resnet18_from_torch = resnet_from_torch
