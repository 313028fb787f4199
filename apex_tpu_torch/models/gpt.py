"""GPT-style causal decoder, the PyTorch counterpart of
``apex_tpu/models/gpt.py`` (dense, single device).

Pre-LN blocks (LayerNorm -> causal multi-head attention -> residual,
LayerNorm -> tanh-GELU FFN -> residual), learned position embeddings and a
weight-tied LM head.  ``forward`` runs the blocks in (S, B, E), the
attention module's layout, and trains under autograd: attention through
the flash-attention kernels (forward and backward), every LayerNorm through
the LayerNorm kernels.  In training mode the residual and embedding
dropout draw their masks from the ``generator`` passed to ``forward``
(``torch.rand(...) < keep``, scaled by ``1 / keep``), so a train step can
seed them from its own state.  The cached paths (``prefill``,
``decode_chunk``, ``decode_step``) run in (B, S, E); decode attention over
the KV cache is plain PyTorch, as it is plain XLA in the JAX package.
Parameter names are the JAX package's, so
:func:`apex_tpu_torch.models.convert.from_jax_state_dict` carries weights
across one to one.

With ``output_hidden=True``, ``forward`` returns ``(hidden (B, S, E),
tok_emb.weight)`` instead of the logits, so that a loss such as
:func:`apex_tpu_torch.contrib.xentropy.chunked_lm_head_loss` applies the
tied head itself and the ``(B, S, V)`` logits never exist whole; the cached
paths apply the head themselves and are unaffected.

Attention dropout (``attn_dropout``, 0.1 by default) runs inside the flash
kernels, seeded from the same ``generator``.  ``remat`` runs each block
through :func:`apex_tpu_torch.nn.checkpoint_forward`, its activations
recomputed in the backward.  The JAX package's mixture-of-experts, tensor-
and sequence-parallel arguments are taken at their defaults and refused
otherwise (``NotImplementedError`` naming the ROADMAP item that owns
them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._unported import PARALLEL, accept_defaults
from ..contrib.multihead_attn import SelfMultiheadAttn
from ..contrib.multihead_attn.attn_funcs import flash_attention
from ..inference.quant import kv_value, kv_write, make_kv_cache
from ..kernels.dispatch import MASKED_FILL, resolve_device
from ..nn.modules import checkpoint_forward
from ..normalization import FusedLayerNorm


def dropout(x, p, training, generator=None):
    """Inverted dropout with its mask drawn from ``generator`` (the global
    generator when None): kept entries scaled by ``1 / (1 - p)``."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class GptBlock(nn.Module):
    """Pre-LN decoder block: LN -> causal MHA -> residual, LN -> GELU FFN ->
    residual."""

    def __init__(self, hidden, heads, intermediate, dropout=0.1,
                 attn_dropout=0.1, sp_axis=None, tp_axis=None,
                 attn_bias=False, device=None, dtype=torch.float32):
        super().__init__()
        accept_defaults("GptBlock: tensor and sequence parallelism",
                        PARALLEL, sp_axis=(sp_axis, None),
                        tp_axis=(tp_axis, None))
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.ln1 = FusedLayerNorm(hidden, **kw)
        # attn_bias=True (what GPT-2 checkpoints carry) selects the 'default'
        # impl, the one that takes biases: the materializing attention path
        self.attn = SelfMultiheadAttn(hidden, heads, dropout=attn_dropout,
                                      bias=attn_bias,
                                      impl="default" if attn_bias else "fast",
                                      causal=True, **kw)
        self.ln2 = FusedLayerNorm(hidden, **kw)
        self.fc1 = nn.Linear(hidden, intermediate, **kw)
        self.fc2 = nn.Linear(intermediate, hidden, **kw)
        self.dropout = nn.Dropout(dropout)

    def _ffn(self, h):
        return self.fc2(F.gelu(self.fc1(h), approximate="tanh"))

    def forward(self, x, generator=None):
        """``x (S, B, E)``; ``generator`` draws the dropout masks."""
        p = self.dropout.p
        h, _ = self.attn(self.ln1(x), generator=generator)
        x = x + dropout(h, p, self.training, generator)
        h = self._ffn(self.ln2(x))
        return x + dropout(h, p, self.training, generator)

    def _chunk_qkv(self, x):
        """(B, S_c, E) -> q, k, v (B, H, S_c, D) through the interleaved
        QKV projection of the training path."""
        attn = self.attn
        b, s_c, _ = x.shape
        h = self.ln1(x)
        qkv = torch.matmul(h, attn.in_proj_weight.t().to(h.dtype))
        if attn.bias:
            qkv = qkv + attn.in_proj_bias.to(qkv.dtype)
        qkv = qkv.reshape(b, s_c, attn.num_heads, 3, attn.head_dim)
        return tuple(qkv[:, :, :, i].transpose(1, 2) for i in range(3))

    def _attn_mlp_tail(self, x, o):
        """Out projection + residual, then the LN2 -> FFN residual."""
        attn = self.attn
        o = torch.matmul(o, attn.out_proj_weight.t().to(o.dtype))
        if attn.bias:
            o = o + attn.out_proj_bias.to(o.dtype)
        x = x + o
        return x + self._ffn(self.ln2(x))

    def prefill(self, x, kcache, vcache):
        """Cache-filling forward from position 0: causal flash attention
        over the chunk ``x (B, S_c, E)`` plus the KV writes."""
        b, s_c, _ = x.shape
        q, k_new, v_new = self._chunk_qkv(x)
        kcache = kv_write(kcache, k_new, (0, 0, 0, 0))
        vcache = kv_write(vcache, v_new, (0, 0, 0, 0))
        o = flash_attention(q, k_new, v_new, causal=True,
                            scale=self.attn.scaling)
        o = o.transpose(1, 2).reshape(b, s_c, q.shape[1] * q.shape[3])
        return self._attn_mlp_tail(x, o), kcache, vcache

    def decode_chunk(self, x, kcache, vcache, t0):
        """Cached forward over ``x (B, S_c, E)`` at positions ``t0 ..``:
        each query attends the cache up to its own position."""
        attn = self.attn
        b, s_c, _ = x.shape
        pos = t0 + torch.arange(s_c, device=x.device)
        q, k_new, v_new = self._chunk_qkv(x)
        kcache = kv_write(kcache, k_new, (0, 0, t0, 0))
        vcache = kv_write(vcache, v_new, (0, 0, t0, 0))
        slots = torch.arange(kcache.shape[2], device=x.device)
        scores = torch.einsum("bhqd,bhsd->bhqs", q.float(),
                              kv_value(kcache)) * attn.scaling
        # cache slots beyond each position are unwritten (or stale)
        valid = slots[None, :] <= pos[:, None]
        scores = torch.where(valid[None, None], scores, MASKED_FILL)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqs,bhsd->bhqd", probs,
                         kv_value(vcache)).to(x.dtype)
        o = o.transpose(1, 2).reshape(b, s_c, q.shape[1] * q.shape[3])
        return self._attn_mlp_tail(x, o), kcache, vcache

    def decode(self, x, kcache, vcache, t):
        """One-token decode, ``x (B, E)`` at position ``t``: the ``S_c = 1``
        case of :meth:`decode_chunk`."""
        y, kcache, vcache = self.decode_chunk(x[:, None, :], kcache, vcache,
                                              t)
        return y[:, 0], kcache, vcache


class GptModel(nn.Module):
    """Token + position embeddings -> N pre-LN causal blocks -> final LN ->
    weight-tied LM head.  ``forward(input_ids (B, S)) -> logits (B, S, V)``.

    Runs on the CUDA card unless ``device="cpu"`` is passed, where the
    kernels' plain versions run.  Weights are drawn from PyTorch's global
    generator (``torch.manual_seed``), with the JAX package's
    distributions."""

    def __init__(self, vocab_size=50257, hidden=768, layers=12, heads=12,
                 intermediate=None, max_positions=1024, dropout=0.1,
                 attn_dropout=0.1, remat=False, sp_axis=None, tp_axis=None,
                 tp_vocab=False, moe_axis=None, moe_num_experts=None,
                 moe_every=2, moe_capacity_factor=1.25, moe_top_k=1,
                 moe_aux_weight=0.01, attn_bias=False,
                 pad_vocab_multiple=None, output_hidden=False, device=None,
                 dtype=torch.float32):
        super().__init__()
        accept_defaults("GptModel: tensor and sequence parallelism",
                        PARALLEL, sp_axis=(sp_axis, None),
                        tp_axis=(tp_axis, None), tp_vocab=(tp_vocab, False))
        accept_defaults(
            "GptModel: the mixture of experts", PARALLEL,
            moe_axis=(moe_axis, None),
            moe_num_experts=(moe_num_experts, None),
            moe_every=(moe_every, 2),
            moe_capacity_factor=(moe_capacity_factor, 1.25),
            moe_top_k=(moe_top_k, 1), moe_aux_weight=(moe_aux_weight, 0.01))
        device = resolve_device(device)
        self.output_hidden = output_hidden
        self.remat = remat
        intermediate = intermediate or 4 * hidden
        # pad_vocab_multiple rounds the table up to a multiple; the pad
        # columns of the logits are masked to -1e30
        self.vocab_size = vocab_size
        self.padded_vocab = vocab_size
        if pad_vocab_multiple:
            self.padded_vocab = -(-vocab_size // pad_vocab_multiple) \
                * pad_vocab_multiple
        self.hidden = hidden
        self.max_positions = max_positions
        kw = dict(device=device, dtype=dtype)
        self.tok_emb = nn.Embedding(self.padded_vocab, hidden, **kw)
        self.pos_emb = nn.Embedding(max_positions, hidden, **kw)
        for emb in (self.tok_emb, self.pos_emb):
            nn.init.normal_(emb.weight, std=0.02)   # GPT initializer_range
        self.drop = nn.Dropout(dropout)
        self.blocks = nn.ModuleList([
            GptBlock(hidden, heads, intermediate, dropout, attn_dropout,
                     attn_bias=attn_bias, **kw) for _ in range(layers)])
        self.ln_f = FusedLayerNorm(hidden, **kw)

    def forward(self, input_ids, generator=None):
        """``input_ids (B, S)`` -> logits ``(B, S, V)``, or ``(hidden (B, S,
        E), tok_emb.weight)`` with ``output_hidden``; in training mode
        ``generator`` (on the model's device) draws every dropout mask."""
        b, s = input_ids.shape
        if s > self.max_positions:
            raise ValueError(f"sequence length {s} exceeds max_positions "
                             f"{self.max_positions}")
        pos = torch.arange(s, device=input_ids.device)
        x = dropout(self.tok_emb(input_ids) + self.pos_emb(pos)[None],
                    self.drop.p, self.training, generator)
        x = x.transpose(0, 1)                  # (S, B, E)
        for blk in self.blocks:
            x = checkpoint_forward(blk, x, generator) if self.remat \
                else blk(x, generator)
        x = self.ln_f(x).transpose(0, 1)       # (B, S, E)
        emb = self.tok_emb.weight
        if self.output_hidden:
            return x, emb
        return self._mask_pad_logits(torch.matmul(x, emb.t().to(x.dtype)))

    def _mask_pad_logits(self, logits):
        """-1e30 on the vocab-pad columns, so softmax, argmax and
        cross-entropy over the padded width equal the logical-vocab ones."""
        if self.padded_vocab == self.vocab_size:
            return logits
        cols = torch.arange(logits.shape[-1], device=logits.device)
        fill = torch.full((), MASKED_FILL, dtype=logits.dtype,
                          device=logits.device)
        return torch.where(cols < self.vocab_size, logits, fill)

    def init_caches(self, batch, s_max, dtype=torch.float32):
        """Per-layer (k, v) caches of shape (B, H, S_max, D) on the model's
        device."""
        attn = self.blocks[0].attn
        shape = (batch, attn.num_heads, s_max, attn.head_dim)
        dev = self.tok_emb.weight.device
        return [(make_kv_cache(shape, dtype, dev),
                 make_kv_cache(shape, dtype, dev)) for _ in self.blocks]

    def _check_positions(self, what, t0, s_c, caches):
        if len(caches) != len(self.blocks):
            raise ValueError(f"{what}: {len(caches)} caches for "
                             f"{len(self.blocks)} blocks")
        cap = caches[0][0].shape[2]
        if t0 < 0 or t0 + s_c > min(self.max_positions, cap):
            raise ValueError(
                f"{what}: positions {t0}..{t0 + s_c} out of range for "
                f"max_positions {self.max_positions} / cache capacity {cap}")

    def _run_blocks(self, toks, caches, pos_of, blk_fn):
        """Embed ``toks`` plus positions (``pos_of(pos_table)``), thread the
        caches through ``blk_fn`` per block, final LN and tied head."""
        emb = self.tok_emb.weight
        x = emb[toks] + pos_of(self.pos_emb.weight)
        new_caches = []
        for blk, (kc, vc) in zip(self.blocks, caches):
            x, kc, vc = blk_fn(blk, x, kc, vc)
            new_caches.append((kc, vc))
        x = self.ln_f(x)
        return self._mask_pad_logits(
            torch.matmul(x, emb.t().to(x.dtype))), new_caches

    def prefill(self, toks, caches):
        """Consume a prompt ``toks (B, S_p)`` from position 0 in one flash
        pass, filling the caches: ``(logits (B, S_p, V), caches)``."""
        s_p = toks.shape[1]
        self._check_positions("prefill", 0, s_p, caches)
        return self._run_blocks(
            toks, caches, lambda pos: pos[:s_p][None],
            lambda blk, x, kc, vc: blk.prefill(x, kc, vc))

    def decode_chunk(self, toks, caches, t0):
        """Logits for a token chunk ``toks (B, S_c)`` at positions
        ``t0 ..`` against the caches."""
        t0 = int(t0)
        s_c = toks.shape[1]
        self._check_positions("decode_chunk", t0, s_c, caches)
        return self._run_blocks(
            toks, caches, lambda pos: pos[t0:t0 + s_c][None],
            lambda blk, x, kc, vc: blk.decode_chunk(x, kc, vc, t0))

    def decode_step(self, tok, caches, t):
        """Logits for one token, ``tok (B,)`` at position ``t``:
        ``(logits (B, V), caches)``."""
        t = int(t)
        self._check_positions("decode_step", t, 1, caches)
        return self._run_blocks(
            tok, caches, lambda pos: pos[t],
            lambda blk, x, kc, vc: blk.decode(x, kc, vc, t))


def nucleus_filter(logits, top_p):
    """Top-p filter: keep the smallest prefix of the probability-sorted
    vocab whose cumulative probability reaches ``top_p`` (the first token
    always survives), set the rest to -1e30.  ``logits (..., V)``."""
    if top_p >= 1.0:
        return logits
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt.float(), dim=-1)
    # token i is outside the nucleus iff the mass before it reached top_p
    before = torch.cumsum(probs, dim=-1) - probs
    kept = before < top_p
    thresh = torch.where(kept, srt, torch.inf).min(
        dim=-1, keepdim=True).values.to(logits.dtype)
    return torch.where(logits < thresh, MASKED_FILL, logits)


def make_sampler(temperature, top_k, top_p, vocab):
    """Validate the sampling knobs and return ``sample(logits,
    generator)``: greedy at temperature 0, else temperature, then top-k,
    then top-p, then a draw from ``generator`` (on the logits' device)."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and not 1 <= top_k <= vocab:
        raise ValueError(f"top_k must be in [1, vocab={vocab}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")

    def sample(logits, generator=None):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, MASKED_FILL, logits)
        if top_p is not None:
            logits = nucleus_filter(logits, top_p)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[..., 0]

    return sample


def generate(model, prompt_ids, max_new_tokens, temperature=0.0,
             top_k=None, generator=None, cache_dtype=None, top_p=None):
    """Autoregressive decoding with a KV cache: ``prompt_ids (B, P)`` ->
    ``(B, P + max_new_tokens)`` token ids on the model's device.  Drives
    any model with the decode protocol (``init_caches``, ``prefill``,
    ``decode_step``, ``max_positions``, ``tok_emb``): the GPT and Llama
    families.

    With ``P > 1`` and at least one new token, the prompt goes through ONE
    ``prefill`` pass, whose last logits give the first new token, and
    ``decode_step`` runs at positions ``P .. P + max_new_tokens - 2``.
    Otherwise every position runs through ``decode_step``, teacher-forced
    inside the prompt.  ``temperature=0`` is greedy; sampling needs a
    ``torch.Generator`` on the model's device.  ``cache_dtype`` defaults to
    the token embedding's dtype."""
    b, p = prompt_ids.shape
    if p < 1:
        raise ValueError("generate needs a prompt of at least one token")
    s_total = p + max_new_tokens
    if s_total > model.max_positions:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_positions {model.max_positions}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    vocab = getattr(model, "vocab_size", None) \
        or model.tok_emb.weight.shape[0]
    sample = make_sampler(temperature, top_k, top_p, vocab)
    if cache_dtype is None:
        cache_dtype = model.tok_emb.weight.dtype
    prompt = prompt_ids.to(device=model.tok_emb.weight.device,
                           dtype=torch.long)
    with torch.inference_mode():
        caches = model.init_caches(b, s_total, dtype=cache_dtype)
        if p > 1 and max_new_tokens >= 1:
            logits, caches = model.prefill(prompt, caches)
            tok = sample(logits[:, -1], generator)
            new = [tok]
            for t in range(p, s_total - 1):
                logits, caches = model.decode_step(tok, caches, t)
                tok = sample(logits, generator)
                new.append(tok)
            return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)
        tok = prompt[:, 0]
        seq = [tok]
        for t in range(s_total - 1):
            logits, caches = model.decode_step(tok, caches, t)
            tok = prompt[:, t + 1] if t + 1 < p else sample(logits, generator)
            seq.append(tok)
        return torch.stack(seq, dim=1)


def gpt2_small(**kw):
    """GPT-2 small geometry: 12 layers, hidden 768, 12 heads (124M)."""
    return GptModel(**{**dict(hidden=768, layers=12, heads=12), **kw})


def gpt2_medium(**kw):
    """GPT-2 medium geometry: 24 layers, hidden 1024, 16 heads (350M)."""
    return GptModel(**{**dict(hidden=1024, layers=24, heads=16), **kw})


def gpt2_large(**kw):
    """GPT-2 large geometry: 36 layers, hidden 1280, 20 heads (774M)."""
    return GptModel(**{**dict(hidden=1280, layers=36, heads=20), **kw})


def gpt2_xl(**kw):
    """GPT-2 XL geometry: 48 layers, hidden 1600, 25 heads (1.5B)."""
    return GptModel(**{**dict(hidden=1600, layers=48, heads=25), **kw})
