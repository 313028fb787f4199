"""Llama-style decoder family, the PyTorch counterpart of
``apex_tpu/models/llama.py`` (dense, single device): RoPE, RMSNorm, SwiGLU
and grouped-query attention, no biases, an untied LM head.

``forward`` runs the blocks in the flash kernel's own (B, H, S, D) layout
and trains under autograd: attention through the flash-attention kernels
(forward and backward, with the Mistral band when ``sliding_window`` is
set), every RMSNorm through the RMSNorm kernels.  GQA repeats each K/V
head over its query group (``repeat_interleave``, the JAX package's
``jnp.repeat``: query head ``h`` reads K/V head ``h // group``).  The
cached paths (``prefill``, ``decode_chunk``, ``decode_step``) keep the
caches KVH wide; decode attention over the cache is plain PyTorch, as it
is plain XLA in the JAX package.  Parameter names are the JAX package's
(``blocks.{i}.ln1.weight``, ``blocks.{i}.q_proj.weight``, ...,
``norm.weight``, ``lm_head.weight``), so
:func:`apex_tpu_torch.models.convert.from_jax_state_dict` carries weights
across one to one.

With ``output_hidden=True``, ``forward`` returns ``(hidden (B, S, E),
lm_head.weight)`` so that a loss such as
:func:`apex_tpu_torch.kernels.lm_head_xent.fused_lm_head_xent` or
:func:`apex_tpu_torch.contrib.xentropy.chunked_lm_head_loss` applies the
head itself.

A cached path's position is a Python int or a 0-d int64 tensor on the
model's device (RoPE computed at the positions, the KV write by
``index_copy_``), so a captured decode step reads it where it lies.  With
``sliding_window`` the caches are rolling (``inference/rolling.py``:
``window + ROLLING_SLACK`` slots, slot = position mod the slot count): the
prompt goes through the flash kernel's band and its last rows into the
slots, and ``decode_chunk`` masks by the closed-form slot positions.

Owed to later slices, and refused with ``NotImplementedError``: tensor and
sequence parallelism (``tp_axis``, ``sp_axis``) and the mixture of experts
(``moe_axis``, ``moe_num_experts`` and its knobs), ROADMAP A9.  Each is
taken at its JAX default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._unported import PARALLEL, accept_defaults
from ..contrib.multihead_attn.attn_funcs import flash_attention
from ..inference.quant import (gather_rows, kv_value, kv_write,
                               make_kv_cache, positions, raw)
from ..inference.rolling import (ROLLING_SLACK, rolling_kv_write,
                                 rolling_slot_positions)
from ..kernels.dispatch import MASKED_FILL, resolve_device
from ..nn.modules import checkpoint_forward
from ..normalization import FusedRMSNorm


def rope_tables(positions, head_dim, theta=10000.0):
    """cos/sin tables for rotary embeddings, HF half-rotation convention:
    ``positions (...,)`` integers -> ``(cos, sin)`` of shape ``(...,
    head_dim)`` fp32, frequencies duplicated over both halves."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        half, dtype=torch.float32, device=positions.device)
        * (2.0 / head_dim)))
    ang = positions.to(torch.float32)[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate ``x (..., S, D)`` by tables ``(S, D)`` in fp32 and cast back;
    the second half holds the negated quadrature component (HF
    ``rotate_half``)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def _linear(x, w):
    """``x @ w.T`` with the (out, in) weight cast to x's dtype."""
    return torch.matmul(x, w.t().to(x.dtype))


class LlamaBlock(nn.Module):
    """Pre-norm decoder block: RMSNorm -> RoPE-GQA causal attention ->
    residual, RMSNorm -> SwiGLU FFN -> residual.  No biases."""

    def __init__(self, hidden, heads, kv_heads, intermediate,
                 rope_theta=10000.0, eps=1e-6, head_dim=None, tp_axis=None,
                 sp_axis=None, sliding_window=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        accept_defaults("LlamaBlock: tensor and sequence parallelism",
                        PARALLEL, tp_axis=(tp_axis, None),
                        sp_axis=(sp_axis, None))
        if head_dim is None:
            if hidden % heads:
                raise ValueError(f"hidden {hidden} not divisible by {heads} "
                                 f"— pass head_dim explicitly")
            head_dim = hidden // heads
        if heads % kv_heads:
            raise ValueError(
                f"heads {heads} not divisible by kv_heads {kv_heads} (GQA "
                f"shares each K/V head over an equal group)")
        self.heads = heads
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.sliding_window = sliding_window
        kw = dict(device=resolve_device(device), dtype=dtype)
        lin = lambda i, o: nn.Linear(i, o, bias=False, **kw)  # noqa: E731
        self.ln1 = FusedRMSNorm(hidden, eps=eps, **kw)
        self.q_proj = lin(hidden, heads * head_dim)
        self.k_proj = lin(hidden, kv_heads * head_dim)
        self.v_proj = lin(hidden, kv_heads * head_dim)
        self.o_proj = lin(heads * head_dim, hidden)
        self.ln2 = FusedRMSNorm(hidden, eps=eps, **kw)
        self.gate_proj = lin(hidden, intermediate)
        self.up_proj = lin(hidden, intermediate)
        self.down_proj = lin(intermediate, hidden)

    def _qkv(self, h):
        """(B, S, E) -> q (B, H, S, D), k/v (B, KVH, S, D)."""
        b, s, _ = h.shape
        d = self.head_dim

        def to_heads(y, nh):
            return y.reshape(b, s, nh, d).transpose(1, 2)
        return (to_heads(_linear(h, self.q_proj.weight), self.heads),
                to_heads(_linear(h, self.k_proj.weight), self.kv_heads),
                to_heads(_linear(h, self.v_proj.weight), self.kv_heads))

    def _attend(self, q, k, v):
        """Causal flash attention of q (B, H, S, D) over the chunk's own
        K/V (B, KVH, S, D), each K/V head repeated over its query group;
        -> (B, S, H * D)."""
        rep = q.shape[1] // k.shape[1]
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        o = flash_attention(q, k, v, causal=True,
                            sliding_window=self.sliding_window)
        b, h, s, d = o.shape
        return o.transpose(1, 2).reshape(b, s, h * d)

    def forward(self, x, cos, sin):
        """``x (B, S, E)``; ``cos``/``sin`` the (S, D) RoPE tables."""
        q, k, v = self._qkv(self.ln1(x))
        o = self._attend(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
        return self._mlp_tail(x, o)

    def _ffn(self, h):
        gated = F.silu(_linear(h, self.gate_proj.weight)) \
            * _linear(h, self.up_proj.weight)
        return _linear(gated, self.down_proj.weight)

    def _mlp_tail(self, x, o):
        """Attention output projection + residual, then the RMSNorm ->
        SwiGLU residual (one body for training and every cached path)."""
        x = x + _linear(o, self.o_proj.weight)
        return x + self._ffn(self.ln2(x))

    def _chunk_qkv(self, x, pos):
        """(B, S_c, E) -> rotated q (B, H, S_c, D), k (B, KVH, S_c, D) and v
        at absolute positions ``pos (S_c,)``."""
        q, k, v = self._qkv(self.ln1(x))
        cos, sin = rope_tables(pos, self.head_dim, self.rope_theta)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def prefill(self, x, kcache, vcache):
        """Cache-filling forward from position 0: causal flash attention
        (banded with ``sliding_window``) over the chunk ``x (B, S_c, E)``
        plus the KV writes (into a rolling cache, its last rows)."""
        s_c = x.shape[1]
        q, k_new, v_new = self._chunk_qkv(
            x, torch.arange(s_c, device=x.device))
        if self.sliding_window is not None:
            kcache = rolling_kv_write(kcache, k_new, 0)
            vcache = rolling_kv_write(vcache, v_new, 0)
        else:
            kcache = kv_write(kcache, k_new, (0, 0, 0, 0))
            vcache = kv_write(vcache, v_new, (0, 0, 0, 0))
        return self._mlp_tail(x, self._attend(q, k_new, v_new)), kcache, \
            vcache

    def decode_chunk(self, x, kcache, vcache, t0):
        """Cached forward over ``x (B, S_c, E)`` at positions ``t0 ..``:
        writes the chunk's K/V into the KVH-wide caches, and each query
        attends the cache up to its own position (within the band with
        ``sliding_window``, over the rolling cache's slot positions)."""
        b, s_c, _ = x.shape
        d = self.head_dim
        pos = positions(t0, s_c, x.device)
        q, k_new, v_new = self._chunk_qkv(x, pos)
        if self.sliding_window is None:
            kcache = kv_write(kcache, k_new, (0, 0, t0, 0))
            vcache = kv_write(vcache, v_new, (0, 0, t0, 0))
            keys, vals = kv_value(kcache), kv_value(vcache)
            slots = torch.arange(kcache.shape[2], device=x.device)
        elif s_c == 1:
            # write first, then attend the cache in place: the one position
            # the write evicts is a full window behind the query
            kcache = rolling_kv_write(kcache, k_new, t0)
            vcache = rolling_kv_write(vcache, v_new, t0)
            keys, vals = kv_value(kcache), kv_value(vcache)
            slots = rolling_slot_positions(kcache.shape[2], t0 + 1)
        else:
            # a chunk attends [the cache before its write | its own rows]:
            # writing first would evict band keys its early queries need
            keys = torch.cat([kv_value(kcache), k_new.float()], dim=2)
            vals = torch.cat([kv_value(vcache), v_new.float()], dim=2)
            slots = torch.cat([rolling_slot_positions(kcache.shape[2], t0),
                               pos])
            kcache = rolling_kv_write(kcache, k_new, t0)
            vcache = rolling_kv_write(vcache, v_new, t0)
        slots = slots.to(x.device)
        kvh = k_new.shape[1]
        qg = q.reshape(b, kvh, self.heads // kvh, s_c, d)
        scores = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                              keys) * (d ** -0.5)
        # cache slots beyond each position are unwritten (or stale)
        valid = slots[None, :] <= pos[:, None]
        if self.sliding_window is not None:
            # the band: key j is visible from t iff t - w < j <= t; negative
            # slot positions were never written
            valid = valid & (slots[None, :] > pos[:, None]
                             - self.sliding_window) & (slots[None, :] >= 0)
        scores = torch.where(valid, scores, MASKED_FILL)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bkgqs,bksd->bkgqd", probs, vals).to(x.dtype)
        o = o.reshape(b, self.heads, s_c, d).transpose(1, 2) \
            .reshape(b, s_c, self.heads * d)
        return self._mlp_tail(x, o), kcache, vcache

    def decode(self, x, kcache, vcache, t):
        """One-token decode, ``x (B, E)`` at position ``t``: the ``S_c = 1``
        case of :meth:`decode_chunk`."""
        y, kcache, vcache = self.decode_chunk(x[:, None, :], kcache, vcache,
                                              t)
        return y[:, 0], kcache, vcache


class LlamaModel(nn.Module):
    """Embeddings -> N Llama blocks -> final RMSNorm -> untied LM head.
    ``forward(input_ids (B, S)) -> logits (B, S, V)``.

    Runs on the CUDA card unless ``device="cpu"`` is passed, where the
    kernels' plain versions run.  Weights are drawn from PyTorch's global
    generator (``torch.manual_seed``): embedding and head N(0, 0.02), the
    projections ``torch.nn.Linear``'s default, the norms ones."""

    def __init__(self, vocab_size=32000, hidden=512, layers=8, heads=8,
                 kv_heads=None, intermediate=None, max_positions=2048,
                 rope_theta=10000.0, eps=1e-6, remat=False, head_dim=None,
                 tp_axis=None, sp_axis=None, moe_axis=None,
                 moe_num_experts=None, moe_every=2, moe_capacity_factor=1.25,
                 moe_top_k=1, moe_aux_weight=0.01, sliding_window=None,
                 output_hidden=False, device=None, dtype=torch.float32):
        super().__init__()
        accept_defaults("LlamaModel: tensor and sequence parallelism",
                        PARALLEL, tp_axis=(tp_axis, None),
                        sp_axis=(sp_axis, None))
        accept_defaults(
            "LlamaModel: the mixture of experts", PARALLEL,
            moe_axis=(moe_axis, None),
            moe_num_experts=(moe_num_experts, None),
            moe_every=(moe_every, 2),
            moe_capacity_factor=(moe_capacity_factor, 1.25),
            moe_top_k=(moe_top_k, 1), moe_aux_weight=(moe_aux_weight, 0.01))
        if sliding_window is not None and sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got "
                             f"{sliding_window}")
        device = resolve_device(device)
        self.output_hidden = output_hidden
        self.remat = remat
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.max_positions = max_positions
        self.rope_theta = rope_theta
        self.sliding_window = sliding_window
        kv_heads = kv_heads or heads
        # Llama's FFN width: 2/3 * 4E rounded up to a multiple of 256 (only
        # the default; checkpoints carry their own)
        if intermediate is None:
            intermediate = -(-(8 * hidden // 3) // 256) * 256
        kw = dict(device=device, dtype=dtype)
        self.tok_emb = nn.Embedding(vocab_size, hidden, **kw)
        nn.init.normal_(self.tok_emb.weight, std=0.02)
        self.blocks = nn.ModuleList([
            LlamaBlock(hidden, heads, kv_heads, intermediate,
                       rope_theta=rope_theta, eps=eps, head_dim=head_dim,
                       sliding_window=sliding_window, **kw)
            for _ in range(layers)])
        self.norm = FusedRMSNorm(hidden, eps=eps, **kw)
        self.lm_head = nn.Linear(hidden, vocab_size, bias=False, **kw)
        nn.init.normal_(self.lm_head.weight, std=0.02)

    def forward(self, input_ids):
        """``input_ids (B, S)`` -> logits ``(B, S, V)``, or ``(hidden (B, S,
        E), lm_head.weight)`` with ``output_hidden``."""
        s = input_ids.shape[1]
        if s > self.max_positions:
            raise ValueError(f"sequence length {s} exceeds max_positions "
                             f"{self.max_positions}")
        cos, sin = rope_tables(torch.arange(s, device=input_ids.device),
                               self.blocks[0].head_dim, self.rope_theta)
        x = self.tok_emb(input_ids)
        for blk in self.blocks:
            x = checkpoint_forward(blk, x, cos, sin) if self.remat \
                else blk(x, cos, sin)
        x = self.norm(x)
        if self.output_hidden:
            return x, self.lm_head.weight
        return _linear(x, self.lm_head.weight)

    def init_caches(self, batch, s_max, dtype=torch.float32):
        """Per-layer (k, v) caches of shape (B, KVH, S_max, D) on the
        model's device: KVH wide, the GQA cache saving.  With
        ``sliding_window`` a rolling cache of at most ``window +
        ROLLING_SLACK`` slots."""
        dev = self.norm.weight.device
        if self.sliding_window is not None:
            s_max = min(s_max, self.sliding_window + ROLLING_SLACK)
        return [(make_kv_cache((batch, blk.kv_heads, s_max, blk.head_dim),
                               dtype, dev),
                 make_kv_cache((batch, blk.kv_heads, s_max, blk.head_dim),
                               dtype, dev)) for blk in self.blocks]

    def _cache_capacity(self, caches):
        """The positions the caches can serve: a full-size rolling cache
        never bounds them (old slots fall out of the band), so its bound is
        ``max_positions``; a smaller one must not wrap and keeps its slot
        count, as a plain cache does."""
        n = caches[0][0].shape[2]
        if self.sliding_window is not None and n >= min(
                self.max_positions, self.sliding_window + ROLLING_SLACK):
            return self.max_positions
        return n

    def _check_positions(self, what, t0, s_c, caches):
        """Range-check a Python-int position; a device position (a 0-d
        tensor) is its caller's to bound."""
        if len(caches) != len(self.blocks):
            raise ValueError(f"{what}: {len(caches)} caches for "
                             f"{len(self.blocks)} blocks")
        if isinstance(t0, torch.Tensor):
            return t0
        t0 = int(t0)
        cap = self._cache_capacity(caches)
        if t0 < 0 or t0 + s_c > min(self.max_positions, cap):
            raise ValueError(
                f"{what}: positions {t0}..{t0 + s_c} out of range for "
                f"max_positions {self.max_positions} / cache capacity {cap}")
        return t0

    def _run_blocks(self, toks, caches, blk_fn):
        """Embed ``toks`` (int8-aware: only the selected rows dequantize),
        thread the caches through ``blk_fn`` per block, final norm and
        head."""
        x = gather_rows(raw(self.tok_emb), toks)
        new_caches = []
        for blk, (kc, vc) in zip(self.blocks, caches):
            x, kc, vc = blk_fn(blk, x, kc, vc)
            new_caches.append((kc, vc))
        return _linear(self.norm(x), self.lm_head.weight), new_caches

    def prefill(self, toks, caches):
        """Consume a prompt ``toks (B, S_p)`` from position 0 in one flash
        pass, filling the caches: ``(logits (B, S_p, V), caches)``."""
        self._check_positions("prefill", 0, toks.shape[1], caches)
        return self._run_blocks(
            toks, caches, lambda blk, x, kc, vc: blk.prefill(x, kc, vc))

    def decode_chunk(self, toks, caches, t0):
        """Logits for a token chunk ``toks (B, S_c)`` at positions ``t0 ..``
        (a Python int or a 0-d int64 device tensor) against the caches:
        ``(logits (B, S_c, V), caches)``."""
        t0 = self._check_positions("decode_chunk", t0, toks.shape[1], caches)
        return self._run_blocks(
            toks, caches,
            lambda blk, x, kc, vc: blk.decode_chunk(x, kc, vc, t0))

    def decode_step(self, tok, caches, t):
        """Logits for one token, ``tok (B,)`` at position ``t`` (a Python
        int or a 0-d int64 device tensor): ``(logits (B, V), caches)``."""
        t = self._check_positions("decode_step", t, 1, caches)
        return self._run_blocks(
            tok, caches, lambda blk, x, kc, vc: blk.decode(x, kc, vc, t))


def llama_tiny(**kw):
    """Test-scale geometry (for suites and examples)."""
    return LlamaModel(**{**dict(vocab_size=1000, hidden=128, layers=2,
                                heads=4, kv_heads=2, max_positions=128),
                         **kw})


def llama_1b(**kw):
    """~1.2B geometry (Llama-3.2-1B-like: 16 layers, hidden 2048, 32q/8kv
    heads, FFN 8192; the vocabulary comes from the caller)."""
    return LlamaModel(**{**dict(hidden=2048, layers=16, heads=32,
                                kv_heads=8, intermediate=8192,
                                rope_theta=500000.0, max_positions=8192),
                         **kw})


def llama_7b(**kw):
    """Llama-2-7B geometry: 32 layers, hidden 4096, 32 MHA heads, FFN
    11008, a 4096-token context window."""
    return LlamaModel(**{**dict(hidden=4096, layers=32, heads=32,
                                intermediate=11008, max_positions=4096),
                         **kw})
