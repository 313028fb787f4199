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
the KV cache is plain PyTorch, as it is plain XLA in the JAX package.  A
cached path's position is a Python int or a 0-d int64 tensor on the
model's device (the position embedding read by ``index_select``, the KV
write by ``index_copy_``), so a captured decode step reads it where it
lies; a Python int is range-checked here, a device position by its
caller.  Both give the same bits.
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
recomputed in the backward.

Tensor and sequence parallelism (``tp_axis``, ``sp_axis``, ``tp_vocab``)
run one process a rank over mesh axes that
:mod:`apex_tpu_torch.parallel.mesh` resolves.  ``tp_axis`` shards the
attention heads and the MLP's hidden features (Megatron's column -> row
pairs, :mod:`apex_tpu_torch.parallel.tensor_parallel`); the weights stay
whole on every rank and :meth:`GptModel.tp_sharded_params` lists those
whose gradients are block-sparse.  ``tp_vocab`` also shards the tied table
and returns vocab-sharded logits for
``parallel.vocab_parallel_cross_entropy``.  ``sp_axis`` shards the
sequence: ``input_ids`` are this rank's rows of the global sequence, the
positions are offset by the shard, attention runs the ring
(:mod:`apex_tpu_torch.parallel.ring_attention`).  Under ``sp_axis`` the
``generator`` must be in the same state on every rank of the axis (the
train step keeps it so): the ring's dropout seed is drawn from it, so the
ring's mask is the one-device run's, and each elementwise dropout mask is
drawn for the whole sequence and this rank keeps its own rows, so the
shards' masks differ (the JAX ``fold_shard_into_key``) while the
generator stays in step.  The cached decode paths and ``generate`` of a
model built with either axis refuse (``NotImplementedError`` naming
ROADMAP A9's decode under a mesh), as does the mixture of experts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._unported import DECODE_MESH, EXPERTS, accept_defaults, refuse
from ..contrib.multihead_attn import SelfMultiheadAttn
from ..contrib.multihead_attn.attn_funcs import flash_attention
from ..inference.decode import sample_probs
from ..inference.quant import (gather_rows, kv_value, kv_write,
                               make_kv_cache, positions, raw)
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


def shard_dropout(x, p, training, generator, sp_axis, dim):
    """:func:`dropout` of ``x``, this rank's shard along ``dim`` of a
    sequence sharded over ``sp_axis`` (None: the plain dropout): the mask
    is drawn for the whole sequence and this rank keeps its rows, so every
    shard draws other positions while ``generator`` advances alike on every
    rank of the axis."""
    if sp_axis is None or not training or p == 0.0:
        return dropout(x, p, training, generator)
    from ..parallel.mesh import resolve
    ax = resolve(sp_axis)
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] *= ax.size
    keep = 1.0 - p
    mask = (torch.rand(shape, generator=generator, device=x.device)
            < keep).narrow(dim, ax.index * n, n).contiguous()
    return torch.where(mask, x / keep, 0.0)


class GptBlock(nn.Module):
    """Pre-LN decoder block: LN -> causal MHA -> residual, LN -> GELU FFN ->
    residual."""

    def __init__(self, hidden, heads, intermediate, dropout=0.1,
                 attn_dropout=0.1, sp_axis=None, tp_axis=None,
                 attn_bias=False, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.ln1 = FusedLayerNorm(hidden, **kw)
        # attn_bias=True (what GPT-2 checkpoints carry) selects the 'default'
        # impl, the one that takes biases: the materializing attention path
        self.attn = SelfMultiheadAttn(hidden, heads, dropout=attn_dropout,
                                      bias=attn_bias,
                                      impl="default" if attn_bias else "fast",
                                      causal=True, seq_parallel_axis=sp_axis,
                                      tensor_parallel_axis=tp_axis, **kw)
        self.ln2 = FusedLayerNorm(hidden, **kw)
        self.fc1 = nn.Linear(hidden, intermediate, **kw)
        self.fc2 = nn.Linear(intermediate, hidden, **kw)
        self.dropout = nn.Dropout(dropout)
        self.tp_axis = tp_axis
        self.sp_axis = sp_axis

    def _ffn(self, h):
        if self.tp_axis is not None:
            # Megatron's MLP: fc1 column-parallel, GELU on the sharded
            # hidden, fc2 row-parallel, one all-reduce for the pair
            from ..parallel.tensor_parallel import tp_ffn
            return tp_ffn(h, self.fc1.weight, self.fc1.bias,
                          self.fc2.weight, self.fc2.bias, self.tp_axis,
                          activation=lambda y: F.gelu(y, approximate="tanh"))
        return self.fc2(F.gelu(self.fc1(h), approximate="tanh"))

    def forward(self, x, generator=None):
        """``x (S, B, E)`` (this rank's rows of S under ``sp_axis``);
        ``generator`` draws the dropout masks."""
        p = self.dropout.p
        h, _ = self.attn(self.ln1(x), generator=generator)
        x = x + shard_dropout(h, p, self.training, generator, self.sp_axis,
                              0)
        h = self._ffn(self.ln2(x))
        return x + shard_dropout(h, p, self.training, generator, self.sp_axis,
                                 0)

    def tp_sharded_params(self):
        """The parameters whose gradients are block-sparse on each rank
        under ``tp_axis`` (``make_train_step(tp_axis=...)`` sums them over
        the axis): the attention's, then the MLP's column and row
        entries."""
        return self.attn.tp_sharded_params() + [
            self.fc1.weight, self.fc1.bias, self.fc2.weight]

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
        pos = positions(t0, s_c, x.device)
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
        accept_defaults(
            "GptModel: the mixture of experts", EXPERTS,
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
        # the JAX package's construction checks of the parallel options
        if tp_vocab and self.padded_vocab != vocab_size:
            raise ValueError(
                "pad_vocab_multiple with tp_vocab is not supported: the "
                "vocab-parallel loss would see unmasked pad columns in "
                "the last shard")
        if tp_axis is not None and attn_dropout > 0.0 and attn_bias:
            raise ValueError(
                "tp_axis with attn_dropout > 0 requires the flash impl; "
                "attn_bias=True selects the materializing 'default' "
                "impl, which draws from one shared generator — set "
                "attn_dropout=0.0 or attn_bias=False")
        if tp_vocab and tp_axis is None:
            raise ValueError("tp_vocab requires tp_axis")
        if output_hidden and tp_vocab:
            raise ValueError(
                "output_hidden with tp_vocab is redundant: vocab-parallel "
                "logits already never materialize whole — use "
                "vocab_parallel_cross_entropy as the loss instead")
        self.tp_axis = tp_axis
        self.sp_axis = sp_axis
        self.tp_vocab = tp_vocab
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
                     sp_axis=sp_axis, tp_axis=tp_axis, attn_bias=attn_bias,
                     **kw) for _ in range(layers)])
        self.ln_f = FusedLayerNorm(hidden, **kw)

    def tp_sharded_params(self):
        """Every block's block-sparse-gradient parameters under ``tp_axis``
        (see :meth:`GptBlock.tp_sharded_params`), and the vocab-sharded
        table under ``tp_vocab``."""
        ps = [p for blk in self.blocks for p in blk.tp_sharded_params()]
        if self.tp_vocab:
            ps.append(self.tok_emb.weight)
        return ps

    def forward(self, input_ids, generator=None):
        """``input_ids (B, S)`` -> logits ``(B, S, V)``, or ``(hidden (B, S,
        E), tok_emb.weight)`` with ``output_hidden``; in training mode
        ``generator`` (on the model's device) draws every dropout mask.
        Under ``sp_axis`` S is this rank's shard of the global sequence;
        under ``tp_vocab`` the logits are this rank's vocab shard."""
        b, s = input_ids.shape
        off = 0
        if self.sp_axis is not None:
            from ..parallel.mesh import resolve
            ax = resolve(self.sp_axis)
            if s * ax.size > self.max_positions:
                raise ValueError(
                    f"global sequence length {s * ax.size} exceeds "
                    f"max_positions {self.max_positions}")
            off = ax.index * s
        elif s > self.max_positions:
            raise ValueError(f"sequence length {s} exceeds max_positions "
                             f"{self.max_positions}")
        pos = torch.arange(off, off + s, device=input_ids.device)
        if self.tp_vocab:
            from ..parallel.tensor_parallel import vocab_parallel_embedding
            tok = vocab_parallel_embedding(input_ids, self.tok_emb.weight,
                                           self.tp_axis)
        else:
            tok = self.tok_emb(input_ids)
        x = shard_dropout(tok + self.pos_emb(pos)[None], self.drop.p,
                          self.training, generator, self.sp_axis, 1)
        x = x.transpose(0, 1)                  # (S, B, E)
        for blk in self.blocks:
            x = checkpoint_forward(blk, x, generator) if self.remat \
                else blk(x, generator)
        x = self.ln_f(x).transpose(0, 1)       # (B, S, E)
        emb = self.tok_emb.weight
        if self.output_hidden:
            return x, emb
        if self.tp_vocab:
            from ..parallel.tensor_parallel import vocab_parallel_logits
            return vocab_parallel_logits(x, emb, self.tp_axis)
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
        device (QuantKV caches for ``"int8"``).  Every cached path starts
        here, so a model built with ``tp_axis`` or ``sp_axis`` refuses its
        decode here."""
        if self.tp_axis is not None or self.sp_axis is not None:
            refuse("cached decode of a model built with tp_axis / sp_axis",
                   DECODE_MESH)
        attn = self.blocks[0].attn
        shape = (batch, attn.num_heads, s_max, attn.head_dim)
        dev = self.pos_emb.weight.device
        return [(make_kv_cache(shape, dtype, dev),
                 make_kv_cache(shape, dtype, dev)) for _ in self.blocks]

    def _check_positions(self, what, t0, s_c, caches):
        """Range-check a Python-int position; a device position (a 0-d
        tensor) is its caller's to bound, as a traced one is in the JAX
        package."""
        if len(caches) != len(self.blocks):
            raise ValueError(f"{what}: {len(caches)} caches for "
                             f"{len(self.blocks)} blocks")
        if isinstance(t0, torch.Tensor):
            return t0
        t0 = int(t0)
        cap = caches[0][0].shape[2]
        if t0 < 0 or t0 + s_c > min(self.max_positions, cap):
            raise ValueError(
                f"{what}: positions {t0}..{t0 + s_c} out of range for "
                f"max_positions {self.max_positions} / cache capacity {cap}")
        return t0

    def _run_blocks(self, toks, caches, pos_of, blk_fn):
        """Embed ``toks`` plus positions (``pos_of(pos_table)``), thread the
        caches through ``blk_fn`` per block, final LN and tied head.  The
        token gather is int8-aware (only the selected rows dequantize); the
        tied head reads the whole (dequantized) table."""
        x = gather_rows(raw(self.tok_emb), toks) \
            + pos_of(self.pos_emb.weight)
        emb = self.tok_emb.weight
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
        ``t0 ..`` (a Python int or a 0-d int64 device tensor) against the
        caches."""
        s_c = toks.shape[1]
        t0 = self._check_positions("decode_chunk", t0, s_c, caches)
        pos = positions(t0, s_c, toks.device)
        return self._run_blocks(
            toks, caches, lambda table: table.index_select(0, pos)[None],
            lambda blk, x, kc, vc: blk.decode_chunk(x, kc, vc, t0))

    def decode_step(self, tok, caches, t):
        """Logits for one token, ``tok (B,)`` at position ``t`` (a Python
        int or a 0-d int64 device tensor): ``(logits (B, V), caches)``."""
        t = self._check_positions("decode_step", t, 1, caches)
        pos = positions(t, 1, tok.device)
        return self._run_blocks(
            tok, caches, lambda table: table.index_select(0, pos),
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
    then top-p, then a draw from ``generator`` (on the logits' device),
    with no host sync, so a CUDA graph captures it
    (:func:`apex_tpu_torch.inference.decode.sample_probs`)."""
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
        return sample_probs(probs, generator)

    return sample


def generate(model, prompt_ids, max_new_tokens, temperature=0.0,
             top_k=None, generator=None, cache_dtype=None, mesh=None,
             top_p=None):
    """Autoregressive decoding with a KV cache: ``prompt_ids (B, P)`` ->
    ``(B, P + max_new_tokens)`` token ids on the model's device.  Drives
    any model with the decode protocol (``init_caches``, ``prefill``,
    ``decode_step``, ``max_positions``, ``tok_emb``): the GPT and Llama
    families.

    With ``P > 1`` the prompt goes through ONE eager ``prefill``, whose
    last logits give the first new token; otherwise decoding starts at
    position 0.  The decode steps then run through the bucket's cached
    program (:mod:`apex_tpu_torch.inference.decode`): on the card its
    first step runs eagerly, its second is captured as a CUDA graph, and
    every later step replays it, the position and the token on the
    device.  ``temperature=0`` is greedy; sampling needs a
    ``torch.Generator`` on the model's device, and draws what an eager
    loop on it would.  ``cache_dtype`` defaults to the token embedding's
    dtype; ``"int8"`` is the quantized KV cache.  ``mesh`` is taken at its
    default and refused otherwise."""
    from ..inference.decode import compute_dtype, decode_graph, model_device
    accept_defaults("generate: sharded decode (mesh)", DECODE_MESH,
                    mesh=(mesh, None))
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
    vocab = getattr(model, "vocab_size", None) or raw(model.tok_emb).shape[0]
    sample = make_sampler(temperature, top_k, top_p, vocab)
    if cache_dtype is None:
        cache_dtype = compute_dtype(model)
    prompt = prompt_ids.to(device=model_device(model), dtype=torch.long)
    if max_new_tokens < 1:
        return prompt.clone()
    graph = decode_graph(model, b, s_total, cache_dtype, temperature, top_k,
                         top_p, sample)
    return graph.generate(prompt, max_new_tokens, generator)


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
