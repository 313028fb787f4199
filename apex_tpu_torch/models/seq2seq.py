"""Transformer encoder-decoder (seq2seq), the PyTorch counterpart of
``apex_tpu/models/seq2seq.py``: the model-level consumer of
``EncdecMultiheadAttn``.

The encoder is :class:`~apex_tpu_torch.models.bert.BertLayer` (post-LN, so
its last layer's output is already normalized); the decoder is pre-LN:
causal self-attention, cross-attention over the encoder memory with the
source's key-padding mask, a tanh-GELU FFN, and a final LayerNorm before
the head tied to the token embedding.  Every attention runs the flash
kernels (dropout inside them) and every LayerNorm the LayerNorm kernels.
The public API is batch-first ``(B, S)`` ids; the layers run ``(S, B,
E)``.  In training mode every dropout mask is drawn from the ``generator``
passed to ``forward``.  Parameter names are the JAX package's, so
:func:`apex_tpu_torch.models.convert.from_jax_state_dict` carries weights
across one to one; ``tp_axis`` and ``mesh`` are taken at their defaults
and refused otherwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._unported import PARALLEL, accept_defaults
from ..contrib.multihead_attn import EncdecMultiheadAttn, SelfMultiheadAttn
from ..kernels.dispatch import resolve_device
from ..normalization import FusedLayerNorm
from .bert import BertLayer
from .gpt import dropout, make_sampler


class Seq2SeqDecoderLayer(nn.Module):
    """LN -> causal self-MHA -> residual, LN -> cross-MHA(memory) ->
    residual, LN -> GELU FFN -> residual."""

    def __init__(self, hidden, heads, intermediate, dropout=0.1,
                 attn_dropout=0.1, tp_axis=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        accept_defaults("Seq2SeqDecoderLayer: tensor parallelism", PARALLEL,
                        tp_axis=(tp_axis, None))
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.ln1 = FusedLayerNorm(hidden, **kw)
        self.self_attn = SelfMultiheadAttn(hidden, heads, dropout=attn_dropout,
                                           impl="fast", causal=True, **kw)
        self.ln2 = FusedLayerNorm(hidden, **kw)
        self.cross_attn = EncdecMultiheadAttn(hidden, heads,
                                              dropout=attn_dropout,
                                              impl="fast", **kw)
        self.ln3 = FusedLayerNorm(hidden, **kw)
        self.fc1 = nn.Linear(hidden, intermediate, **kw)
        self.fc2 = nn.Linear(intermediate, hidden, **kw)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, memory, memory_kpm=None, generator=None):
        """``x (S_tgt, B, E)`` over ``memory (S_src, B, E)``;
        ``memory_kpm (B, S_src)`` True where a source position is
        padding."""
        p = self.dropout.p
        h, _ = self.self_attn(self.ln1(x), generator=generator)
        x = x + dropout(h, p, self.training, generator)
        h, _ = self.cross_attn(self.ln2(x), memory,
                               key_padding_mask=memory_kpm,
                               generator=generator)
        x = x + dropout(h, p, self.training, generator)
        h = self.fc2(F.gelu(self.fc1(self.ln3(x)), approximate="tanh"))
        return x + dropout(h, p, self.training, generator)


class TransformerSeq2Seq(nn.Module):
    """Shared-vocabulary encoder-decoder with a weight-tied output head.

    ``forward(src_ids (B, S_src), tgt_ids (B, S_tgt),
    src_attention_mask=None) -> logits (B, S_tgt, V)``, or ``(hidden (B,
    S_tgt, E), tok_emb.weight)`` with ``output_hidden``.  The three ids may
    also arrive packed as ``forward((src_ids, tgt_ids[, mask]))``, the
    fused train step's single model input.  ``src_attention_mask`` follows
    the BERT convention (1 = real token, 0 = padding) and masks the
    encoder's self-attention and the decoder's cross-attention.  Runs on
    the CUDA card unless ``device="cpu"`` is passed; the embeddings are
    N(0, 0.02), as in the JAX package."""

    def __init__(self, vocab_size=32000, hidden=512, enc_layers=6,
                 dec_layers=6, heads=8, intermediate=None,
                 max_positions=512, dropout=0.1, attn_dropout=0.1,
                 tp_axis=None, output_hidden=False, device=None,
                 dtype=torch.float32):
        super().__init__()
        accept_defaults("TransformerSeq2Seq: tensor parallelism", PARALLEL,
                        tp_axis=(tp_axis, None))
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.output_hidden = output_hidden
        intermediate = intermediate or 4 * hidden
        self.hidden = hidden
        self.max_positions = max_positions
        self.tok_emb = nn.Embedding(vocab_size, hidden, **kw)
        self.pos_emb = nn.Embedding(max_positions, hidden, **kw)
        for emb in (self.tok_emb, self.pos_emb):
            nn.init.normal_(emb.weight, std=0.02)
        self.drop = nn.Dropout(dropout)
        self.enc_layers = nn.ModuleList([
            BertLayer(hidden, heads, intermediate, dropout, attn_dropout,
                      **kw) for _ in range(enc_layers)])
        self.dec_layers = nn.ModuleList([
            Seq2SeqDecoderLayer(hidden, heads, intermediate, dropout,
                                attn_dropout, **kw)
            for _ in range(dec_layers)])
        self.dec_ln = FusedLayerNorm(hidden, **kw)

    def _embed(self, ids, generator=None):
        s = ids.shape[1]
        if s > self.max_positions:
            raise ValueError(f"sequence length {s} exceeds max_positions "
                             f"{self.max_positions}")
        pos = torch.arange(s, device=ids.device)[None, :]
        x = self.tok_emb(ids) + self.pos_emb(pos)
        x = dropout(x, self.drop.p, self.training, generator)
        return x.transpose(0, 1)                # (S, B, E)

    def _encode(self, src_ids, kpm, generator=None):
        mem = self._embed(src_ids, generator)
        for layer in self.enc_layers:
            mem = layer(mem, key_padding_mask=kpm, generator=generator)
        return mem

    def _decode(self, tgt_ids, mem, kpm, generator=None):
        """The decoder's normalized hidden states, (B, S_tgt, E)."""
        x = self._embed(tgt_ids, generator)
        for layer in self.dec_layers:
            x = layer(x, mem, memory_kpm=kpm, generator=generator)
        return self.dec_ln(x).transpose(0, 1)

    def forward(self, src_ids, tgt_ids=None, src_attention_mask=None,
                generator=None):
        if tgt_ids is None:
            if not isinstance(src_ids, (tuple, list)) or \
                    len(src_ids) not in (2, 3):
                raise TypeError(
                    "seq2seq forward needs (src_ids, tgt_ids[, mask]) — "
                    "either as positional args or packed in one tuple")
            src_ids, tgt_ids, *rest = src_ids
            if rest:
                src_attention_mask = rest[0]
        kpm = None if src_attention_mask is None \
            else src_attention_mask == 0
        x = self._decode(tgt_ids, self._encode(src_ids, kpm, generator), kpm,
                         generator)
        emb = self.tok_emb.weight
        if self.output_hidden:
            return x, emb
        return torch.matmul(x, emb.t().to(x.dtype))


def transformer_seq2seq(**kw):
    """Base geometry: 6 + 6 layers, hidden 512, 8 heads (transformer-base
    shape)."""
    return TransformerSeq2Seq(**{**dict(hidden=512, enc_layers=6,
                                        dec_layers=6, heads=8), **kw})


class Seq2SeqGraph:
    """One bucket of ``seq2seq_generate``: the step over the whole padded
    target buffer as a :class:`~apex_tpu_torch.inference.decode.GraphRun`
    over ``(buf (B, N + 1), t (), mem (S, B, E), logits (B, V)[, kpm (B,
    S)])``: the decoder over ``buf``, the head at ``t``, the sample
    written at ``t + 1``, ``t`` incremented, all on the device."""

    def __init__(self, model, b, s_src, n, masked, sample, sampled):
        from ..inference.decode import GraphRun, model_device
        dev = model_device(model)
        emb = model.tok_emb.weight
        self.model = model
        self.sample = sample
        self.buf = torch.zeros((b, n + 1), dtype=torch.long, device=dev)
        self.t = torch.zeros((), dtype=torch.long, device=dev)
        self.mem = torch.zeros((s_src, b, emb.shape[1]), dtype=emb.dtype,
                               device=dev)
        self.kpm = torch.zeros((b, s_src), dtype=torch.bool, device=dev) \
            if masked else None
        self.logits = torch.zeros((b, emb.shape[0]), dtype=emb.dtype,
                                  device=dev)
        state = (self.buf, self.t, self.mem, self.logits) + \
            ((self.kpm,) if masked else ())
        self.run = GraphRun("seq2seq_decode", self._step, state, dev,
                            sampled)

    def _step(self, state, generator):
        buf, t, mem, logits_buf = state[:4]
        kpm = state[4] if len(state) > 4 else None
        model = self.model
        x = model._decode(buf, mem, kpm).index_select(1, t.reshape(1))[:, 0]
        emb = model.tok_emb.weight
        logits = torch.matmul(x, emb.t().to(x.dtype))
        tok = self.sample(logits, generator)
        buf.index_copy_(1, t.reshape(1) + 1, tok[:, None])
        logits_buf.copy_(logits)
        t.add_(1)

    def generate(self, src, kpm, n, bos_id, generator, eager=False,
                 logits=None):
        """Encode, then ``n`` steps (with ``eager`` the un-captured step;
        each step's logits appended to the list ``logits`` when one is
        given); returns ``(B, n)``."""
        with torch.no_grad():
            self.mem.copy_(self.model._encode(src, kpm))
            if kpm is not None:
                self.kpm.copy_(kpm)
            self.buf.fill_(bos_id)
            self.t.zero_()
        run = self.run
        run.start(generator)
        for _ in range(n):
            run.step(eager)
            if logits is not None:
                logits.append(self.logits.clone())
        run.finish(eager)
        return self.buf[:, 1:].clone()


def seq2seq_generate(model, src_ids, max_new_tokens, bos_id=0,
                     src_attention_mask=None, temperature=0.0, top_k=None,
                     generator=None, mesh=None):
    """Decoding: encode ``src_ids (B, S_src)`` once, eagerly, then extend
    the target one token a step -> ``(B, max_new_tokens)`` ids on the
    model's device (BOS not included).  Each step runs the decoder over
    the whole padded ``(B, max_new_tokens + 1)`` target buffer, as the JAX
    loop does (the causal decoder makes positions past the step inert),
    and takes the head at the step's position; there is no decoder KV
    cache.  The steps run through a cached program a (batch, source
    length, buffer length, mask, sampler, parameter ids) bucket
    (:mod:`apex_tpu_torch.inference.decode`): on the card its first step
    runs eagerly, its second is captured as a CUDA graph and the rest
    replay it, the step index and the buffer on the device.  Dropout is
    off.  ``temperature=0`` is greedy; otherwise temperature and
    ``top_k``, drawn from ``generator`` (a ``torch.Generator`` on the
    model's device).  ``mesh`` is taken at its default and refused
    otherwise."""
    from ..inference.decode import model_device
    from ..utils.jit_cache import compiled_run_cache, model_tensors
    accept_defaults("seq2seq_generate: tensor parallelism (mesh)", PARALLEL,
                    mesh=(mesh, None))
    b, s_src = src_ids.shape
    if max_new_tokens + 1 > model.max_positions:
        raise ValueError(
            f"max_new_tokens {max_new_tokens} exceeds max_positions "
            f"{model.max_positions} - 1")
    vocab = model.tok_emb.weight.shape[0]
    sample = make_sampler(temperature, top_k, None, vocab)
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    dev = model_device(model)
    src = src_ids.to(device=dev, dtype=torch.long)
    kpm = None if src_attention_mask is None \
        else src_attention_mask.to(dev) == 0
    masked = kpm is not None
    graph = compiled_run_cache(
        model, "_s2s_gen_cache",
        (b, s_src, max_new_tokens, masked, float(temperature), top_k),
        model_tensors(model),
        lambda: Seq2SeqGraph(model, b, s_src, max_new_tokens, masked,
                              sample, temperature > 0.0))
    was_training = model.training
    model.eval()
    try:
        return graph.generate(src, kpm, max_new_tokens, bos_id, generator)
    finally:
        model.train(was_training)
