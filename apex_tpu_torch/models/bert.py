"""BERT encoder family, the PyTorch counterpart of ``apex_tpu/models/bert.py``
(BASELINE.md config 4: BERT-base pretraining with FusedLAMB and
FusedLayerNorm under amp O2).

Post-LN encoder layers (attention -> residual -> LayerNorm, tanh-GELU FFN ->
residual -> LayerNorm) over token, position and segment embeddings, and a
masked-LM head whose decoder is tied to the token embedding.  Attention is
``SelfMultiheadAttn(impl="fast")``, non-causal, through the flash-attention
kernels, with a key-padding bias from ``attention_mask == 0``; every
LayerNorm runs the LayerNorm kernels.  The public API is batch-first ``(B,
S)`` token ids; the encoder runs ``(S, B, E)``, the attention module's
layout.  In training mode the embedding, residual and attention dropout draw
from the ``generator`` passed to ``forward`` (the attention dropout as the
seed of the flash kernels' hash mask).  Parameter names are the JAX
package's, so :func:`apex_tpu_torch.models.convert.from_jax_state_dict`
carries weights across one to one.  ``remat`` runs each encoder layer
through :func:`apex_tpu_torch.nn.checkpoint_forward`.  ``tp_axis`` shards
the heads and the FFN's hidden features over a mesh axis (the weights stay
whole on every rank; ``tp_sharded_params()`` lists the block-sparse ones);
``sp_axis`` shards the sequence, with Ulysses attention (a key-padding
mask needs the gathered sequence, which the ring does not carry): the
``attention_mask`` stays GLOBAL (B, S_global) and the same on every rank,
positions are offset by the shard, and each elementwise dropout mask is
drawn for the whole sequence with this rank keeping its rows
(``models.gpt.shard_dropout``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..contrib.multihead_attn import SelfMultiheadAttn
from ..kernels.dispatch import resolve_device
from ..nn.modules import checkpoint_forward
from ..normalization import FusedLayerNorm
from .gpt import shard_dropout


class BertLayer(nn.Module):
    """One post-LN encoder block: MHA + residual + LN, GELU FFN + residual
    + LN."""

    def __init__(self, hidden, heads, intermediate, dropout=0.1,
                 attn_dropout=0.1, sp_axis=None, tp_axis=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        # the encoder's SP runs Ulysses: non-causal attention under a
        # key-padding mask needs the whole sequence on each rank
        self.attn = SelfMultiheadAttn(hidden, heads, dropout=attn_dropout,
                                      impl="fast", seq_parallel_axis=sp_axis,
                                      seq_parallel_impl="ulysses",
                                      tensor_parallel_axis=tp_axis, **kw)
        self.attn_ln = FusedLayerNorm(hidden, **kw)
        self.fc1 = nn.Linear(hidden, intermediate, **kw)
        self.fc2 = nn.Linear(intermediate, hidden, **kw)
        self.out_ln = FusedLayerNorm(hidden, **kw)
        self.dropout = nn.Dropout(dropout)
        self.tp_axis = tp_axis
        self.sp_axis = sp_axis

    def forward(self, x, key_padding_mask=None, generator=None):
        """``x (S, B, E)`` (this rank's rows under ``sp_axis``);
        ``key_padding_mask (B, S)`` True where a key is padding (GLOBAL
        under ``sp_axis``); ``generator`` draws the dropout masks."""
        p, sp = self.dropout.p, self.sp_axis
        h, _ = self.attn(x, key_padding_mask=key_padding_mask,
                         generator=generator)
        x = self.attn_ln(x + shard_dropout(h, p, self.training, generator,
                                           sp, 0))
        gelu = lambda y: F.gelu(y, approximate="tanh")  # noqa: E731
        if self.tp_axis is not None:
            # Megatron's MLP: column -> GELU -> row, one all-reduce a pair
            from ..parallel.tensor_parallel import tp_ffn
            h = tp_ffn(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                       self.fc2.bias, self.tp_axis, activation=gelu)
        else:
            h = self.fc2(gelu(self.fc1(x)))
        return self.out_ln(x + shard_dropout(h, p, self.training, generator,
                                             sp, 0))

    def tp_sharded_params(self):
        """The block-sparse-gradient parameters under ``tp_axis``: the
        attention's, then the MLP's column and row entries."""
        return self.attn.tp_sharded_params() + [
            self.fc1.weight, self.fc1.bias, self.fc2.weight]


def segment_embedding(table, ids):
    """The rows of the small segment table ``(type_vocab, E)`` at ``ids``,
    as a product of the ids' one-hot rows with the table.  Its gradient is
    the transposed product, summed in a fixed order on the card;
    ``F.embedding``'s backward on the card adds the 8192 rows of a 64 x 128
    batch into one table row in an order that varies from run to run
    (ROADMAP C6), so two runs of the train step differed there.  Each
    forward row is its table row exactly (one nonzero product)."""
    return torch.matmul(F.one_hot(ids, table.shape[0]).to(table.dtype), table)


class BertModel(nn.Module):
    """Token/position/segment embeddings + N encoder layers.

    ``forward(input_ids (B, S), token_type_ids=None, attention_mask=None)``
    returns the sequence output ``(B, S, E)``.  ``attention_mask`` follows
    the BERT convention: 1 for real tokens, 0 for padding.  Runs on the
    CUDA card unless ``device="cpu"`` is passed; weights are drawn from
    PyTorch's global generator, the embeddings N(0, 0.02) (BERT's
    initializer range, as in the JAX package)."""

    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 intermediate=3072, max_positions=512, type_vocab=2,
                 dropout=0.1, attn_dropout=0.1, remat=False, sp_axis=None,
                 tp_axis=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.tp_axis = tp_axis
        self.sp_axis = sp_axis
        self.hidden = hidden
        self.max_positions = max_positions
        self.remat = remat
        self.tok_emb = nn.Embedding(vocab_size, hidden, **kw)
        self.pos_emb = nn.Embedding(max_positions, hidden, **kw)
        self.type_emb = nn.Embedding(type_vocab, hidden, **kw)
        for emb in (self.tok_emb, self.pos_emb, self.type_emb):
            nn.init.normal_(emb.weight, std=0.02)
        self.emb_ln = FusedLayerNorm(hidden, **kw)
        self.emb_drop = nn.Dropout(dropout)
        self.layers = nn.ModuleList([
            BertLayer(hidden, heads, intermediate, dropout, attn_dropout,
                      sp_axis=sp_axis, tp_axis=tp_axis, **kw)
            for _ in range(layers)])

    def tp_sharded_params(self):
        """Every layer's block-sparse-gradient parameters under
        ``tp_axis``."""
        return [p for ly in self.layers for p in ly.tp_sharded_params()]

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
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
        pos = torch.arange(off, off + s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.tok_emb(input_ids) + self.pos_emb(pos) \
            + segment_embedding(self.type_emb.weight, token_type_ids)
        x = shard_dropout(self.emb_ln(x), self.emb_drop.p, self.training,
                          generator, self.sp_axis, 1)
        x = x.transpose(0, 1)                  # (S, B, E)
        kpm = None if attention_mask is None else attention_mask == 0
        for layer in self.layers:
            if self.remat:
                x = checkpoint_forward(layer, x, kpm, generator)
            else:
                x = layer(x, key_padding_mask=kpm, generator=generator)
        return x.transpose(0, 1)


class BertForMaskedLM(nn.Module):
    """BertModel + the MLM transform head (dense, GELU, LayerNorm) with the
    decoder tied to the token embedding plus ``decoder_bias``."""

    def __init__(self, device=None, dtype=torch.float32, **kw):
        super().__init__()
        device = resolve_device(device)
        self.bert = BertModel(device=device, dtype=dtype, **kw)
        hidden = self.bert.hidden
        self.transform = nn.Linear(hidden, hidden, device=device,
                                   dtype=dtype)
        self.transform_ln = FusedLayerNorm(hidden, device=device, dtype=dtype)
        vocab = self.bert.tok_emb.weight.shape[0]
        self.decoder_bias = nn.Parameter(
            torch.zeros(vocab, dtype=torch.float32, device=device))

    def tp_sharded_params(self):
        """The encoder's block-sparse-gradient parameters (the MLM head
        stays replicated)."""
        return self.bert.tp_sharded_params()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                mlm_positions=None, generator=None):
        """Logits ``(B, S, V)``, or ``(B, P, V)`` over ``mlm_positions (B,
        P)``: the head runs only on the gathered positions (the pretraining
        recipe's ``masked_lm_positions``), which equals gathering after the
        head.  ``input_ids`` may also arrive as ``(ids, mlm_positions)``,
        the fused train step's single model input."""
        if mlm_positions is None and isinstance(input_ids, (tuple, list)):
            input_ids, mlm_positions = input_ids
        seq = self.bert(input_ids, token_type_ids, attention_mask,
                        generator=generator)
        if mlm_positions is not None:
            idx = mlm_positions.long()[..., None].expand(-1, -1,
                                                         seq.shape[-1])
            seq = torch.gather(seq, 1, idx)
        h = self.transform_ln(F.gelu(self.transform(seq), approximate="tanh"))
        emb = self.bert.tok_emb.weight
        logits = torch.matmul(h, emb.t().to(h.dtype))
        return logits + self.decoder_bias.to(logits.dtype)


def bert_base(**kw):
    """BERT-base: 12 layers, hidden 768, 12 heads (110M parameters)."""
    return BertForMaskedLM(**{**dict(hidden=768, layers=12, heads=12,
                                     intermediate=3072), **kw})


def bert_large(**kw):
    """BERT-large: 24 layers, hidden 1024, 16 heads (340M parameters)."""
    return BertForMaskedLM(**{**dict(hidden=1024, layers=24, heads=16,
                                     intermediate=4096), **kw})
