"""EncdecMultiheadAttn, the PyTorch counterpart of
``apex_tpu/contrib/multihead_attn/encdec_multihead_attn.py``.

Encoder-decoder attention with a q projection of the decoder stream and an
interleaved (k, v) projection of the encoder stream, inputs in (T, B, E).
``impl='fast'`` runs the flash-attention kernels (dropout inside them,
seeded from ``generator``), ``impl='default'`` the materializing path.
``include_norm_add`` adds a LayerNorm on the query (the LayerNorm kernels)
and the residual.  Returns ``(outputs, None)``.  There are no biases, as
in the JAX package; ``tensor_parallel_axis`` is taken at its default and
refused otherwise.
"""
from __future__ import annotations

import torch
from torch import nn

from ..._unported import PARALLEL, accept_defaults
from ...kernels.dispatch import resolve_device
from ...normalization.fused_layer_norm import fused_layer_norm_affine
from .attn_funcs import encdec_attn_func


class EncdecMultiheadAttn(nn.Module):
    # one op to amp O1, as in the JAX package: its body runs with casts off
    _amp_no_casts = True

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 tensor_parallel_axis=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        accept_defaults("EncdecMultiheadAttn: tensor parallelism", PARALLEL,
                        tensor_parallel_axis=(tensor_parallel_axis, None))
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if bias:
            raise ValueError(
                "ERROR! encdec multihead attention does not support biases!")
        if impl not in ("fast", "default"):
            raise ValueError(f"Unsupported impl: {impl} !")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        self.bias = False
        self.include_norm_add = include_norm_add
        self.impl = impl
        self.scaling = self.head_dim ** -0.5
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.in_proj_weight_q = nn.Parameter(
            torch.empty(embed_dim, embed_dim, **kw))
        self.in_proj_weight_kv = nn.Parameter(
            torch.empty(2 * embed_dim, embed_dim, **kw))
        self.out_proj_weight = nn.Parameter(
            torch.empty(embed_dim, embed_dim, **kw))
        if include_norm_add:
            self.lyr_nrm_gamma_weights = nn.Parameter(
                torch.ones(embed_dim, **kw))
            self.lyr_nrm_beta_weights = nn.Parameter(
                torch.zeros(embed_dim, **kw))
        for w in (self.in_proj_weight_q, self.in_proj_weight_kv,
                  self.out_proj_weight):
            nn.init.xavier_uniform_(w)

    def forward(self, query, key, value=None, key_padding_mask=None,
                need_weights=False, attn_mask=None, is_training=None,
                generator=None):
        """``query (Tq, B, E)`` attends over ``key (Tk, B, E)`` (``value``
        is the same stream and unused, as in the JAX package);
        ``key_padding_mask (B, Tk)`` or ``attn_mask (Tq, Tk)``, True where
        excluded; ``generator`` draws the attention dropout's seed."""
        if key_padding_mask is not None:
            if attn_mask is not None:
                raise ValueError("ERROR attn_mask and key_padding_mask "
                                 "should not be both defined!")
            mask, use_time_mask = key_padding_mask, False
        elif attn_mask is not None:
            mask, use_time_mask = attn_mask, True
        else:
            mask, use_time_mask = None, False
        if is_training is None:
            is_training = self.training

        x = query
        if self.include_norm_add:
            x = fused_layer_norm_affine(x, self.lyr_nrm_gamma_weights,
                                        self.lyr_nrm_beta_weights,
                                        (self.embed_dim,), 1e-5)
        outputs = encdec_attn_func(
            use_time_mask, is_training, self.num_heads, self.scaling, x, key,
            self.in_proj_weight_q, self.in_proj_weight_kv,
            self.out_proj_weight, mask, self.dropout, generator=generator,
            use_flash=(self.impl == "fast"))
        if self.include_norm_add:
            if is_training and self.dropout > 0.0:
                outputs = torch.nn.functional.dropout(
                    outputs, self.dropout, training=True)
            outputs = outputs + query
        return outputs, None
