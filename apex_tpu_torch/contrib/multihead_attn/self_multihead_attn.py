"""SelfMultiheadAttn, the PyTorch counterpart of
``apex_tpu/contrib/multihead_attn/self_multihead_attn.py``.

Same constructor arguments and (T, B, E) input layout; ``impl='fast'``
runs the flash-attention kernel, ``impl='default'`` the materializing path
(the one that takes biases); ``include_norm_add`` adds a pre-LayerNorm and
the residual.  Returns ``(outputs, None)``.  Attention dropout on the fast
path runs inside the flash kernels, its seed drawn from ``generator``.
The sequence- and tensor-parallel arguments are taken at their defaults
and refused otherwise.
"""
from __future__ import annotations

import torch
from torch import nn

from ..._unported import PARALLEL, accept_defaults
from ...kernels.dispatch import resolve_device
from ...normalization.fused_layer_norm import fused_layer_norm_affine
from .attn_funcs import self_attn_func


class SelfMultiheadAttn(nn.Module):
    # one op to amp O1, as in the JAX package: its body runs with casts off
    _amp_no_casts = True

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast", causal=False,
                 seq_parallel_axis=None, seq_parallel_impl="ring",
                 tensor_parallel_axis=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        accept_defaults(
            "SelfMultiheadAttn: sequence and tensor parallelism", PARALLEL,
            seq_parallel_axis=(seq_parallel_axis, None),
            seq_parallel_impl=(seq_parallel_impl, "ring"),
            tensor_parallel_axis=(tensor_parallel_axis, None))
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"Unsupported impl: {impl} !")
        if bias and impl == "fast":
            raise ValueError(
                "The Fast implementation does not support biases!")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.causal = causal
        self.head_dim = embed_dim // num_heads
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.impl = impl
        self.scaling = self.head_dim ** -0.5
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * embed_dim, embed_dim, **kw))
        self.out_proj_weight = nn.Parameter(
            torch.empty(embed_dim, embed_dim, **kw))
        if bias:
            self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, **kw))
            self.out_proj_bias = nn.Parameter(torch.zeros(embed_dim, **kw))
        else:
            self.register_parameter("in_proj_bias", None)
            self.register_parameter("out_proj_bias", None)
        if include_norm_add:
            self.lyr_nrm_gamma_weights = nn.Parameter(
                torch.ones(embed_dim, **kw))
            self.lyr_nrm_beta_weights = nn.Parameter(
                torch.zeros(embed_dim, **kw))
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.xavier_uniform_(self.out_proj_weight)

    def forward(self, query, key=None, value=None, key_padding_mask=None,
                need_weights=False, attn_mask=None, is_training=None,
                generator=None):
        if key_padding_mask is not None:
            if attn_mask is not None:
                raise ValueError("attn_mask and key_padding_mask should not "
                                 "be both defined!")
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
        outputs = self_attn_func(
            use_time_mask, is_training, self.num_heads, self.scaling, x,
            self.in_proj_weight, self.out_proj_weight, self.in_proj_bias,
            self.out_proj_bias, mask, self.dropout, generator=generator,
            use_flash=(self.impl == "fast"), causal=self.causal)
        if self.include_norm_add:
            if is_training and self.dropout > 0.0:
                outputs = torch.nn.functional.dropout(
                    outputs, self.dropout, training=True)
            outputs = outputs + query
        return outputs, None
