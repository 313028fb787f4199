"""The vocab-chain loss, the PyTorch counterpart of
``apex_tpu/kernels/vocab_chain.py``: per-row LM-head cross-entropy through
the fused LM-head + cross-entropy kernels (:mod:`.lm_head_xent`) where they
compute the asked-for loss, else through the chunked chain
(:func:`apex_tpu_torch.contrib.xentropy.chunked_lm_head_loss`).

The JAX package routes plain cross-entropy by ``dispatch.decide`` on a
threshold measured on a TPU (its fused kernel lost there, 0.69x, so every
compiled shape defaults to the chunked chain).  No such TPU measurement
decides anything on the card: here the routing is by what each arm
computes.  Plain cross-entropy (no smoothing, no logical vocabulary below
the table's height) goes to the fused kernels; label smoothing or a padded
head goes to the chunked chain, which handles both exactly.
"""
from __future__ import annotations

import math

import torch

from .lm_head_xent import fused_lm_head_xent


def vocab_chain_loss(hidden, head_weight, labels, smoothing=0.0,
                     padding_idx=-100, logical_vocab=None, chunk_rows=None):
    """Per-row LM-head cross-entropy of ``hidden (..., E) @ head_weight.T``
    with the contract of :func:`chunked_lm_head_loss`: fp32 losses of
    ``hidden``'s leading shape; rows labelled ``padding_idx`` give loss 0
    and no gradient."""
    # contrib.xentropy imports the kernels package: importing it at module
    # top would close an import cycle
    from ..contrib.xentropy.chunked import chunked_lm_head_loss

    plain = isinstance(smoothing, (int, float)) and smoothing == 0.0
    v = head_weight.shape[0]
    if plain and (logical_vocab is None or logical_vocab >= v):
        e = hidden.shape[-1]
        lead = tuple(hidden.shape[:-1])
        if tuple(labels.shape) != lead:
            raise ValueError(f"vocab_chain_loss: labels shape "
                             f"{tuple(labels.shape)} must equal hidden's "
                             f"leading shape {lead}")
        n = math.prod(lead)
        lab = labels.reshape(n)
        per = fused_lm_head_xent(hidden.reshape(n, e), head_weight, lab)
        # padding rows give zero loss AND zero gradient: the where's
        # gradient into the kernel's branch is zero there
        per = torch.where(lab == padding_idx, torch.zeros_like(per), per)
        return per.reshape(lead)
    return chunked_lm_head_loss(hidden, head_weight, labels,
                                smoothing=smoothing, padding_idx=padding_idx,
                                logical_vocab=logical_vocab,
                                chunk_rows=chunk_rows)
