"""Chunked LM head + cross-entropy, the PyTorch counterpart of
``apex_tpu/contrib/xentropy/chunked.py``.

The tied head ``hidden @ head_weight.T`` and the loss run over row chunks
of the flattened ``(N, E)`` hidden states, so the ``(N, V)`` logits never
exist whole: one ``(chunk, V)`` block at a time.  The JAX package gets this
from ``lax.map(jax.checkpoint(body))``; here one ``torch.autograd.Function``
loops over the chunks:

* forward: per chunk, the head product (``torch.matmul``, as the JAX
  package leaves it to XLA), the pad-column mask, then the xentropy forward
  kernel; only each row's ``lse`` and live-column count are kept;
* backward: per chunk, the head product again, the xentropy backward
  kernel, ``dX = dlogits @ W`` and ``dW += dlogits.T @ xc``.

So each chunk launches the forward kernel once and the backward kernel
once.  ``dW`` accumulates in the head weight's dtype (bf16 for a bf16 half
copy), chunk by chunk from the last to the first: the dtype and order of
the JAX scan transpose's carry, not fp32.
"""
from __future__ import annotations

import math

import torch

from ...amp.policy import no_casts
from ...kernels import xentropy as _k
from ...kernels.dispatch import MASKED_FILL


def _chunk_rows(n, v, requested):
    """Rows per chunk: balanced chunks of at most 1024 rows (and about
    2**26 logits), the JAX package's default rule, so a power-of-two row
    count gets no remainder chunk; ``requested`` > 0 forces a size."""
    if requested:
        return min(int(requested), n)
    cap = max(1, min(n, 1024, (1 << 26) // max(v, 1)))
    if cap >= n:
        return n
    return math.ceil(n / math.ceil(n / cap))


def _logits(xc, w, logical_vocab):
    logits = torch.matmul(xc, w.t().to(xc.dtype))
    v = w.shape[0]
    if logical_vocab is not None and logical_vocab < v:
        cols = torch.arange(v, device=logits.device)
        logits = torch.where(cols < logical_vocab, logits,
                             torch.full((), MASKED_FILL, dtype=logits.dtype,
                                        device=logits.device))
    return logits


class _ChunkedLMHeadLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, lab, smoothing, padding_idx, logical_vocab,
                chunk):
        n = x2d.shape[0]
        k = math.ceil(n / chunk)
        n_p = k * chunk
        if n_p != n:
            # the remainder chunk is padded to full size with zero rows
            # labelled padding_idx, as the JAX package does; they are
            # dropped from the result and get no gradient
            x2d = torch.cat([x2d, x2d.new_zeros((n_p - n, x2d.shape[1]))])
            lab = torch.cat([lab, lab.new_full((n_p - n,), padding_idx)])
        losses, lses, lives = [], [], []
        for i in range(k):
            sl = slice(i * chunk, (i + 1) * chunk)
            loss, lse, live = _k.xent_forward(
                _logits(x2d[sl], w, logical_vocab), lab[sl], smoothing,
                padding_idx)
            losses.append(loss)
            lses.append(lse)
            lives.append(live)
        ctx.save_for_backward(x2d, w, lab, torch.cat(lses), torch.cat(lives))
        ctx.cfg = (n, chunk, smoothing, padding_idx, logical_vocab)
        return torch.cat(losses)[:n]

    @staticmethod
    def backward(ctx, g):
        x2d, w, lab, lse, live = ctx.saved_tensors
        n, chunk, smoothing, padding_idx, logical_vocab = ctx.cfg
        n_p = x2d.shape[0]
        g = g.float()
        if n_p != n:
            g = torch.cat([g, g.new_zeros(n_p - n)])
        gm = torch.where(lab == padding_idx, 0.0, g)
        dx = torch.empty_like(x2d)
        dw = torch.zeros_like(w)
        v = w.shape[0]
        masked = logical_vocab is not None and logical_vocab < v
        for i in reversed(range(n_p // chunk)):
            sl = slice(i * chunk, (i + 1) * chunk)
            xc = x2d[sl]
            dlogits = _k.xent_backward(
                _logits(xc, w, logical_vocab), lab[sl], lse[sl], gm[sl],
                smoothing, live[sl])
            if masked:
                cols = torch.arange(v, device=dlogits.device)
                dlogits = torch.where(cols < logical_vocab, dlogits, 0.0)
            wc = w.to(dlogits.dtype)
            dx[sl] = torch.matmul(dlogits, wc).to(dx.dtype)
            dw = dw + torch.matmul(dlogits.t(), xc).to(dw.dtype)
        return dx[:n], dw, None, None, None, None, None


@no_casts
def chunked_lm_head_loss(hidden, head_weight, labels, smoothing=0.0,
                         padding_idx=-100, logical_vocab=None,
                         chunk_rows=None):
    """Per-row cross-entropy of ``hidden @ head_weight.T``, computed and
    differentiated chunk by chunk.

    hidden: (..., E) activations, flattened to rows.
    head_weight: (V, E), the tied embedding table or an untied head.
    labels: integer targets of hidden's leading shape; rows labelled
        ``padding_idx`` give loss 0 and no gradient.
    logical_vocab: with a padded head, the logical vocabulary: the pad
        columns are set to -1e30 before the loss, as the model's own pad
        mask does.
    chunk_rows: rows per chunk (default: :func:`_chunk_rows`).

    Returns fp32 losses of hidden's leading shape."""
    e = hidden.shape[-1]
    lead = tuple(hidden.shape[:-1])
    if tuple(labels.shape) != lead:
        raise ValueError(f"chunked_lm_head_loss: labels shape "
                         f"{tuple(labels.shape)} must equal hidden's "
                         f"leading shape {lead}")
    n = math.prod(lead)
    x2d = hidden.reshape(n, e)
    lab = labels.reshape(n)
    chunk = _chunk_rows(n, head_weight.shape[0], chunk_rows)
    losses = _ChunkedLMHeadLoss.apply(x2d, head_weight, lab,
                                      float(smoothing), int(padding_idx),
                                      logical_vocab, chunk)
    return losses.reshape(lead)


def make_chunked_lm_loss(vocab_size=None, smoothing=0.0, padding_idx=-100,
                         shift=True, chunk_rows=None):
    """Loss function for ``make_train_step`` over an ``output_hidden=True``
    LM: ``loss_fn((hidden, table), ids)`` is the mean chunked head loss of
    the next token (``shift=True``) or of the aligned one, over all rows,
    padding rows included (the JAX package's denominator).  ``vocab_size``
    is the logical vocabulary of a padded head (None: the table's
    height)."""
    def loss_fn(out, ids):
        hidden, table = out
        if shift:
            hidden = hidden[:, :-1]
            ids = ids[:, 1:]
        per = chunked_lm_head_loss(
            hidden, table, ids, smoothing=smoothing,
            padding_idx=padding_idx, logical_vocab=vocab_size,
            chunk_rows=chunk_rows)
        return per.mean()
    return loss_fn
