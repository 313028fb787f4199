"""Attention functionals, the PyTorch counterpart of
``apex_tpu/contrib/multihead_attn/attn_funcs.py``.

``flash_attention`` is the fast path: the flash-attention forward kernel
(:mod:`apex_tpu_torch.kernels.attention`) inside a
``torch.autograd.Function`` whose backward runs the two backward kernels on
the saved inputs, ``out`` and ``lse``, as the JAX package's ``custom_vjp``
does; the bias gets no gradient (the JAX package returns zeros for it).
Attention dropout rides inside the kernels, its mask the hash of
``dropout_seed`` and the positions (:mod:`apex_tpu_torch.kernels.attention`),
which the backward replays from the seed vector the Function saves.
``self_attn_func`` keeps the JAX package's per-head INTERLEAVED QKV layout:
the in-projection output is reshaped to (T, B*H, 3, D), so weight rows
group as [q_h, k_h, v_h] per head, not torch's [Q; K; V] blocks;
``encdec_attn_func`` projects q from the decoder stream and an interleaved
(k, v) pair per head from the encoder stream.  On the flash path their
dropout seed is one int32 drawn from the caller's ``generator`` on the
inputs' device (:func:`draw_dropout_seed`), a fresh one per call, as each
JAX layer draws from a key of its own.  Their tensor-parallel branches
shard heads over a mesh axis (``parallel.tensor_parallel``); the
self-attention's sequence-parallel branch runs ring or Ulysses attention
(``parallel.ring_attention``).
"""
from __future__ import annotations

import math

import torch

from ...amp.policy import no_casts
from ...kernels import attention as _k
from ...kernels.dispatch import MASKED_FILL

_f32 = torch.float32


def _to_3d(q4, k4, v4, bias):
    """(B, H, S, D) -> the kernel's (B*H, S, D) layout; a per-batch bias
    (B, Sq|1, Sk) is repeated once per head, a (1, Sq|1, Sk) one
    broadcasts as it is."""
    b, h, sq, d = q4.shape
    sk = k4.shape[2]
    bias3 = bias
    if bias is not None and bias.shape[0] != 1:
        bias3 = torch.repeat_interleave(bias, h, dim=0)
    return (q4.reshape(b * h, sq, d), k4.reshape(b * h, sk, d),
            v4.reshape(b * h, sk, d), bias3)


def attention_reference(q4, k4, v4, bias, causal, scale, window=None,
                        dropout_p=0.0, dropout_seed=None):
    """Plain attention in the (B, H, S, D) layout (the flash kernel's plain
    version): fp32 scores, the finite -1e30 mask, softmax, the dropout hash
    mask of ``dropout_seed``, product; the result in q's dtype."""
    q3, k3, v3, bias3 = _to_3d(q4, k4, v4, bias)
    out3, _ = _k.flash_attention_reference(q3, k3, v3, bias3, scale, causal,
                                           window, dropout_p, dropout_seed)
    return out3.reshape(q4.shape)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k3, v3, bias3, scale, causal, window, dropout_p,
                seed):
        # one device vector [seed, 0, 0] for both directions: the backward
        # kernels replay the forward's mask from it
        seed_vec = _k.seed_vector(dropout_p, seed, device=q3.device)
        out, lse = _k.flash_fwd(q3, k3, v3, bias3, scale, causal, window,
                                dropout_p, seed_vec)
        ctx.save_for_backward(q3, k3, v3, bias3, out, lse, seed_vec)
        ctx.scale, ctx.causal, ctx.window = scale, causal, window
        ctx.dropout_p = dropout_p
        return out

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, bias3, out, lse, seed_vec = ctx.saved_tensors
        dq, dk, dv = _k.flash_bwd(q3, k3, v3, bias3, out, lse, g, ctx.scale,
                                  ctx.causal, ctx.window, ctx.dropout_p,
                                  seed_vec)
        return dq, dk, dv, None, None, None, None, None, None


def draw_dropout_seed(generator=None, device=None):
    """One int32 seed for the dropout hash, drawn from ``generator`` (the
    default generator of ``device`` when None) on ``device``: on the card
    it stays there, and the kernels read it there."""
    if generator is not None:
        device = generator.device
    return torch.randint(-2 ** 31, 2 ** 31, (), generator=generator,
                         device=device, dtype=torch.int32)


@no_casts
def flash_attention(q4, k4, v4, bias=None, causal=False, scale=None,
                    sliding_window=None, dropout_p=0.0, dropout_seed=None):
    """Fused scaled-dot-product attention, (B, H, S, D) layout.

    ``bias`` is an additive mask broadcastable as (B|1, Sq|1, Sk);
    ``causal`` masks future positions in-kernel; ``sliding_window``
    (requires ``causal``) keeps keys in (t - window, t].  ``dropout_p`` > 0
    drops attention probabilities in-kernel by the hash mask of
    ``dropout_seed`` (an int, or an int32 scalar tensor), which the
    backward regenerates; no (Sq, Sk) mask exists in memory."""
    if sliding_window is not None:
        if not causal:
            raise ValueError(
                "sliding_window requires causal=True (the band is defined "
                "against the causal direction)")
        if sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {sliding_window}")
    _k.check_dropout(dropout_p, dropout_seed)
    if not dropout_p:
        dropout_seed = None
    if scale is None:
        scale = 1.0 / math.sqrt(q4.shape[-1])
    q3, k3, v3, bias3 = _to_3d(q4, k4, v4, bias)
    args = (q3.contiguous(), k3.contiguous(), v3.contiguous(), bias3, scale,
            causal)
    if torch.is_grad_enabled():
        out3 = _FlashAttention.apply(*args, sliding_window, dropout_p,
                                     dropout_seed)
    else:   # nothing to save for a backward (generation)
        out3, _ = _k.flash_attention_fwd(*args, window=sliding_window,
                                         dropout_p=dropout_p,
                                         dropout_seed=dropout_seed)
    return out3.reshape(q4.shape)


def _split_interleaved_qkv(lin, t, b, heads, head_dim):
    """(T, B, 3E) -> three (B*H, T, D), interleaved per head."""
    lin = lin.reshape(t, b * heads, 3, head_dim)
    q, k, v = lin[:, :, 0], lin[:, :, 1], lin[:, :, 2]
    return q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)


def _masks_to_bias(mask, use_time_mask, b, heads, sq, sk, dtype=_f32):
    """Mask semantics -> additive bias (B|1, Sq|1, Sk).  Boolean and integer
    masks mark EXCLUDED positions with True; float masks are additive."""
    if mask is None:
        return None
    mask = torch.as_tensor(mask)
    excluded = mask.dtype == torch.bool or not mask.is_floating_point()
    if use_time_mask:
        if mask.dim() != 2:
            raise ValueError("Timing mask is not 2D!")
        bias = (torch.where(mask.bool(), MASKED_FILL, 0.0) if excluded
                else mask)
        return bias.to(dtype)[None, :, :]
    # key padding (B, Sk)
    bias = torch.where(mask.bool(), MASKED_FILL, 0.0) if excluded else mask
    return bias.to(dtype)[:, None, :]


def _attn_with_dropout(q3, k3, v3, bias, heads, scale, dropout_prob,
                       generator=None, use_time_mask_causal=False):
    """Materializing attention with dropout on the probabilities (the
    'default' impl)."""
    bh, sq, _ = q3.shape
    b = bh // heads
    s = torch.einsum("btd,bsd->bts", q3.float(), k3.float()) * scale
    if bias is not None:
        s = (s.reshape(b, heads, sq, -1) + bias[:, None].float()).reshape(
            bh, sq, -1)
    if use_time_mask_causal:
        rows = torch.arange(sq, device=s.device)[:, None]
        cols = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = torch.where(rows >= cols, s, MASKED_FILL)
    p = torch.softmax(s, dim=-1)
    if dropout_prob > 0.0:
        keep = 1.0 - dropout_prob
        m = torch.rand(p.shape, generator=generator, device=p.device) < keep
        p = torch.where(m, p / keep, 0.0)
    return torch.einsum("bts,bsd->btd", p, v3.float()).to(q3.dtype)


def _dropout_seed(seed, tp_axis=None):
    """The kernels' int32 seed, with the rank's index on ``tp_axis`` folded
    in as ``seed ^ (idx * 0x9E3779B1)`` (the JAX ``_dropout_seed``), so
    each head shard draws a stream of its own; ``seed`` an int32 tensor
    drawn by :func:`draw_dropout_seed`."""
    if tp_axis is None:
        return seed
    from ...parallel.mesh import resolve
    from ...parallel.ring_attention import _xor_seed
    return _xor_seed(seed, (resolve(tp_axis).index * 0x9E3779B1)
                     & 0xFFFFFFFF)


def _refuse_materialized_tp_dropout(tensor_parallel_axis, dropout):
    if tensor_parallel_axis is not None and dropout > 0.0:
        raise NotImplementedError(
            "attention dropout under tensor parallelism requires the flash "
            "path (impl='fast'): the materializing impl draws its mask from "
            "one shared generator, which would correlate dropout across "
            "head shards")


@no_casts
def self_attn_func(use_time_mask, is_training, heads, scale, inputs,
                   input_weights, output_weights, input_biases=None,
                   output_biases=None, mask=None, dropout_prob=0.0,
                   generator=None, use_flash=False, causal=False,
                   seq_parallel_axis=None, seq_parallel_impl="ring",
                   tensor_parallel_axis=None, sp_shared_key=None):
    """Self-attention over ``inputs (T, B, E)``: fused interleaved QKV
    projection, attention (``use_flash`` selects the kernel path, else the
    materializing one), output projection.  ``causal`` masks future
    positions.  ``generator`` feeds the dropout: the materializing path's
    mask, or on the flash path the seed of the kernels' hash mask, drawn
    when ``is_training`` and ``dropout_prob > 0``.

    ``seq_parallel_axis``: the time dim is sharded over that mesh axis and
    attention runs the ring (or Ulysses, per ``seq_parallel_impl``) while
    the projections stay local; masks only under ``"ulysses"``, GLOBAL in
    shape and the same on every rank.  The ring's dropout seed is drawn
    from ``sp_shared_key`` (a generator every rank of the axis holds in the
    same state; ``generator`` when None, which the train step and the model
    families keep shared across the axis), so its mask is the one-device
    run's; Ulysses folds the shard index in.

    ``tensor_parallel_axis``: Megatron head sharding.  The in-projection is
    column-parallel (the interleaved layout groups rows per head, so a
    contiguous row block is a head block), each rank attends over ``heads
    / n`` heads, and the out-projection is row-parallel with the pair's one
    all-reduce; weights stay whole, each rank reads its block.  The
    dropout seed folds the rank's index on the axis (:func:`_dropout_seed`);
    the materializing impl refuses dropout under TP."""
    t, b, e = inputs.shape
    head_dim = e // heads
    iw, ow, ib = input_weights, output_weights, input_biases
    if tensor_parallel_axis is not None:
        from ...parallel.tensor_parallel import tp_attn_begin
        (inputs,), heads, rows, (ow,) = tp_attn_begin(
            tensor_parallel_axis, heads,
            [inputs], [iw] + ([ib] if ib is not None else []), [ow])
        iw = rows[0]
        if ib is not None:
            ib = rows[1]
        e = heads * head_dim
    lin = torch.matmul(inputs, iw.t())
    if ib is not None:
        lin = lin + ib
    q3, k3, v3 = _split_interleaved_qkv(lin, t, b, heads, head_dim)
    dropout = dropout_prob if is_training else 0.0

    def heads4(x3):
        return x3.reshape(b, heads, t, head_dim)
    if seq_parallel_axis is not None:
        from ...parallel.ring_attention import (ring_attention,
                                                ulysses_attention)
        if seq_parallel_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_parallel_impl must be 'ring' or 'ulysses', got "
                f"{seq_parallel_impl!r}")
        sp_bias = None
        if mask is not None:
            if seq_parallel_impl != "ulysses":
                raise NotImplementedError(
                    "masks under sequence parallelism require the "
                    "'ulysses' impl (each rank sees the gathered global "
                    "sequence there; the ring carries no mask operand)")
            sp_bias = _masks_to_bias(mask, use_time_mask, b, heads, t, t)
            sp_bias = sp_bias.to(inputs.device)
        seed = None
        if dropout > 0.0:
            src = generator if (seq_parallel_impl != "ring"
                                or sp_shared_key is None) else sp_shared_key
            seed = _dropout_seed(draw_dropout_seed(src, inputs.device),
                                 tensor_parallel_axis)
        if seq_parallel_impl == "ring":
            ctx4 = ring_attention(heads4(q3), heads4(k3), heads4(v3),
                                  axis_name=seq_parallel_axis, causal=causal,
                                  scale=scale, dropout_p=dropout,
                                  dropout_seed=seed)
        else:
            ctx4 = ulysses_attention(heads4(q3), heads4(k3), heads4(v3),
                                     axis_name=seq_parallel_axis,
                                     causal=causal, scale=scale, bias=sp_bias,
                                     dropout_p=dropout, dropout_seed=seed)
        ctx3 = ctx4.reshape(b * heads, t, head_dim)
    elif use_flash:
        bias = _masks_to_bias(mask, use_time_mask, b, heads, t, t)
        if bias is not None:
            bias = bias.to(inputs.device)
        seed = _dropout_seed(draw_dropout_seed(generator, inputs.device),
                             tensor_parallel_axis) if dropout > 0.0 else None
        ctx4 = flash_attention(heads4(q3), heads4(k3), heads4(v3),
                               bias=bias, causal=causal, scale=scale,
                               dropout_p=dropout, dropout_seed=seed)
        ctx3 = ctx4.reshape(b * heads, t, head_dim)
    else:
        _refuse_materialized_tp_dropout(tensor_parallel_axis, dropout)
        bias = _masks_to_bias(mask, use_time_mask, b, heads, t, t)
        if bias is not None:
            bias = bias.to(inputs.device)
        ctx3 = _attn_with_dropout(q3, k3, v3, bias, heads, scale, dropout,
                                  generator, use_time_mask_causal=causal)
    ctx = ctx3.transpose(0, 1).reshape(t, b, e)
    out = torch.matmul(ctx, ow.t())
    if tensor_parallel_axis is not None:
        # the row-parallel reduction, the column -> row pair's one
        # collective; the bias is added once, after it
        from ...parallel.tensor_parallel import reduce_from_tp_region
        out = reduce_from_tp_region(out, tensor_parallel_axis)
    if output_biases is not None:
        out = out + output_biases
    return out


@no_casts
def encdec_attn_func(use_time_mask, is_training, heads, scale, inputs_q,
                     inputs_kv, input_weights_q, input_weights_kv,
                     output_weights, mask=None, dropout_prob=0.0,
                     generator=None, use_flash=False,
                     tensor_parallel_axis=None):
    """Encoder-decoder attention: q from ``inputs_q (Tq, B, E)``, an
    interleaved (k, v) projection of ``inputs_kv (Tk, B, E)`` (weight rows
    grouped [k_h, v_h] per head), attention over the encoder positions
    (never causal; ``mask`` a key-padding (B, Tk) or time (Tq, Tk) mask),
    output projection.  ``use_flash`` and ``generator`` as in
    :func:`self_attn_func`.  ``tensor_parallel_axis``: Megatron head
    sharding as in :func:`self_attn_func`, both streams through the ``f``
    operator (their gradients feed the encoder and the decoder)."""
    tq, b, e = inputs_q.shape
    tk = inputs_kv.shape[0]
    head_dim = e // heads
    wq, wkv, ow = input_weights_q, input_weights_kv, output_weights
    if tensor_parallel_axis is not None:
        from ...parallel.tensor_parallel import tp_attn_begin
        (inputs_q, inputs_kv), heads, (wq, wkv), (ow,) = tp_attn_begin(
            tensor_parallel_axis, heads, [inputs_q, inputs_kv], [wq, wkv],
            [ow])
        e = heads * head_dim
    q = torch.matmul(inputs_q, wq.t())
    kv = torch.matmul(inputs_kv, wkv.t())
    kv = kv.reshape(tk, b * heads, 2, head_dim)
    q3 = q.reshape(tq, b * heads, head_dim).transpose(0, 1)
    k3, v3 = kv[:, :, 0].transpose(0, 1), kv[:, :, 1].transpose(0, 1)
    bias = _masks_to_bias(mask, use_time_mask, b, heads, tq, tk)
    if bias is not None:
        bias = bias.to(inputs_q.device)
    dropout = dropout_prob if is_training else 0.0
    if use_flash:
        seed = _dropout_seed(draw_dropout_seed(generator, inputs_q.device),
                             tensor_parallel_axis) if dropout > 0.0 else None
        ctx4 = flash_attention(q3.reshape(b, heads, tq, head_dim),
                               k3.reshape(b, heads, tk, head_dim),
                               v3.reshape(b, heads, tk, head_dim),
                               bias=bias, causal=False, scale=scale,
                               dropout_p=dropout, dropout_seed=seed)
        ctx3 = ctx4.reshape(b * heads, tq, head_dim)
    else:
        _refuse_materialized_tp_dropout(tensor_parallel_axis, dropout)
        ctx3 = _attn_with_dropout(q3, k3, v3, bias, heads, scale, dropout,
                                  generator)
    ctx = ctx3.transpose(0, 1).reshape(tq, b, e)
    out = torch.matmul(ctx, ow.t())
    if tensor_parallel_axis is not None:
        from ...parallel.tensor_parallel import reduce_from_tp_region
        out = reduce_from_tp_region(out, tensor_parallel_axis)
    return out
