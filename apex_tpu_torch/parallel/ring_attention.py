"""Sequence parallelism in attention: ring attention and Ulysses
all-to-all, the PyTorch counterpart of
``apex_tpu/parallel/ring_attention.py``.

* ``ring_attention``: the sequence stays sharded.  K/V chunks rotate around
  the ring (``dist.batch_isend_irecv`` to the next rank and from the
  previous one, the JAX ``lax.ppermute``), and each rank folds one chunk a
  step into its running (out, lse) pair in fp32 (:func:`_merge`).  Each
  chunk goes through the flash-attention forward kernel
  (``kernels/attention.py::flash_attention_fwd``) with ``causal=False``, the
  chunk's causal bias (:func:`_chunk_bias`: -1e30 where the global key
  follows the global query) and the dropout offsets of the chunk's global
  rows and columns.  The backward (:class:`_Ring`) is a second ring pass:
  each chunk's flash backward against the GLOBAL (out, lse), with the
  dK/dV accumulators travelling with their chunk, so n hops bring each
  home.  GQA rings carry KVH-wide chunks and expand them at the point of
  use.  A ring of one rank sends nothing.
* ``ulysses_attention``: two all-to-alls (``dist.all_to_all_single``)
  trade the sequence shard for a head shard around an ordinary
  whole-sequence flash attention on H/n heads; its backward is the inverse
  all-to-alls.

The ring's dropout hashes GLOBAL coordinates under the seed every rank of
the axis shares, so its mask is bit for bit the one-device kernel's.
Ulysses attends whole sequences over its own head block, so it folds the
shard index into the seed (:func:`_sp_seed_fold`), deliberately not the
tensor-parallel fold.

One ring step is :func:`ring_fwd_step` / :func:`ring_bwd_step`, as the JAX
``step(r, ..., rotate)``: the rank's index, the ring size and the rotation
are passed in, so a ring can be replayed in one process, chunk by chunk, by
the same code (``rotate=None`` and the chunk the rank would hold).  The JAX
``UNROLL_LIMIT`` chooses between an unrolled loop and ``fori_loop`` for the
size of its HLO; a Python loop has no such concern, so there is one loop.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..kernels import attention as _k
from .mesh import global_rank, resolve
from .tensor_parallel import all_to_all_grad

_f32 = torch.float32
_NEG = -1e30


def _chunk_bias(sq, sk, q_off, k_off, causal, device):
    """The additive (1, sq, sk) fp32 bias masking global causal order for a
    K/V chunk at global key offset ``k_off`` against queries at ``q_off``;
    None without ``causal``."""
    if not causal:
        return None
    rows = q_off + torch.arange(sq, device=device)[:, None]
    cols = k_off + torch.arange(sk, device=device)[None, :]
    zero = torch.zeros((), dtype=_f32, device=device)
    return torch.where(rows >= cols, zero, torch.full_like(zero, _NEG))[None]


def _merge(out, lse, o_r, lse_r):
    """Fold a chunk's (normalized out, lse) into the running fp32 pair."""
    lse_new = torch.logaddexp(lse, lse_r)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_r - lse_new)[..., None]
    return out * w_old + o_r.to(_f32) * w_new, lse_new


def _expand_kv(kv3, groups, batch):
    """(B*KVH, Sk, D) -> (B*H, Sk, D): each KV head repeated over its query
    group (kv-major, the Llama family's GQA head order)."""
    if groups == 1:
        return kv3
    bkv, sk, d = kv3.shape
    return kv3.reshape(batch, bkv // batch, 1, sk, d).expand(
        batch, bkv // batch, groups, sk, d).reshape(bkv * groups, sk, d)


def _reduce_kv_grad(g3, groups, batch):
    """The transpose of :func:`_expand_kv`: each query group's gradient
    summed onto its KV head."""
    if groups == 1:
        return g3
    bh, sk, d = g3.shape
    return g3.reshape(batch, bh // batch // groups, groups, sk, d).sum(
        dim=2).reshape(bh // groups, sk, d)


def ring_fwd_step(r, idx, n, q3, k_cur, v_cur, out, lse, *, causal, scale,
                  groups, batch, dropout_p=0.0, seed=None, rotate=None):
    """Ring step ``r`` of rank ``idx`` of ``n``: the chunk it holds is global
    chunk ``(idx - r) % n``; attend it, merge, and hand K/V to ``rotate``
    (None: keep them).  Returns ``(out, lse, k_next, v_next)``."""
    sq, sk = q3.shape[1], k_cur.shape[1]
    src = (idx - r) % n
    bias = _chunk_bias(sq, sk, idx * sq, src * sk, causal, q3.device)
    o_r, lse_r = _k.flash_attention_fwd(
        q3, _expand_kv(k_cur, groups, batch).contiguous(),
        _expand_kv(v_cur, groups, batch).contiguous(), bias, scale, False,
        dropout_p=dropout_p, dropout_seed=seed if dropout_p else None,
        dropout_row_off=idx * sq, dropout_col_off=src * sk)
    out, lse = _merge(out, lse, o_r, lse_r)
    if rotate is not None:
        k_cur, v_cur = rotate(k_cur), rotate(v_cur)
    return out, lse, k_cur, v_cur


def ring_bwd_step(r, idx, n, q3, k_cur, v_cur, out_c, lse, g_c, dq, dk_cur,
                  dv_cur, *, causal, scale, groups, batch, dropout_p=0.0,
                  seed=None, rotate_kv=None, rotate_acc=None):
    """Backward ring step ``r``: the chunk's flash backward against the
    global ``(out_c, lse)``; dQ accumulates here, the chunk's dK/dV
    accumulators (``dk_cur``/``dv_cur``, fp32) travel on with it
    (``rotate_acc``), K/V by ``rotate_kv``.  Returns ``(dq, dk_next,
    dv_next, k_next, v_next)``."""
    sq, sk = q3.shape[1], k_cur.shape[1]
    src = (idx - r) % n
    bias = _chunk_bias(sq, sk, idx * sq, src * sk, causal, q3.device)
    dq_r, dk_r, dv_r = _k.flash_attention_bwd(
        q3, _expand_kv(k_cur, groups, batch).contiguous(),
        _expand_kv(v_cur, groups, batch).contiguous(), bias, out_c, lse,
        g_c, scale, False, dropout_p=dropout_p,
        dropout_seed=seed if dropout_p else None,
        dropout_row_off=idx * sq, dropout_col_off=src * sk)
    dq = dq + dq_r.to(_f32)
    dk_cur = dk_cur + _reduce_kv_grad(dk_r, groups, batch).to(_f32)
    dv_cur = dv_cur + _reduce_kv_grad(dv_r, groups, batch).to(_f32)
    if rotate_kv is not None:
        k_cur, v_cur = rotate_kv(k_cur), rotate_kv(v_cur)
    if rotate_acc is not None:
        dk_cur, dv_cur = rotate_acc(dk_cur), rotate_acc(dv_cur)
    return dq, dk_cur, dv_cur, k_cur, v_cur


def _rotation(ax):
    """Send to the next rank of ``ax`` and receive from the previous one
    (``lax.ppermute`` with ``(i, (i + 1) % n)``); None for one rank."""
    if ax.size == 1:
        return None
    nxt = global_rank(ax, (ax.index + 1) % ax.size)
    prv = global_rank(ax, (ax.index - 1) % ax.size)

    def rotate(x):
        x = x.contiguous()
        got = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, nxt, ax.group),
            dist.P2POp(dist.irecv, got, prv, ax.group)])
        for req in reqs:
            req.wait()
        return got
    return rotate


def ring_forward(q3, k3, v3, idx, n, rotate, **kw):
    """The n forward steps of rank ``idx``: ``(out fp32, lse)``."""
    bh, sq, d = q3.shape
    out = torch.zeros((bh, sq, d), dtype=_f32, device=q3.device)
    lse = torch.full((bh, sq), -math.inf, dtype=_f32, device=q3.device)
    k_cur, v_cur = k3, v3
    for r in range(n):
        out, lse, k_cur, v_cur = ring_fwd_step(
            r, idx, n, q3, k_cur, v_cur, out, lse,
            rotate=rotate if r != n - 1 else None, **kw)
    return out, lse


def ring_backward(q3, k3, v3, out_c, lse, g_c, idx, n, rotate, **kw):
    """The n backward steps of rank ``idx``: ``(dq, dk, dv)`` in fp32, each
    dK/dV back on its chunk's owner after n hops."""
    dq = torch.zeros(q3.shape, dtype=_f32, device=q3.device)
    dk = torch.zeros(k3.shape, dtype=_f32, device=q3.device)
    dv = torch.zeros(v3.shape, dtype=_f32, device=q3.device)
    k_cur, v_cur = k3, v3
    for r in range(n):
        # K/V are dead after the last compute; the accumulators take
        # every hop
        dq, dk, dv, k_cur, v_cur = ring_bwd_step(
            r, idx, n, q3, k_cur, v_cur, out_c, lse, g_c, dq, dk, dv,
            rotate_kv=rotate if r != n - 1 else None, rotate_acc=rotate,
            **kw)
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k3, v3, seed, ax, kw):
        rotate = _rotation(ax)
        out, lse = ring_forward(q3, k3, v3, ax.index, ax.size, rotate,
                                seed=seed, **kw)
        out_c = out.to(q3.dtype)
        ctx.save_for_backward(q3, k3, v3, out_c, lse)
        ctx.ax, ctx.kw, ctx.seed = ax, kw, seed
        return out_c

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out_c, lse = ctx.saved_tensors
        seed, ax = ctx.seed, ctx.ax
        dq, dk, dv = ring_backward(q3, k3, v3, out_c, lse,
                                   g.to(q3.dtype).contiguous(), ax.index,
                                   ax.size, _rotation(ax), seed=seed,
                                   **ctx.kw)
        return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype), None, \
            None, None


def ring_attention(q, k, v, axis_name, causal=False, scale=None,
                   dropout_p=0.0, dropout_seed=None):
    """Ring self/cross attention over a sequence-sharded mesh axis.

    q (B, H, Sq_local, D); k/v (B, KVH, Sk_local, D) with KVH dividing H
    (GQA: the ring carries KVH-wide chunks and expands each at the point
    of use).  Rank i of ``axis_name`` holds global rows [i*S_local,
    (i+1)*S_local).  Returns the local output shard (B, H, Sq_local, D) in
    q's dtype.  ``dropout_p`` > 0 drops attention probabilities by the
    kernels' hash mask at GLOBAL coordinates under ``dropout_seed`` (an
    int32 scalar, the same on every rank of the axis), so the result is
    bit-consistent with the one-device kernel's mask."""
    if dropout_p:
        if not 0.0 <= dropout_p < 1.0:
            raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
        if dropout_seed is None:
            raise ValueError("dropout_p > 0 requires dropout_seed "
                             "(replicated across the axis)")
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    if h % h_kv:
        raise ValueError(f"ring_attention: q heads ({h}) not divisible by "
                         f"kv heads ({h_kv})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ax = resolve(axis_name)
    q3 = q.reshape(b * h, s, d).contiguous()
    k3 = k.reshape(b * h_kv, k.shape[2], d).contiguous()
    v3 = v.reshape(b * h_kv, v.shape[2], d).contiguous()
    kw = dict(causal=causal, scale=scale, groups=h // h_kv, batch=b,
              dropout_p=dropout_p)
    out = _Ring.apply(q3, k3, v3, dropout_seed if dropout_p else None, ax,
                      kw)
    return out.reshape(b, h, s, d)


_U32 = 0xFFFFFFFF


def _i32(x):
    """A uint32 value as the int32 of the same bits."""
    x &= _U32
    return x - (1 << 32) if x >= 1 << 31 else x


def _xor_seed(seed, fold):
    """``seed ^ fold`` in int32 bits; ``seed`` an int or an int32 tensor,
    ``fold`` a Python uint32."""
    if isinstance(seed, torch.Tensor):
        return torch.bitwise_xor(seed.to(torch.int32), _i32(fold))
    return _i32((int(seed) & _U32) ^ fold)


def _sp_seed_fold(seed, idx):
    """Fold a sequence-parallel shard index into a dropout seed:
    multiply-then-avalanche, deliberately NOT the linear xor of the TP fold
    (``attn_funcs._dropout_seed``), which would make devices (a, b) and
    (b, a) of a TP x SP mesh draw one stream.  ``idx`` is a host int."""
    h = ((int(idx) + 1) * 0x85EBCA6B) & _U32
    h ^= h >> 15
    return _xor_seed(seed, h)


def ulysses_attention(q, k, v, axis_name, causal=False, scale=None,
                      bias=None, dropout_p=0.0, dropout_seed=None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism.

    q/k/v (B, H, S_local, D) sequence-sharded on ``axis_name``; H must be
    divisible by the axis size.  Two all-to-alls re-shard heads and
    sequence around an ordinary whole-sequence flash attention, so each
    rank computes H/n whole heads.  ``bias`` applies to the gathered
    sequence: GLOBAL shape (B|1, Sq_global|1, Sk_global), the same on every
    rank.  ``dropout_p`` > 0 folds the shard index into ``dropout_seed``
    (:func:`_sp_seed_fold`): each rank draws over its own head block."""
    from ..contrib.multihead_attn.attn_funcs import flash_attention
    n = resolve(axis_name).size
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses_attention: heads ({q.shape[1]}) not divisible by "
            f"sequence-parallel axis size ({n})")
    if bias is not None:
        if bias.shape[-1] != k.shape[2] * n:
            raise ValueError(
                f"ulysses_attention: bias key dim ({bias.shape[-1]}) must "
                f"equal the GLOBAL key length ({k.shape[2] * n}); pass the "
                "replicated global-shape bias, not a sequence-local shard")
        if bias.dim() >= 2 and bias.shape[-2] not in (1, q.shape[2] * n):
            raise ValueError(
                f"ulysses_attention: bias query dim ({bias.shape[-2]}) must "
                f"be 1 or the GLOBAL query length ({q.shape[2] * n})")
    # (B, H, S_loc, D) -> (B, H/n, S_global, D)
    qh, kh, vh = (all_to_all_grad(t, axis_name, 1, 2) for t in (q, k, v))
    seed = dropout_seed
    if dropout_p and seed is not None:
        seed = _sp_seed_fold(seed, resolve(axis_name).index)
    out = flash_attention(qh, kh, vh, bias=bias, causal=causal, scale=scale,
                          dropout_p=dropout_p, dropout_seed=seed)
    # back to (B, H, S_loc, D)
    return all_to_all_grad(out, axis_name, 2, 1)
