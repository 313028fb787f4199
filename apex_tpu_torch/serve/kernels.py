"""Paged-attention program bodies, the PyTorch counterpart of
``apex_tpu/serve/kernels.py``: the code the serve engine submits through
the executor, one CUDA graph a bucket signature on the card.

Operand shapes are functions of the pool geometry (layers, heads,
block_size, head_dim) and the bucket dims (batch, blocks, chunk), never of
live request state.  Request state (which sessions, at which positions,
holding which blocks) enters as device integer tensors (tokens, positions,
block tables, a prefill chunk's first position and live length, a block
copy's source and destination), so a replay reads each tick's values
where the executor copied them: no host value is baked into a graph.

The bodies update the pool(s) in place and return only small tensors
(tokens, the last logits, acceptance lengths): the pools are the
programs' held arguments, and the executor would copy a returned pool on
every replay.  They read the models' parameters where they lie, so
``ServeEngine.publish_weights`` copies new values into those tensors.

The attention math reuses the model's own decode pieces:
``GptBlock._chunk_qkv`` (LN1 through the LayerNorm kernel and the
interleaved QKV projection), ``GptBlock._attn_mlp_tail`` (out-projection,
residual, LN2, FFN), the fp32 score einsum + ``-1e30`` mask + softmax of
``GptBlock.decode_chunk`` and the int8-aware ``gather_rows``, so the paged
path cannot drift from the contiguous-cache path it is tested against.
Attention itself is plain PyTorch, as it is plain XLA in the JAX package.
The new part is index plumbing: block-table gathers into a per-layer
linear cache view, and position -> (block, offset) scatters of fresh KV.

Dead batch rows (bucket padding) are encoded as ``position == -1``: their
tables are all-null (gathers read zeros the mask excludes), their
embedding lookups clip to row 0 (outputs discarded), and their KV writes
target block ``num_blocks``, one past the pool.  Where the JAX package
drops such a write (``mode="drop"``), :func:`scatter_pool` writes zeros
into the null block instead, which is what that block holds: no index
past the pool reaches an ``index_put_`` (on the card that would be a
device-side assert), and block 0 stays all zeros.
"""
from __future__ import annotations

import torch

from ..inference.quant import QuantKV, absmax_int8, gather_rows, raw
from ..kernels.dispatch import MASKED_FILL

_f32 = torch.float32


# ---------------------------------------------------------------------------
# Pool indexing: block-table gather / position scatter
# ---------------------------------------------------------------------------


def gather_pool(pool, tables):
    """Gather each session's blocks into a LINEAR cache view, one layer at
    a time.

    ``tables (B, nb)`` physical ids -> per-layer reader ``read(l)``
    returning ``(k, v)`` of shape ``(B, H, nb*block_size, D)`` fp32, where
    linear slot ``s`` holds the KV of logical position ``s``.  Only layer
    ``l``'s blocks move on a read, so a program holds one layer's view at a
    time.  Null-padded entries read the zero block, masked out by the
    caller.  QuantKV pools gather int8 payload + scales and dequantize
    after the gather."""
    b, nb = tables.shape
    flat = tables.reshape(-1)

    def lin(part, layer, kv):
        g = part[layer, kv].index_select(0, flat)      # (B*nb, H, bs, D)
        _, h, bs, d = g.shape
        return g.view(b, nb, h, bs, d).permute(0, 2, 1, 3, 4).reshape(
            b, h, nb * bs, d)

    if isinstance(pool, QuantKV):
        def read(layer):
            return tuple(lin(pool.q, layer, kv).to(_f32)
                         * lin(pool.scale, layer, kv) for kv in (0, 1))
        return read

    def read(layer):
        return lin(pool, layer, 0).to(_f32), lin(pool, layer, 1).to(_f32)
    return read


def _put(arr, layer, kv, blk, offs, vals):
    # arr[layer, kv] is (NB, H, bs, D); seen as (NB, bs, H, D) the
    # (block, offset) pairs index its first two axes
    arr[layer, kv].transpose(1, 2).index_put_((blk, offs), vals)


def scatter_pool(pool, layer, kv, blk_ids, offs, vals):
    """Write ``vals (R, H, D)`` into ``pool[layer, kv]`` at physical block
    ``blk_ids (R,)``, in-block offset ``offs (R,)``, in place; returns the
    pool.  Rows whose ``blk_ids`` point past the pool are dropped: they
    write zeros into the null block, which holds zeros.  QuantKV pools
    quantize per position (absmax over D, the contiguous int8 cache's
    stored bytes)."""
    live = blk_ids < pool.shape[2]
    blk = torch.where(live, blk_ids, 0)
    keep = live[:, None, None]
    if isinstance(pool, QuantKV):
        q, scale = absmax_int8(vals.to(_f32), -1, pool.scale.dtype)
        _put(pool.q, layer, kv, blk, offs, torch.where(keep, q, 0))
        _put(pool.scale, layer, kv, blk, offs, torch.where(keep, scale, 0))
        return pool
    _put(pool, layer, kv, blk, offs,
         torch.where(keep, vals.to(pool.dtype), 0))
    return pool


def insert_row(pool, k_lin, v_lin, k_new, v_new, own):
    """Splice the just-projected KV row(s) into the gathered linear view
    where ``own`` is set, so the current query attends its own fresh keys
    (the paged analogue of decode_chunk's write-then-read).  Through an
    int8 pool the inserted rows take the quantize -> dequantize round trip
    first, so attention reads exactly the bytes the scatter will store."""
    if isinstance(pool, QuantKV):
        kq, ks = absmax_int8(k_new.to(_f32), -1, pool.scale.dtype)
        vq, vs = absmax_int8(v_new.to(_f32), -1, pool.scale.dtype)
        k_new = kq.to(_f32) * ks
        v_new = vq.to(_f32) * vs
    return (torch.where(own, k_new.to(_f32), k_lin),
            torch.where(own, v_new.to(_f32), v_lin))


def _parts(pool):
    return tuple(pool) if isinstance(pool, QuantKV) else (pool,)


def build_block_copy_fn():
    """The copy-on-write fork program body: ``fn(pool, src, dst)``
    duplicates ONE physical block's bytes (every layer, k and v, payload
    AND scales of a QuantKV pool) from block ``src`` to block ``dst`` (0-d
    int64 device tensors, so one graph serves every fork), in place."""
    @torch.no_grad()
    def fn(pool, src, dst):
        for part in _parts(pool):
            part.index_copy_(2, dst.reshape(1),
                             part.index_select(2, src.reshape(1)))
    return fn


# ---------------------------------------------------------------------------
# Program bodies
# ---------------------------------------------------------------------------


def _paged_attend(blk, x, q, k_lin, v_lin, positions, slots, window):
    """decode_chunk's score/mask/softmax/combine against a gathered linear
    cache: ``q (B, H, Q, D)``, per-row query positions ``positions (B,
    Q)``.  ``window`` adds the sliding-window band term."""
    scores = torch.einsum("bhqd,bhsd->bhqs", q.to(_f32),
                          k_lin) * blk.attn.scaling
    valid = slots[None, None, :] <= positions[:, :, None]     # (B, Q, S)
    if window is not None:
        valid = valid & (slots[None, None, :]
                         > positions[:, :, None] - window)
    scores = torch.where(valid[:, None], scores, MASKED_FILL)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqs,bhsd->bhqd", probs, v_lin).to(x.dtype)
    b, h, s_q, d = q.shape
    return o.transpose(1, 2).reshape(b, s_q, h * d)


def _embed(model, toks, positions):
    """Token + position embedding with int8-aware row gathers;
    ``positions`` clip to the table (pad rows only: real positions are
    range-checked at admission)."""
    n_pos = raw(model.pos_emb).shape[0]
    pos = positions.clamp(0, n_pos - 1)
    return gather_rows(raw(model.tok_emb), toks) \
        + gather_rows(raw(model.pos_emb), pos)


def _head(model, x):
    emb = model.tok_emb.weight
    return model._mask_pad_logits(torch.matmul(x, emb.t().to(x.dtype)))


def build_decode_fn(model, params, block_size, num_blocks, window=None):
    """The decode-tick program body: one token per live session.

    ``fn(pool, tokens, positions, tables) -> (next_tokens, logits)`` with
    ``tokens (B,)`` the last emitted token per session, ``positions (B,)``
    its ingest position (``-1`` = dead pad row), ``tables (B, nb)``; the
    pool is written in place.  Greedy sampling happens in the program
    (argmax over the masked logits), so the engine's host round trip per
    tick is one small int tensor; the logits ride along for clients
    (PagedSession) that continue from them.  ``params`` is taken for the
    JAX signature: the body reads the model's parameters where they lie."""
    bs = block_size

    @torch.no_grad()
    def fn(pool, tokens, positions, tables):
        x = _embed(model, tokens[:, None], positions[:, None])
        read = gather_pool(pool, tables)
        slots = torch.arange(tables.shape[1] * bs, device=tokens.device)
        own = (slots[None, :] == positions[:, None])[:, None, :, None]
        fresh = []
        for layer, blk in enumerate(model.blocks):
            q, k_new, v_new = blk._chunk_qkv(x)          # (B, H, 1, D)
            k_lin, v_lin = insert_row(pool, *read(layer), k_new, v_new,
                                      own)
            o = _paged_attend(blk, x, q, k_lin, v_lin, positions[:, None],
                              slots, window)
            x = blk._attn_mlp_tail(x, o)
            fresh.append((k_new, v_new))
        x = model.ln_f(x)
        logits = _head(model, x)[:, 0]                    # (B, V)
        nxt = torch.argmax(logits, dim=-1)
        # position -> (physical block, offset); dead rows drop
        p = positions.clamp(min=0)
        tgt = torch.gather(
            tables, 1, (p // bs).clamp(max=tables.shape[1] - 1)[:, None])
        tgt = torch.where(positions >= 0, tgt[:, 0], num_blocks)
        offs = p % bs
        for layer, (k_new, v_new) in enumerate(fresh):
            scatter_pool(pool, layer, 0, tgt, offs, k_new[:, :, 0, :])
            scatter_pool(pool, layer, 1, tgt, offs, v_new[:, :, 0, :])
        return nxt, logits
    return fn


def build_prefill_fn(model, params, block_size, num_blocks, window=None):
    """The prefill-chunk program body: ingest one fixed-width chunk of ONE
    session's prompt per dispatch (long prompts run as several chunks,
    interleaved with decode ticks).

    ``fn(pool, toks, table, t0, n_real) -> last_logits`` with ``toks (1,
    chunk)`` zero-padded past ``n_real``, ``table (1, nb)``, ``t0`` the
    chunk's first position and ``n_real`` the live prefix length (0-d
    int64 device tensors: the chunk width, not the prompt length, keys the
    graph).  ``last_logits (1, V)`` is row ``n_real - 1``, gathered on the
    device: the next-token distribution once the final chunk lands."""
    bs = block_size

    @torch.no_grad()
    def fn(pool, toks, table, t0, n_real):
        chunk = toks.shape[1]
        rows = torch.arange(chunk, device=toks.device)
        pos = t0 + rows                                   # (chunk,)
        x = _embed(model, toks, pos[None, :])
        read = gather_pool(pool, table)
        nb = table.shape[1]
        slots = torch.arange(nb * bs, device=toks.device)
        # chunk row d lands in linear slot t0 + d; live rows only
        d = slots - t0                                    # (S,)
        own = ((d >= 0) & (d < n_real))[None, None, :, None]
        src = d.clamp(0, chunk - 1)
        fresh = []
        for layer, blk in enumerate(model.blocks):
            q, k_new, v_new = blk._chunk_qkv(x)        # (1, H, chunk, D)
            k_lin, v_lin = insert_row(pool, *read(layer),
                                      k_new.index_select(2, src),
                                      v_new.index_select(2, src), own)
            o = _paged_attend(blk, x, q, k_lin, v_lin, pos[None, :], slots,
                              window)
            x = blk._attn_mlp_tail(x, o)
            fresh.append((k_new, v_new))
        x = model.ln_f(x)
        logits = _head(model, x)                       # (1, chunk, V)
        last = logits.index_select(
            1, (n_real - 1).clamp(min=0).reshape(1))[:, 0]
        tgt = table[0].index_select(0, (pos // bs).clamp(max=nb - 1))
        tgt = torch.where(rows < n_real, tgt, num_blocks)
        offs = pos % bs
        for layer, (k_new, v_new) in enumerate(fresh):
            scatter_pool(pool, layer, 0, tgt, offs, k_new[0].transpose(0, 1))
            scatter_pool(pool, layer, 1, tgt, offs, v_new[0].transpose(0, 1))
        return last
    return fn


def _scatter_chunk(pool, fresh, tables, positions, block_size, num_blocks,
                   width):
    """Batched multi-position scatter: write ``fresh`` (per layer ``(k_new,
    v_new)`` of shape ``(B, H, width, D)``) so chunk row ``j`` of batch row
    ``b`` lands at logical position ``positions[b] + j``.  Dead rows
    (``positions == -1``) are dropped; live rows are distinct (position,
    table) pairs, so the scatter has no write conflicts."""
    bs = block_size
    nb = tables.shape[1]
    p = positions[:, None] \
        + torch.arange(width, device=positions.device)[None, :]
    pc = p.clamp(min=0)
    tgt = torch.gather(tables, 1, (pc // bs).clamp(max=nb - 1))
    tgt = torch.where(positions[:, None] >= 0, tgt, num_blocks).reshape(-1)
    offs = (pc % bs).reshape(-1)
    for layer, (k_new, v_new) in enumerate(fresh):
        _, h, _, d_ = k_new.shape
        scatter_pool(pool, layer, 0, tgt, offs,
                     k_new.transpose(1, 2).reshape(-1, h, d_))
        scatter_pool(pool, layer, 1, tgt, offs,
                     v_new.transpose(1, 2).reshape(-1, h, d_))
    return pool


def build_spec_verify_fn(target, t_params, draft, d_params, block_size,
                         num_blocks, k):
    """The speculative decode-tick program body: draft-propose + target-
    verify in ONE dispatch per tick.

    ``fn(t_pool, d_pool, tokens, positions, t_tables, d_tables) ->
    (emitted, n_acc)`` with ``tokens (B,)`` each session's pending token,
    ``positions (B,)`` its ingest position (``-1`` = dead pad row), and
    block tables into the target and the draft pools (one BlockPool
    free-list, two geometry-matched buffers, both written in place):

    1. the DRAFT runs ``k + 1`` sequential paged decode steps from the
       pending token (the extra step writes the draft KV row for the
       all-accepted case), proposing greedy tokens ``d_1..d_k``;
    2. the TARGET verifies ``[x_0, d_1..d_k]`` at positions ``p..p+k`` in
       one batched multi-position paged pass, giving greedy tokens
       ``g_1..g_{k+1}``;
    3. per row, ``n_acc - 1`` is the length of the longest prefix with
       ``d_i == g_i``, so row ``b`` commits ``emitted[b, :n_acc[b]]``:
       between 1 and ``k + 1`` tokens, each what plain decode would emit.

    Rows past the committed point hold KV of rejected continuations and
    are overwritten by the next tick's chunk before any query's mask can
    reach them.  The batch bucket, the two table buckets and ``k`` key the
    graph; acceptance lengths are data."""
    bs = block_size
    kp1 = k + 1

    @torch.no_grad()
    def fn(t_pool, d_pool, tokens, positions, t_tables, d_tables):
        dev = tokens.device
        live = positions >= 0
        # ---- draft proposes: kp1 sequential paged single-token steps
        # against one up-front gather; fresh rows accumulate in the
        # linear view and scatter back once at the end
        d_read = gather_pool(d_pool, d_tables)
        d_slots = torch.arange(d_tables.shape[1] * bs, device=dev)
        d_lins = [d_read(layer) for layer in range(len(draft.blocks))]
        d_fresh = [[] for _ in draft.blocks]
        chunk_toks = [tokens]
        tok = tokens
        for j in range(kp1):
            pos_j = torch.where(live, positions + j, -1)
            x = _embed(draft, tok[:, None], pos_j[:, None])
            own = (d_slots[None, :] == pos_j[:, None])[:, None, :, None]
            for layer, blk in enumerate(draft.blocks):
                q, k_new, v_new = blk._chunk_qkv(x)
                k_lin, v_lin = insert_row(d_pool, *d_lins[layer], k_new,
                                          v_new, own)
                d_lins[layer] = (k_lin, v_lin)
                o = _paged_attend(blk, x, q, k_lin, v_lin, pos_j[:, None],
                                  d_slots, None)
                x = blk._attn_mlp_tail(x, o)
                d_fresh[layer].append((k_new, v_new))
            if j < k:                  # step k only writes its KV row
                x = draft.ln_f(x)
                tok = torch.argmax(_head(draft, x)[:, 0], dim=-1)
                chunk_toks.append(tok)
        chunk = torch.stack(chunk_toks, dim=1)            # (B, kp1)
        _scatter_chunk(
            d_pool, [(torch.cat([f[0] for f in per], 2),
                      torch.cat([f[1] for f in per], 2)) for per in d_fresh],
            d_tables, positions, bs, num_blocks, kp1)
        del d_lins
        # ---- target verifies the whole chunk in one paged pass
        t_read = gather_pool(t_pool, t_tables)
        slots = torch.arange(t_tables.shape[1] * bs, device=dev)
        q_pos = torch.where(
            live[:, None],
            positions[:, None] + torch.arange(kp1, device=dev)[None, :], -1)
        x = _embed(target, chunk, q_pos)
        d = slots[None, :] - positions[:, None]             # (B, S)
        own = ((d >= 0) & (d < kp1) & live[:, None])[:, None, :, None]
        src = d.clamp(0, k)[:, None, :, None]
        t_fresh = []
        for layer, blk in enumerate(target.blocks):
            q, k_new, v_new = blk._chunk_qkv(x)         # (B, H, kp1, D)
            idx = src.expand(-1, k_new.shape[1], -1, k_new.shape[3])
            k_lin, v_lin = insert_row(t_pool, *t_read(layer),
                                      torch.gather(k_new, 2, idx),
                                      torch.gather(v_new, 2, idx), own)
            o = _paged_attend(blk, x, q, k_lin, v_lin, q_pos, slots, None)
            x = blk._attn_mlp_tail(x, o)
            t_fresh.append((k_new, v_new))
        x = target.ln_f(x)
        emitted = torch.argmax(_head(target, x), dim=-1)  # (B, kp1)
        # accepted = the leading run of draft tokens the target agrees with
        agree = (chunk[:, 1:] == emitted[:, :k]).to(torch.int64)
        n_acc = torch.cumprod(agree, dim=1).sum(dim=1) + 1
        _scatter_chunk(t_pool, t_fresh, t_tables, positions, bs, num_blocks,
                       kp1)
        return emitted, n_acc
    return fn
