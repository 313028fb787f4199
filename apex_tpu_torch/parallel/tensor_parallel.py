"""Tensor (model) parallelism over a mesh axis: Megatron-style sharded
linears, the PyTorch counterpart of ``apex_tpu/parallel/tensor_parallel.py``.

One process a rank, as for data parallelism: an axis name resolves to a
process group through :mod:`apex_tpu_torch.parallel.mesh`, and the JAX
``psum``/``all_gather`` are ``torch.distributed`` collectives on it (NCCL
on the card, gloo on the CPU; on the card they run inside the train step's
CUDA graph).  With no process group the axis is a world of one and every
collective is the identity.

* ``column_parallel_linear``: W split along the OUTPUT features; each rank
  computes ``x @ W_i^T`` for its slice, no communication, an optional
  all-gather for the full output.
* ``row_parallel_linear``: W split along the INPUT features; the partial
  products are summed over the axis and the bias is added once, after the
  sum.

Gradients follow Megatron's conjugate pair, as ``torch.autograd.Function``s:
``copy_to_tp_region`` (identity forward, all-reduce backward) enters a
region, ``reduce_from_tp_region`` (all-reduce forward, identity backward)
leaves it.  Weights stay whole and replicated: each rank reads its block as
a view indexed by its rank on the axis (``_shard_dim``), so checkpoints,
``from_jax_state_dict`` and the initialisation do not depend on the shard
count.  A sharded weight's gradient is then block-sparse on each rank (its
block filled, the rest zero), and ``make_train_step(tp_axis=...)`` sums
exactly the model's ``tp_sharded_params()`` over the axis; replicated
parameters come out whole and equal on every rank.

The module forms (``ColumnParallelLinear`` / ``RowParallelLinear``) hold
their LOCAL shard, cut from the same full-size deterministic
initialisation as an unsharded ``torch.nn.Linear`` drawn from the same
generator state.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..kernels.dispatch import resolve_device
from .mesh import Axis, resolve

_f32 = torch.float32


def _live() -> bool:
    """Whether collectives run: without ``torch.distributed`` every axis is
    a world of one."""
    return dist.is_available() and dist.is_initialized()


def all_reduce(x, ax: Axis, op=None):
    """The sum (or ``op``) of ``x`` over ``ax``, a new tensor."""
    if not _live():
        return x
    out = x.clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=ax.group)
    return out


def all_gather_last(x, ax: Axis):
    """Every rank's ``x`` concatenated along the last dim, in rank order."""
    if not _live():
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=-1)


def all_to_all(x, ax: Axis, split_dim, concat_dim):
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)``: ``x`` cut into ``ax.size`` chunks along ``split_dim``,
    chunk j sent to rank j, the chunks received concatenated along
    ``concat_dim`` in rank order."""
    n = ax.size
    if not _live():
        return x
    shape = list(x.shape)
    if shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{shape[split_dim]} is not divisible by {n}")
    chunks = x.reshape(*shape[:split_dim], n, shape[split_dim] // n,
                       *shape[split_dim + 1:]).movedim(split_dim, 0)
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=ax.group)
    shape[split_dim] //= n
    shape[concat_dim] *= n
    return out.movedim(0, concat_dim).reshape(shape)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.width = ax, x.shape[-1]
        return all_gather_last(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.ax.index * ctx.width, ctx.width), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.args = (ax, concat_dim, split_dim)
        return all_to_all(x, ax, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, *ctx.args), None, None, None


def all_to_all_grad(x, axis_name, split_dim, concat_dim):
    """:func:`all_to_all` under autograd: its backward is the inverse
    all-to-all."""
    return _AllToAll.apply(x, resolve(axis_name), split_dim, concat_dim)


def copy_to_tp_region(x, axis_name):
    """Megatron's ``f``: identity forward, all-reduce backward.  A
    replicated activation entering a column-parallel region meets another
    weight shard on each rank, so each rank's backward holds only its
    shard's share of ``d loss / d x``; the all-reduce assembles it, or
    every parameter upstream of the region would get a partial
    gradient."""
    return _CopyToTP.apply(x, resolve(axis_name))


def reduce_from_tp_region(x, axis_name):
    """Megatron's ``g``: all-reduce forward, IDENTITY backward, so the
    replicated cotangent passes through unscaled and replicated
    parameters' gradients come out whole and equal on every rank."""
    return _ReduceFromTP.apply(x, resolve(axis_name))


def column_parallel_linear(x, weight_shard, bias_shard=None,
                           axis_name=None, gather_output=False):
    """x (..., in); weight_shard (out/n, in); bias_shard (out/n,).
    Returns (..., out/n), or (..., out) when ``gather_output`` (an
    all-gather whose backward takes this rank's slice)."""
    y = torch.matmul(x, weight_shard.t())
    if bias_shard is not None:
        y = y + bias_shard
    if gather_output:
        y = _GatherLast.apply(y, resolve(axis_name))
    return y


def row_parallel_linear(x_shard, weight_shard, bias=None, axis_name=None):
    """x_shard (..., in/n); weight_shard (out, in/n); bias (out,), added
    once after the reduction (the ``g`` operator).  Returns the full
    (..., out), replicated."""
    y = reduce_from_tp_region(torch.matmul(x_shard, weight_shard.t()),
                              axis_name)
    if bias is not None:
        y = y + bias
    return y


def _shard_dim(full, axis_name, dim):
    """This rank's block of ``full`` along ``dim`` (a view)."""
    ax = resolve(axis_name)
    n = ax.size
    if full.shape[dim] % n:
        raise ValueError(
            f"tensor-parallel shard: dimension {dim} of size "
            f"{full.shape[dim]} is not divisible by the '{axis_name}' "
            f"axis size {n}")
    size = full.shape[dim] // n
    return full.narrow(dim, ax.index * size, size)


def _shard_rows(full, axis_name):
    return _shard_dim(full, axis_name, 0)


def _shard_cols(full, axis_name):
    return _shard_dim(full, axis_name, 1)


def vocab_parallel_embedding(ids, emb_full, axis_name):
    """The Megatron vocab-parallel lookup: the ``(V, E)`` table row-sharded
    over ``axis_name``; each rank looks up only the ids in its vocab range
    and the partial rows combine through the ``g`` operator.  Its
    gradient lands in the rank's own vocab block, so the table belongs in
    ``tp_sharded_params()``."""
    shard = _shard_rows(emb_full, axis_name)   # validates divisibility
    v_loc = shard.shape[0]
    off = resolve(axis_name).index * v_loc
    local = ids - off
    valid = (local >= 0) & (local < v_loc)
    rows = torch.nn.functional.embedding(local.clamp(0, v_loc - 1), shard)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    return reduce_from_tp_region(rows, axis_name)


def vocab_parallel_logits(x, emb_full, axis_name):
    """The tied LM head under vocab parallelism: ``x (..., E)`` against the
    row-sharded table gives VOCAB-SHARDED logits ``(..., V/n)``; the whole
    ``(..., V)`` never exists on a rank.  Feed them to
    :func:`vocab_parallel_cross_entropy`.  ``x`` enters through the ``f``
    operator."""
    x = copy_to_tp_region(x, axis_name)
    shard = _shard_rows(emb_full, axis_name)
    return torch.matmul(x, shard.t().to(x.dtype))


def vocab_parallel_cross_entropy(logits_shard, targets, axis_name,
                                 reduction="mean"):
    """Cross entropy over vocab-sharded logits (Megatron's parallel cross
    entropy): the global max (a ``MAX`` all-reduce of a detached value, as
    JAX's ``pmax`` sees only a stop-gradient one), the sum of exponentials
    and the target logit combined through ``g`` operators, so the backward
    is ``softmax_local - onehot_local`` on each rank with no gather of the
    vocab.  ``logits_shard (..., V/n)``, integer ``targets (...)`` GLOBAL
    ids."""
    ax = resolve(axis_name)
    v_loc = logits_shard.shape[-1]
    off = ax.index * v_loc
    lf = logits_shard.to(_f32)
    m = all_reduce(lf.detach().amax(dim=-1), ax, op=dist.ReduceOp.MAX)
    sumexp = reduce_from_tp_region(
        torch.exp(lf - m[..., None]).sum(dim=-1), axis_name)
    lse = torch.log(sumexp) + m
    local = targets.long() - off
    valid = (local >= 0) & (local < v_loc)
    tl = torch.gather(lf, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    tl = reduce_from_tp_region(torch.where(valid, tl, torch.zeros_like(tl)),
                               axis_name)
    losses = lse - tl
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses


def tp_attn_begin(axis_name, heads, inputs, row_weights, col_weights):
    """The TP entry of the attention functionals
    (``contrib/multihead_attn/attn_funcs.py``), in one place for the self
    and encoder-decoder paths: the ``f`` operator on every input stream,
    the head divisibility check and the weight blocks.  Returns ``(inputs,
    heads_local, row_shards, col_shards)``: ``row_weights`` cut along dim 0
    (head-major projection rows), ``col_weights`` along dim 1 (the
    row-parallel output projections); the exit is
    :func:`reduce_from_tp_region` on the projected output.  Attention
    dropout's seed is folded with the rank's index on the axis at the call
    site, so each head shard draws a stream of its own."""
    inputs = [copy_to_tp_region(x, axis_name) for x in inputs]
    n = resolve(axis_name).size
    if heads % n:
        raise ValueError(
            f"tensor parallelism: heads ({heads}) not divisible by the "
            f"'{axis_name}' axis size ({n})")
    rows = [_shard_dim(w, axis_name, 0) for w in row_weights]
    cols = [_shard_dim(w, axis_name, 1) for w in col_weights]
    return inputs, heads // n, rows, cols


def tp_ffn(x, w1, b1, w2, b2, axis_name, activation=None):
    """Column -> row feed-forward over WHOLE (replicated) weights: each rank
    takes its block, applies ``activation`` on the feature-sharded hidden,
    and the row layer's all-reduce is the pair's one collective.  The
    model families' ``tp_axis`` MLPs are built on it."""
    x = copy_to_tp_region(x, axis_name)
    h = column_parallel_linear(
        x, _shard_rows(w1, axis_name),
        None if b1 is None else _shard_rows(b1, axis_name))
    if activation is not None:
        h = activation(h)
    return row_parallel_linear(h, _shard_cols(w2, axis_name), b2, axis_name)


def _full_linear(in_features, out_features, bias, device, dtype):
    """An unsharded ``torch.nn.Linear``'s initial weight and bias, drawn
    from the global generator as that layer draws them."""
    ref = nn.Linear(in_features, out_features, bias=bias,
                    device=resolve_device(device), dtype=dtype)
    return ref.weight.data, None if ref.bias is None else ref.bias.data


class ColumnParallelLinear(nn.Module):
    """``nn.Linear`` with the weight split along the output features: holds
    this rank's rows of the full-size initialisation (so the sharded pair
    reproduces the unsharded layer drawn from the same generator state)."""

    def __init__(self, in_features, out_features, axis_name, bias=True,
                 gather_output=False, device=None, dtype=torch.float32):
        super().__init__()
        w, b = _full_linear(in_features, out_features, bias, device, dtype)
        self.weight = nn.Parameter(_shard_rows(w, axis_name).clone())
        self.bias = None if b is None else nn.Parameter(
            _shard_rows(b, axis_name).clone())
        self.axis_name = axis_name
        self.gather_output = gather_output

    def forward(self, x):
        return column_parallel_linear(x, self.weight, self.bias,
                                      self.axis_name, self.gather_output)


class RowParallelLinear(nn.Module):
    """``nn.Linear`` with the weight split along the input features; takes
    its input feature-sharded (a column layer's output) and holds this
    rank's columns of the full-size initialisation and the whole bias."""

    def __init__(self, in_features, out_features, axis_name, bias=True,
                 device=None, dtype=torch.float32):
        super().__init__()
        w, b = _full_linear(in_features, out_features, bias, device, dtype)
        self.weight = nn.Parameter(_shard_cols(w, axis_name).clone())
        self.bias = None if b is None else nn.Parameter(b.clone())
        self.axis_name = axis_name

    def forward(self, x_shard):
        return row_parallel_linear(x_shard, self.weight, self.bias,
                                   self.axis_name)
