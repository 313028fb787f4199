"""ZeRO sharding of the fused step's state, the PyTorch counterpart of
``apex_tpu/parallel/zero.py``.

The JAX package jits the step under a ``Mesh`` with the fp32 masters and
optimizer slots annotated sharded over the data axis, and GSPMD derives the
collectives.  The port runs one process per card (as
``parallel/distributed.py`` says for DDP) and writes the collectives out,
on ``torch.distributed`` (NCCL on the card, gloo on the CPU):

* The placement is the JAX rule (:func:`zero_state_sharding`): a tensor
  whose dim 0 is at least ``n`` and divisible by ``n`` (the ranks of the
  mesh axis) is sharded on dim 0, ``Shard(0)``; anything else is
  ``Replicate()`` (torch's own placements).  Rank ``r`` holds rows ``[r·d0/n,
  (r+1)·d0/n)`` of each sharded master and slot as a contiguous tensor.
* :class:`ZeroTrainStep` takes the *global* batch and keeps this rank's
  rows of each batch leaf by the same rule (dim 0 where ``n`` divides it,
  else broadcast; under accumulation the rows of each microbatch's block,
  so every microbatch is the JAX step's).  Each rank runs the forward and
  backward of its rows.  At the end of the window the gradients are
  reduce-scattered (``reduce_scatter_tensor``, then divided by ``n``) into
  the master shards, and the replicated leaves' are all-reduced (one
  flattened exchange a dtype); the overflow flag is max-reduced over the
  group before the update, so every rank skips the same windows; the
  update is the step's own multi-tensor kernels over the shard lists.  The
  returned loss is the mean of the ranks' losses.
* The loss: the JAX package's global-view program runs ``loss_fn`` once
  over the global batch; here each rank runs it over its rows and the
  gradients and the loss are averaged over the ranks.  The two agree when
  the loss is a mean over rows with equal weight for every row (the
  cross entropies' default), since the ranks hold equal row counts.  They
  do not for another reduction: under a summed loss the step's gradients
  and loss are ``1/n`` of the JAX step's, and under a mean over a mask
  (or a token count) that differs between ranks each rank's rows are
  weighted by its own count.  Such a loss is divided by the global count
  (or multiplied by ``n`` for a sum) by its caller.
* Stage 1 all-gathers the updated masters (cast to the half dtype first)
  into the replicated half copies.  Where a parameter has no half copy
  (``half_dtype=None``, BatchNorm's under ``keep_batchnorm_fp32``) its
  forward reads the sharded master, which is gathered into a copy that
  lives only inside the step.  Stage 3 keeps the half copies sharded too
  and gathers each at the top of the step into such a copy (the JAX
  package gathers each just ahead of its use): the whole copy exists only
  while the step runs, since ZeRO's promise is the footprint between
  steps.  Under accumulation the copy is gathered once, at the top of the
  window, and every microbatch reads it: the shards do not change within
  a window, so one collective pair a window (the gather and the
  reduce-scatter) is all the step needs.  The executor's ``gather``
  overlap knob is accepted and has nothing to overlap here, as the DDP
  knobs of the JAX step have none; a schedule that gathers a microbatch
  ahead waits for a machine with more than one card to show that it
  pays.  Stage 0 replicates everything.
* BatchNorm: the JAX global-view program normalises over the global batch.
  Here each plain ``_BatchNorm`` of the model runs, inside the step and
  while the group has more than one rank, the cross-rank merge of
  ``parallel.SyncBatchNorm`` (``nn.functional.batch_norm`` over the
  group), so the statistics are the global batch's; a ``SyncBatchNorm``
  keeps its own group.
* With one rank the step is the plain step, bit for bit: a reduce-scatter
  and an all-gather over one rank are copies.

On the card every collective of the window runs inside the step's CUDA
graph (``runtime.executor``, kind ``"zero_train_step"``); a group that is
not NCCL raises.  The memory win and the cost of the exchange across cards
need a machine with more than one card to measure.
"""
from __future__ import annotations

import itertools
import warnings

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.nn.modules.batchnorm import _BatchNorm
from torch.utils._pytree import tree_leaves, tree_map

from .._unported import PARALLEL, refuse

#: per-wrapper token in the program's static key
_ZERO_TOKENS = itertools.count()

# torch 2.13 deprecates the *_tensor collectives for *_single spellings
# that older releases (the card's 2.11) lack; the calls stay as they are
for _name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
    warnings.filterwarnings(
        "ignore", message=f".*{_name}` is deprecated", category=FutureWarning)

_f32 = torch.float32


def _shardable(x, n) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 1 \
        and x.shape[0] >= n and x.shape[0] % n == 0


def _leaf_sharding(x, n):
    return Shard(0) if _shardable(x, n) else Replicate()


def default_zero_mesh(zero_axis: str, device):
    """The default ZeRO mesh: a 1-D ``DeviceMesh`` over
    ``torch.distributed``'s default group, its dim named ``zero_axis`` (the
    JAX default is a mesh over every device; torch has no ambient mesh
    context to take one from).  None without ``torch.distributed``: a
    world of this one process."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type,
                            (dist.get_world_size(),),
                            mesh_dim_names=(zero_axis,))


def check_zero_mesh(mesh, zero_axis: str) -> None:
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if zero_axis not in names:
        raise ValueError(f"zero_axis {zero_axis!r} is not an axis of "
                         f"zero_mesh (axes: {names})")


def _mesh_group(mesh, axis):
    """``(group, n, rank)`` of ``axis`` of ``mesh``; ``(None, 1, 0)`` for no
    mesh."""
    if mesh is None:
        return None, 1, 0
    check_zero_mesh(mesh, axis)
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def zero_state_sharding(state, mesh, axis: str = "data",
                        param_shard: bool = False, stage: int = None):
    """A ``StepState``-shaped tree of torch placements: the fp32 masters and
    optimizer slots ``Shard(0)`` over ``axis`` of ``mesh`` where dim 0 is at
    least the axis size and divisible by it; the half copies
    ``Replicate()`` (stage 1) or sharded the same way (``param_shard=True``,
    stage 3); buffers, scaler, step count and telemetry ``Replicate()``.
    ``stage=0`` replicates everything.  ``mesh`` None is a world of one."""
    if stage is None:
        stage = 3 if param_shard else 1
    n = _mesh_group(mesh, axis)[1]
    rep = Replicate()
    if stage == 0:
        return tree_map(lambda x: None if x is None else rep, state)
    return state._replace(
        master_params=[_leaf_sharding(m, n) for m in state.master_params],
        model_params=[None if mp is None
                      else (_leaf_sharding(mp, n) if stage == 3 else rep)
                      for mp in state.model_params],
        opt_state={k: [_leaf_sharding(s, n) for s in v]
                   for k, v in state.opt_state.items()},
        scaler=tree_map(lambda _: rep, state.scaler),
        stats=[rep for _ in state.stats],
        telem=(None if state.telem is None
               else tree_map(lambda _: rep, state.telem)),
        step=rep)


def _rows(t, n, r):
    k = t.shape[0] // n
    return t[r * k:(r + 1) * k]


class _Collectives:
    """The exchange of one ZeRO step over ``group`` (``n`` ranks; no group
    and one rank without ``torch.distributed``): what
    ``training.step.apply_fused_update`` calls through its ``shards``
    hooks, and the gathers and reductions of the window."""

    def __init__(self, group, n, sharded, stage, live):
        self.group, self.n = group, n
        self.sharded = sharded          # per parameter
        self.stage = stage
        self.live = live                # a process group to talk over

    def gather(self, shard):
        """The whole tensor of ``shard``."""
        if not self.live:
            return shard
        full = shard.new_empty((shard.shape[0] * self.n,) + shard.shape[1:])
        dist.all_gather_into_tensor(full, shard.contiguous(),
                                    group=self.group)
        return full

    def exchange(self, grads):
        """The window's gradients, averaged over the group: the sharded
        parameters' reduce-scattered into this rank's rows, the others
        all-reduced (one flattened exchange a dtype)."""
        if not self.live:
            return grads
        from ..training.step import dp_exchange
        out = list(grads)
        rep = [i for i, s in enumerate(self.sharded) if not s]
        for i, s in enumerate(self.sharded):
            if not s:
                continue
            g = grads[i].contiguous()
            shard = g.new_empty((g.shape[0] // self.n,) + g.shape[1:])
            dist.reduce_scatter_tensor(shard, g, group=self.group)
            out[i] = shard / self.n if self.n > 1 else shard
        if rep:
            for i, g in zip(rep, dp_exchange([grads[i] for i in rep],
                                             self.group, self.n, 1.0,
                                             False)):
                out[i] = g
        return out

    def mean_loss(self, loss):
        if not self.live:
            return loss
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=self.group)
        return loss / self.n if self.n > 1 else loss

    def flag(self, flag):
        """The overflow flag, the group's maximum."""
        if self.live:
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return flag

    def halves(self, state):
        """The half copies re-made from the updated masters: stage 1
        all-gathers each sharded master (cast first) into its replicated
        copy; stages 0 and 3 cast in place, shard for shard."""
        pairs = [(i, h, m) for i, (h, m) in enumerate(
            zip(state.model_params, state.master_params)) if h is not None]
        with torch.no_grad():
            local = [(h, m) for i, h, m in pairs
                     if not (self.stage == 1 and self.sharded[i]
                             and self.live)]
            if local:
                torch._foreach_copy_([h for h, _ in local],
                                     [m for _, m in local])
            if self.stage == 1 and self.live:
                for i, h, m in pairs:
                    if self.sharded[i]:
                        dist.all_gather_into_tensor(h, m.to(h.dtype),
                                                    group=self.group)

    def grad_norm(self, master_grads):
        """The global L2 norm of the gradients the update took (shards of
        the sharded parameters, whole ones of the others)."""
        from ..observe.telemetry import global_grad_norm
        if not self.live or self.n == 1:
            return global_grad_norm(master_grads)
        norms = torch._foreach_norm(master_grads, 2, dtype=_f32)

        def squares(sharded):
            picked = [v for v, s in zip(norms, self.sharded) if s == sharded]
            return torch.stack(picked).square().sum() if picked \
                else norms[0].new_zeros(())
        part = squares(True)
        dist.all_reduce(part, group=self.group)
        return torch.sqrt(part + squares(False))


class _GlobalBatchNorm:
    """Inside the step, each plain ``_BatchNorm`` of the model normalises
    with the group's statistics (``parallel.SyncBatchNorm``'s merge), as
    the JAX global-view program normalises over the global batch: its
    ``forward`` is swapped for the merge on entry and put back on exit."""

    def __init__(self, model, group, n):
        from .sync_batchnorm import SyncBatchNorm
        self.mods = [] if n == 1 else [
            m for m in model.modules()
            if isinstance(m, _BatchNorm) and not isinstance(m, SyncBatchNorm)]
        self.group = group

    def _forward(self, m):
        from ..nn import functional as F

        def forward(x):
            if not m.training:
                return type(m).forward(m, x)
            m._check_input_dim(x)
            track = m.track_running_stats
            if track:
                m.num_batches_tracked.add_(1)
            momentum = m.momentum
            if momentum is None:    # a cumulative average, as torch's
                momentum = 1.0 / float(m.num_batches_tracked)
            y, rm, rv = F.batch_norm(
                x, m.running_mean if track else None,
                m.running_var if track else None, m.weight, m.bias,
                training=True, momentum=momentum, eps=m.eps, channel_axis=1,
                process_group=self.group)
            if track:
                with torch.no_grad():
                    m.running_mean.copy_(rm)
                    m.running_var.copy_(rv)
            return y
        return forward

    def __enter__(self):
        for m in self.mods:
            m.forward = self._forward(m)
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            del m.forward
        return False


class ZeroTrainStep:
    """Wrap a :class:`~apex_tpu_torch.training.step.TrainStep` built
    without ``axis_name``: its state is laid out by
    :func:`zero_state_sharding` over ``axis`` of ``mesh`` (a
    ``DeviceMesh``; None for its default, :func:`default_zero_mesh`), and
    ``step(*global_batch) -> loss`` runs the window described in the module
    docstring through the executor.  ``param_shard=True`` is stage 3.

    The base hands its state over: the replicated leaves are shared, the
    sharded ones are this rank's rows, copied, and ``base.state`` is this
    step's state from then on, so the whole tensors are freed.  The JAX
    wrapper refuses a base that donates its buffers, since it would hand
    XLA buffers the wrapper still holds.  The port's steps always update
    their state in place (``runtime.executor.DonationPolicy``), so that
    refusal keys on an explicit ``donate_state=True`` at the base's build,
    the request that the base own its buffers; the default ``"auto"`` is
    the JAX package's ``donate_state=False`` here.  ``donate`` is taken for
    the JAX signature: this step's state is always updated in place.

    ``loss_fn`` runs over this rank's rows and the ranks' gradients are
    averaged: the JAX step's global-batch loss only where the loss is a
    mean over rows with equal weight for every row (see the module
    docstring for a summed or a masked loss)."""

    def __init__(self, step, mesh, axis: str = "data",
                 donate: bool = True, param_shard: bool = False,
                 stage: int = None, plan=None):
        raw = getattr(step, "_raw_step_fn", None)
        if raw is None:
            raise ValueError(
                "ZeroTrainStep needs a TrainStep from make_train_step "
                "(no _raw_step_fn found)")
        if getattr(step, "_axis_name", None) is not None:
            raise ValueError(
                "ZeroTrainStep needs a step built WITHOUT axis_name — it "
                "takes the global batch and exchanges over its mesh axis "
                "itself (the base's own exchange would average twice)")
        if getattr(step, "_donate_state", False):
            raise ValueError(
                "ZeroTrainStep needs a step built without an explicit "
                "donate_state=True (the JAX package's donate_state=False) "
                "— this wrapper owns the state")
        if step._flat_meta is not None:
            raise ValueError("ZeroTrainStep excludes flat_master: ZeRO "
                             "shards exactly the buffers it stacks")
        if plan is not None:
            refuse("ZeroTrainStep(plan=): the parallelism planner", PARALLEL)
        parts = step._parts
        if mesh is None:
            mesh = default_zero_mesh(axis, parts.device)
        self._base = step
        self.mesh = mesh
        self.axis = axis
        self.stage = (3 if param_shard else 1) if stage is None else stage
        if self.stage not in (0, 1, 3):
            raise ValueError(f"zero_stage must be 0, 1 or 3, got "
                             f"{self.stage!r}")
        self.param_shard = self.stage == 3
        self.plan = plan
        self.group, self.n, self.rank = _mesh_group(mesh, axis)
        live = mesh is not None
        if live:
            from ..training.step import check_backend
            check_backend(self.group, parts.device)
        from ..optimizers import FusedLAMB, FusedNovoGrad
        if self.n > 1 and isinstance(step.optimizer,
                                     (FusedLAMB, FusedNovoGrad)):
            refuse(f"ZeroTrainStep with {type(step.optimizer).__name__} "
                   f"over {self.n} ranks (its per-tensor norms over a "
                   f"shard)", PARALLEL)
        self.shardings = zero_state_sharding(step.state, mesh, axis,
                                             stage=self.stage)
        st = step.state
        sharded = [self.stage != 0 and _shardable(m, self.n)
                   for m in st.master_params]
        self._coll = _Collectives(self.group, self.n, sharded, self.stage,
                                  live)

        def lay(t, placement):
            if isinstance(placement, Shard) and self.n > 1:
                return _rows(t, self.n, self.rank).clone()
            return t
        self.state = tree_map(lay, st, self.shardings)
        # the global shape of every leaf, for load_state and checkpoints
        self._global = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
            if isinstance(t, torch.Tensor) else t, st)
        step.state = self.state
        self._bn = _GlobalBatchNorm(step.model, self.group, self.n)
        self._token = next(_ZERO_TOKENS)
        self._program_obj = None
        self.calls = 0
        self._guard = None
        self._telemetry = parts.telemetry
        self._drain_every = step._drain_every

    # -- the window ---------------------------------------------------
    def _leaves(self, state):
        """The leaves the window differentiates, one set for every
        microbatch: a half copy or master where it is whole, else its copy
        gathered at the top of the window."""
        c, leaves = self._coll, []
        for i, (h, m) in enumerate(zip(state.model_params,
                                       state.master_params)):
            src = m if h is None else h
            if c.sharded[i] and (h is None or self.stage == 3):
                src = c.gather(src)
            leaves.append(src.detach().requires_grad_(True))
        return leaves

    def _body(self, state, *batch):
        parts = self._base._parts
        from ..training.step import apply_fused_update
        with self._bn:
            loss, grads = parts.window(state.scaler.loss_scale,
                                       self._leaves(state), batch)
        grads = self._coll.exchange(grads)
        loss = self._coll.mean_loss(loss)
        apply_fused_update(state, grads, parts.opt_update, loss=loss,
                           shards=self._coll, **parts.update_kw)
        return loss

    def _seed(self, call_index):
        self._base._parts.seed_calls(call_index,
                                     self.rank if self.n > 1 else None)

    def _raw_step_fn(self, state, call_index, *batch):
        """The un-captured step on a global batch: ``(state, call_index,
        *batch) -> (state, loss)``, updating ``state`` in place."""
        self._seed(call_index)
        return state, self._body(state, *self._local_batch(batch))

    @property
    def _program(self):
        """The window :class:`~apex_tpu_torch.runtime.executor.Program`,
        kind ``"zero_train_step"``, keyed on this wrapper, K, the stacking,
        telemetry and the stage (the batch signature completes the key);
        the state is held."""
        if self._program_obj is None:
            from ..runtime import executor as _executor
            parts = self._base._parts
            self._program_obj = _executor.Program(
                "zero_train_step",
                (self._token, parts.k_acc, parts.accum_stacked,
                 parts.telemetry, self.stage),
                self._body, donate_argnums=(0,), generators=parts.gens)
        return self._program_obj

    def _local_batch(self, batch):
        """This rank's rows of the global batch.  An element whose every
        leaf shares the model input's leading dim (its batch dim; dim 1
        under ``accum_stacked``) is split into ``n`` equal row blocks where
        ``n`` divides that dim, as the JAX rule places a batch on its mesh;
        anything else (a scalar, a per-step constant) is broadcast, since
        here the split is the data each rank computes on.  Under
        accumulation a batch of K blocks whose rows split over the ranks
        gives each rank its rows of every block, so each microbatch is the
        global step's."""
        n, r = self.n, self.rank
        if n == 1:
            return tuple(batch)
        parts = self._base._parts
        k, stacked = parts.k_acc, parts.accum_stacked
        dim = 1 if stacked else 0
        lead = [a for a in tree_leaves(batch[0])
                if isinstance(a, torch.Tensor) and a.dim() > dim]
        if not lead or lead[0].shape[dim] % n:
            return tuple(batch)
        b0 = lead[0].shape[dim]

        def splittable(b):
            leaves = tree_leaves(b)
            return bool(leaves) and all(
                isinstance(a, torch.Tensor) and a.dim() > dim
                and a.shape[dim] == b0 for a in leaves)

        def leaf(a):
            if stacked:
                return _rows(a.transpose(0, 1), n, r).transpose(0, 1)
            if k > 1 and b0 % (k * n) == 0:
                m = b0 // k
                return a.reshape((k, m) + a.shape[1:])[
                    :, r * (m // n):(r + 1) * (m // n)].reshape(
                    (b0 // n,) + a.shape[1:])
            return _rows(a, n, r)
        return tuple(tree_map(leaf, b) if i == 0 or splittable(b) else b
                     for i, b in enumerate(batch))

    def __call__(self, *batch):
        from ..runtime import executor as _executor
        local = self._local_batch(batch)
        self._seed(self.calls)
        loss = _executor.executor.submit(self._program, (self.state,) + local,
                                         step=self.calls + 1)
        self.calls += 1
        if self._guard is not None:
            self._guard.observe(self.state.scaler.overflow)
        if self._telemetry and self._drain_every \
                and self.calls % self._drain_every == 0:
            self.drain_telemetry()
        return loss

    # -- the surface --------------------------------------------------
    def drain_telemetry(self):
        """Read the on-device telemetry to the host and reset it (see
        :func:`apex_tpu_torch.runtime.executor.drain_telemetry`)."""
        from ..runtime import executor as _executor
        return _executor.drain_telemetry(self)

    def graph_stats(self):
        from ..runtime import executor as _executor
        return _executor.graph_stats(self._program)

    @property
    def last_step_skipped(self):
        return self.state.scaler.overflow

    def _whole(self, t, placement):
        """The whole tensor of a leaf (a gather over the group where it is
        sharded; every rank must call)."""
        if isinstance(placement, Shard) and self.n > 1:
            return self._coll.gather(t)
        return t

    def _checkpoint_state(self):
        """The state with every leaf whole (a collective: every rank calls
        it), as the JAX package's saved arrays are."""
        return tree_map(self._whole, self.state, self.shardings)

    @property
    def _writes_checkpoint(self) -> bool:
        """Rank 0 writes a checkpoint of the whole state; the others wait."""
        return self.rank == 0

    def _checkpoint_barrier(self):
        if self.mesh is not None and self.n > 1:
            dist.barrier(group=self.group)

    def _restore_target(self):
        """Empty whole leaves on the host, to restore a checkpoint into
        before :meth:`load_state` takes this rank's rows."""
        return tree_map(lambda g: torch.empty(g.shape, dtype=g.dtype)
                        if isinstance(g, torch.Tensor) else g, self._global)

    def sync_to_objects(self):
        """Write the state back into the model: every parameter gets its
        whole model-dtype value, gathered where it is sharded (every rank
        must call)."""
        whole = self._checkpoint_state()
        base = self._base
        with torch.no_grad():
            for p, m, h in zip(base._params, whole.master_params,
                               whole.model_params):
                p.data = m if h is None else h

    def load_state(self, host_state):
        """Copy a whole-leaf state (a checkpoint of this step, of a plain
        step, or of the JAX package's ZeRO step, whose saved arrays are
        whole) into this step's own tensors, each sharded leaf taking this
        rank's rows.  Shapes and dtypes are checked against the whole
        leaves first (``CheckpointReshardError`` naming the leaf)."""
        from ..runtime.resilience import (_as_tensor, _check_leaf,
                                          _check_structure, _dtype_name,
                                          _flatten, reshard_state)
        _check_structure(host_state, self.state, "state", "<state>")
        for (name, tgt), (_, src) in zip(_flatten(self._global),
                                         _flatten(host_state)):
            if isinstance(tgt, torch.Tensor):
                _check_leaf(name, src.shape, _dtype_name(src), tgt, "state",
                            "<state>")

        def rows(src, placement):
            if not hasattr(src, "shape"):
                return src
            src = _as_tensor(src)
            if isinstance(placement, Shard) and self.n > 1:
                return _rows(src, self.n, self.rank)
            return src
        reshard_state(tree_map(rows, host_state, self.shardings), self.state)
        return self

    def shard_sizes(self) -> int:
        """This rank's bytes of masters, optimizer slots and half copies
        (the ZeRO memory diagnostic: about 1/n of the replicated footprint
        for the shardable tensors; the half copies shrink only at stage
        3)."""
        st = self.state
        leaves = list(st.master_params) + [
            t for v in st.opt_state.values() for t in v] + [
            h for h in st.model_params if h is not None]
        return sum(t.numel() * t.element_size() for t in leaves)


__all__ = ["ZeroTrainStep", "zero_state_sharding", "default_zero_mesh",
           "check_zero_mesh"]
