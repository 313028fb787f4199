"""The fused train step, the PyTorch counterpart of
``apex_tpu/training/step.py`` (one device, dense).

One call runs the whole iteration on the card with no host round trip:
the O2-style forward on half copies of the parameters, the backward, the
unscale and overflow check into fp32 master gradients, the Adam, SGD or
LAMB update of the fp32 masters (Adam and SGD a hand-written kernel, which
skips itself on a set overflow flag; LAMB plain PyTorch, its new values
kept only where the flag is clear), the re-made half copies and the
loss-scale update.  The
state is device tensors updated in place, which is what buffer donation
buys the JAX package; the ``noop`` skip, the step count and the scaler
live on the device, so the step reads nothing back.

As the JAX step submits its compiled window through the runtime
executor, this step submits its body through
:mod:`apex_tpu_torch.runtime.executor`: on the card the first call of a
batch signature runs eagerly, the second captures the whole step (forward,
backward, update, scale update) as one CUDA graph and every later call
replays it; ``runtime.step_cache.stats()`` counts one compile and one
dispatch a window, as the JAX package's does.  The dropout generators are
the graph's own, seeded on the host before each call from ``rng_seed`` and
the call index, so a replay draws the masks an eager call draws.  The
un-captured step is kept as ``TrainStep._raw_step_fn(state, call_index,
*batch)``.

A restore (``TrainStep.load_state``,
``runtime.resilience.CheckpointManager.restore_resharded``) copies into
the state's own tensors, so the graph replays the restored state with no
recapture.  A ``runtime.resilience.BadStepGuard`` attached to the step
observes each call's device skip flag; the chaos hook ``train.step``
(``"nonfinite_grads"``) taints the batch before the submit, as in the JAX
step.

Gradient accumulation (``accum_steps``) and lr schedules (``lr_schedule``)
run as in the JAX step.  ``telemetry=True`` accumulates each window's loss,
global gradient norm, loss scale and overflow count on the device, inside
the captured step (``observe.telemetry``, ``StepState.telem``), and reads
them back every ``drain_every`` calls (``TrainStep.drain_telemetry``: one
device-to-host copy, then the accumulator reset in place).  Each call
heartbeats the stall watchdog through the executor.

Data parallelism runs one process per card, as
``parallel/distributed.py`` says for DDP: a step built with
``axis_name="data"`` is called by every rank on its own shard of the
batch, and after the window's fp32 accumulation it all-reduces the
gradients with the DDP knobs (``gradient_predivide_factor``,
``allreduce_always_fp32``) before the update, so every rank updates the
same masters and makes the same skip decision.  On the card that
all-reduce is captured inside the step's CUDA graph with the rest (the
JAX step leaves its program for ``shard_map`` instead).  ``flat_master``
stacks masters and slots per (group, shape, dtype) bucket and updates each
group's buckets in one kernel launch.  ``zero_sharding`` returns
:class:`apex_tpu_torch.parallel.zero.ZeroTrainStep`.  ``axis_name`` may
name any batch axes of an entered mesh
(``parallel.use_mesh``; ``"data"`` alone needs none) and ``tp_axis`` the
model's tensor-parallel axis: after the DP exchange the gradients of the
model's ``tp_sharded_params()`` (block-sparse on each rank, since every
rank reads its block of the whole weights) are summed over the TP group,
once a window, inside the same graph.  The planner (``parallel=``) is
owed to a later slice and refused with ``NotImplementedError``.  An
optimizer other than the four fused ones raises ``TypeError``, as in the
JAX step.
"""
from __future__ import annotations

import inspect
import itertools
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call
from torch.utils._pytree import tree_leaves, tree_map

from .. import ops
from ..amp.policy import disable_casts
from ..amp.scaler import ScalerState, update_scale_state
from ..kernels.dispatch import same_layout
from ..observe import telemetry as _obs_telemetry
from ..ops.multi_tensor import nonfinite_flag
from ..runtime import chaos as _chaos
from ..runtime import executor as _executor
from .._unported import PARALLEL, refuse
from ..parallel.mesh import names_of, resolve
from ..optimizers import FusedAdam, FusedLAMB, FusedNovoGrad, FusedSGD

_f32 = torch.float32


class StepState(NamedTuple):
    """Device-side training state."""
    master_params: list          # fp32 masters
    model_params: list           # half copies fed to forward, None where fp32
    opt_state: dict              # optimizer slots, name -> list
    scaler: ScalerState
    stats: list                  # the model's buffers (updated in place)
    step: torch.Tensor           # int32 scalar: applied optimizer steps
    #: observe.StepTelemetry accumulator, or None (telemetry off): None has
    #: no leaves, so a state and a checkpoint without telemetry are the
    #: six-field ones
    telem: Optional[object] = None


def dropout_seed(rng_seed: int, step: int) -> int:
    """The seed of a step's dropout generator: the pair (``rng_seed``,
    ``step``), both taken mod 2**32, through the splitmix64 finaliser, a
    bijection of 64 bits that spreads every input bit over the low 32 too
    (the CPU generator keeps only those; the card's keeps all 64).

    ``step`` is the index of the forward pass: the call index without
    gradient accumulation, and ``call_index * accum_steps + microbatch``
    with it, so each microbatch draws masks of its own and none repeats
    another call's."""
    m = (1 << 64) - 1
    x = ((int(rng_seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)
    x = (x + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


_STEP_TOKENS = itertools.count()


class TrainStep:
    """Built by :func:`make_train_step`; ``step(*batch) -> loss`` runs one
    iteration through the executor and returns the loss as a device
    scalar (a fresh one each call)."""

    def __init__(self, model, optimizer, loss_fn, program, seed_fn,
                 raw_step_fn, params, init_state):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self._program = program
        self._seed = seed_fn
        #: the un-captured step, ``(state, call_index, *batch) -> (state,
        #: loss)``: the same body, run eagerly, updating ``state`` in place
        self._raw_step_fn = raw_step_fn
        self._params = params
        self.state = init_state
        #: 0-based count of calls; with ``rng_seed`` it seeds the dropout
        #: generators of each call (a host integer: reading the device step
        #: count would be a host sync); chaos ``at=`` indices key on it
        self.calls = 0
        #: runtime.resilience.BadStepGuard attached by guard.attach(step)
        self._guard = None
        #: on-device telemetry (make_train_step telemetry=) and the calls
        #: between its drains
        self._telemetry = False
        self._drain_every = 1
        #: the JAX markers ZeroTrainStep reads: the axis this step exchanges
        #: over (None: no exchange), whether donate_state=True was asked for
        #: explicitly, the flat-master layout (None: one tensor a parameter)
        self._axis_name = None
        self._donate_state = False
        self._flat_meta = None
        #: the pieces of the window that ZeroTrainStep builds its own
        #: program from (make_train_step's closures and settings)
        self._parts = None

    def __call__(self, *batch):
        if _chaos.active():
            batch = _chaos_taint(self, batch)
        self._seed(self.calls)
        # the executor heartbeats the watchdog with the 1-based call count
        # once the call is enqueued
        loss = _executor.executor.submit(self._program, (self.state,) + batch,
                                         step=self.calls + 1)
        self.calls += 1
        if self._guard is not None:
            # the step's device skip flag, which the next call overwrites
            # in place: the guard copies it out without a host sync
            self._guard.observe(self.state.scaler.overflow)
        if self._telemetry and self.calls % self._drain_every == 0:
            self.drain_telemetry()
        return loss

    def drain_telemetry(self):
        """Read the on-device telemetry to the host and reset it in place
        (:func:`apex_tpu_torch.runtime.executor.drain_telemetry`: one
        device-to-host copy, the step's one host sync); emits a
        ``train.telemetry`` event and returns the record (None when
        telemetry is off or no window completed since the last drain)."""
        return _executor.drain_telemetry(self)

    def graph_stats(self):
        """The captured graphs of this step: entries (batch signatures),
        captures, replays, capture seconds and pool bytes."""
        return _executor.graph_stats(self._program)

    @property
    def last_step_skipped(self):
        """Device int32 scalar: 1 when the most recent call skipped its
        update on an overflow (reading it with ``int(...)`` is a host
        sync)."""
        return self.state.scaler.overflow

    def sync_to_objects(self):
        """Write the state back into the model: each parameter gets its
        model-dtype value (the half copy where cast, else the fp32 master;
        with ``flat_master`` its row of the bucket's stack, a view); the
        masters stay in ``self.state.master_params``."""
        st = self.state
        with torch.no_grad():
            if self._flat_meta is not None:
                for p, v in zip(self._params, flat_param_values(
                        self._flat_meta, st.master_params, st.model_params)):
                    p.data = v
                return
            for p, m, half in zip(self._params, st.master_params,
                                  st.model_params):
                p.data = m if half is None else half

    def load_state(self, host_state):
        """Copy a host checkpoint state (or a state of tensors anywhere)
        into this step's own tensors, each with ``copy_``: a captured graph
        replays the restored state with no recapture.  The structure, each
        leaf's shape and dtype are checked first
        (``runtime.resilience.reshard_state``: a typed
        ``CheckpointReshardError`` naming the leaf; nothing is cast)."""
        from ..runtime.resilience import reshard_state
        reshard_state(host_state, self.state)
        return self


def _chaos_taint(train_step, batch):
    """``train.step`` chaos hook: ``"nonfinite_grads"`` multiplies every
    floating batch tensor by NaN, so the scaled loss and every gradient go
    non-finite and the step's own overflow machinery (flag, skip, scale
    halving) fires as in a real overflow storm; a captured step copies the
    tainted batch into its static inputs and replays on it.
    ``"kill"``/``"fail"`` raise from the hook itself."""
    action = _chaos.hook("train.step", step=train_step.calls)
    if action != "nonfinite_grads":
        return batch
    return tuple(tree_map(
        lambda x: x * float("nan") if isinstance(x, torch.Tensor)
        and x.is_floating_point() else x, b) for b in batch)


def match_param_groups(optimizer, params, caller="make_train_step"):
    """The optimizer's param groups as index lists into ``params``,
    matched by identity; parameters in no group stay frozen."""
    id2idx = {id(p): i for i, p in enumerate(params)}
    group_idxs = []
    for gi, group in enumerate(optimizer.param_groups):
        idxs = []
        for p in group["params"]:
            if id(p) not in id2idx:
                raise ValueError(
                    f"{caller}: optimizer param_groups[{gi}] holds a "
                    f"parameter (shape {tuple(p.shape)}) that is not one of "
                    f"model.parameters(); the fused step requires the "
                    f"optimizer to optimize the model's own parameters")
            idxs.append(id2idx[id(p)])
        group_idxs.append(idxs)
    return group_idxs


def _model_dtypes(model, params, half_dtype, keep_batchnorm_fp32):
    """The dtype each parameter takes in the forward: ``half_dtype`` for
    every one (LayerNorm weights and embeddings included), except
    BatchNorm's with ``keep_batchnorm_fp32``."""
    if half_dtype is None:
        return [p.dtype for p in params]
    bn_ids = set()
    if keep_batchnorm_fp32:
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                bn_ids.update(id(p) for p in m.parameters(recurse=False))
    return [_f32 if id(p) in bn_ids else half_dtype for p in params]


def init_step_state(params, buffers, model_dtypes, opt_init, init_scale):
    """The initial state: fp32 copies of the parameters as masters, half
    copies where the forward casts, the optimizer's slots, the scaler at
    ``init_scale``, the step count at 0 (all on the parameters' device)."""
    dev = params[0].device
    masters = [p.detach().to(_f32, copy=True) for p in params]
    return StepState(
        master_params=masters,
        model_params=[None if d == _f32 else m.to(d)
                      for m, d in zip(masters, model_dtypes)],
        opt_state=opt_init(),
        scaler=ScalerState(torch.tensor(init_scale, dtype=_f32, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev)),
        stats=list(buffers),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def model_vals_of(state: StepState):
    """The parameter values the forward reads: the half copy where cast,
    else the fp32 master."""
    return [state.master_params[i] if mp is None else mp
            for i, mp in enumerate(state.model_params)]


def _keep_where_clear(skip, olds, news):
    """Each new value over its old one in place, where the device flag
    ``skip`` is clear (the JAX step's select)."""
    with torch.no_grad():
        for old, new in zip(olds, news):
            torch._foreach_copy_(old, [torch.where(skip, o, n)
                                       for o, n in zip(old, new)])


def build_opt_update(optimizer, params, group_idxs,
                     caller="make_train_step"):
    """The optimizer as an update over flat lists, one kernel launch per
    param group (``ops.multi_tensor_adam`` or ``ops.multi_tensor_sgd``), or
    for ``FusedLAMB`` each group's gradient norm and
    ``ops.multi_tensor_lamb``, for ``FusedNovoGrad``
    ``ops.multi_tensor_novograd`` over one fp32 running norm a parameter
    (seeded on the device at step 1 unless ``init_zero``), whose new values
    replace the old in place where the flag is clear, as the JAX step
    selects them.
    Returns ``(opt_update, opt_init)``; ``opt_update(flag, grads, masters,
    slots, step, lr_scale=None)`` updates masters and slots in place and
    leaves them untouched on a set flag; a device ``lr_scale`` multiplies
    each group's lr on the device.  The gradients may mix dtypes: the SGD
    kernel reads each in its own, and the Adam branch widens a mixed list
    to fp32 first (its kernel takes one gradient dtype a list)."""
    opt = optimizer
    if isinstance(opt, FusedSGD):
        def opt_update(flag, grads, masters, slots, step, lr_scale=None):
            for group, idxs in zip(opt.param_groups, group_idxs):
                if not idxs:
                    continue
                lr = group["lr"] if lr_scale is None \
                    else group["lr"] * lr_scale
                # the JAX step's branch: first_run False and scale 1 (from
                # zero momenta without dampening the first update is a
                # first run's)
                ops.multi_tensor_sgd(
                    flag, [[grads[i] for i in idxs],
                           [masters[i] for i in idxs],
                           [slots["momentum"][i] for i in idxs]],
                    group["weight_decay"], group["momentum"],
                    group["dampening"], lr, group["nesterov"], False,
                    opt.wd_after_momentum, 1.0)

        def opt_init():
            return {"momentum": [torch.zeros_like(p, dtype=_f32)
                                 for p in params]}
        return opt_update, opt_init
    if isinstance(opt, FusedLAMB):
        def opt_update(flag, grads, masters, slots, step, lr_scale=None):
            skip = flag.reshape(()) > 0
            for group, idxs in zip(opt.param_groups, group_idxs):
                if not idxs:
                    continue
                b1, b2 = group["betas"]
                lr = group["lr"] if lr_scale is None \
                    else group["lr"] * lr_scale
                olds = [[masters[i] for i in idxs],
                        [slots["m"][i] for i in idxs],
                        [slots["v"][i] for i in idxs]]
                g = [grads[i] for i in idxs]
                # the group's global gradient norm, as the eager step takes
                # it per dtype bucket
                _, gnorm, _ = ops.multi_tensor_l2norm(flag, [g])
                _, *news = ops.multi_tensor_lamb(
                    flag, [g] + olds, lr, b1, b2, group["eps"], step,
                    bool(group["bias_correction"]), group["weight_decay"],
                    1 if group["grad_averaging"] else 0, opt.adam_w_mode,
                    gnorm, group["max_grad_norm"])
                _keep_where_clear(skip, olds, news)

        def opt_init():
            return {k: [torch.zeros_like(p, dtype=_f32) for p in params]
                    for k in ("m", "v")}
        return opt_update, opt_init
    if isinstance(opt, FusedNovoGrad):
        def opt_update(flag, grads, masters, slots, step, lr_scale=None):
            skip = flag.reshape(()) > 0
            for group, idxs in zip(opt.param_groups, group_idxs):
                if not idxs:
                    continue
                b1, b2 = group["betas"]
                lr = group["lr"] if lr_scale is None \
                    else group["lr"] * lr_scale
                g = [grads[i] for i in idxs]
                olds = [[masters[i] for i in idxs],
                        [slots["m"][i] for i in idxs],
                        [slots["grad_norms"][i] for i in idxs]]
                norms = olds[2]
                if not group["init_zero"]:
                    # the first step seeds each running norm with its
                    # gradient's, so the first blend is a no-op
                    first = step.reshape(()) == 1
                    norms = [torch.where(first, s, n) for s, n in zip(
                        ops.multi_tensor.novograd_norms(
                            g, group["norm_type"]), norms)]
                _, *news = ops.multi_tensor_novograd(
                    flag, [g, olds[0], olds[1], norms], lr, b1, b2,
                    group["eps"], step, bool(group["bias_correction"]),
                    group["weight_decay"],
                    1 if group["grad_averaging"] else 0, opt.moment_mode,
                    group["norm_type"])
                _keep_where_clear(skip, olds, news)

        def opt_init():
            return {"m": [torch.zeros_like(p, dtype=_f32) for p in params],
                    "grad_norms": [torch.zeros((), dtype=_f32,
                                               device=p.device)
                                   for p in params]}
        return opt_update, opt_init
    if not isinstance(opt, FusedAdam):
        raise TypeError(
            f"{caller} does not support {type(optimizer).__name__}; "
            f"supported: FusedSGD, FusedAdam, FusedLAMB, FusedNovoGrad")

    def opt_update(flag, grads, masters, slots, step, lr_scale=None):
        if len({g.dtype for g in grads}) > 1:
            grads = [g.float() for g in grads]
        for group, idxs in zip(opt.param_groups, group_idxs):
            if not idxs:
                continue
            b1, b2 = group["betas"]
            lr = group["lr"] if lr_scale is None else group["lr"] * lr_scale
            ops.multi_tensor_adam(
                flag, [[grads[i] for i in idxs], [masters[i] for i in idxs],
                       [slots["m"][i] for i in idxs],
                       [slots["v"][i] for i in idxs]],
                lr, b1, b2, group["eps"], step, opt.adam_w_mode,
                bool(group["bias_correction"]), group["weight_decay"])

    def opt_init():
        return {k: [torch.zeros_like(p, dtype=_f32) for p in params]
                for k in ("m", "v")}

    return opt_update, opt_init


def apply_fused_update(state: StepState, grads, opt_update, *, dynamic,
                       init_scale, scale_window, min_loss_scale,
                       max_loss_scale, zero_flag, lr_schedule=None,
                       loss=None, mean_axes=(), shards=None):
    """The post-gradient half of a step, on the device: unscale into fp32
    master gradients with the overflow flag, the optimizer update (skipped
    on the flag; with ``lr_schedule``, each group's lr times the schedule
    of the 1-based device step count), the half copies re-made from the
    masters, the step count and the loss-scale update.  A static scale of
    1.0 (the bf16 recipe) neither unscales nor checks, and never skips, as
    in the JAX package.  The masters, slots, half copies, scaler and step
    count are updated in place.  A gradient that autograd returned in another
    layout than its master (the transposed product of a matmul, cuDNN's
    channels-last weight gradient beside an OIHW weight) is copied into
    the master's layout first, as ``.grad`` accumulation does, since the
    kernels take each list in its param's layout; where the two agree
    (channels-last weights and their gradients) nothing is copied.  With
    ``state.telem`` set, the window's ``loss``, the master gradients' norm,
    the new loss scale and the flag are folded into it
    (``observe.telemetry.accumulate``, the loss averaged over
    ``mean_axes``), written into its own tensors.  ``shards`` (ZeRO's
    :class:`apex_tpu_torch.parallel.zero._Collectives`) makes the overflow
    flag the group's maximum before the update, re-makes the half copies
    by its all-gather and takes the gradient norm over the group.
    Returns ``state``."""
    grads = [g if same_layout(g, m) else
             torch.empty_like(m, dtype=g.dtype).copy_(g)
             for g, m in zip(grads, state.master_params)]
    check_overflow = dynamic or init_scale != 1.0
    if check_overflow:
        inv = 1.0 / state.scaler.loss_scale
        master_grads = [g.float() * inv for g in grads]
        flag = nonfinite_flag(zero_flag, master_grads)
        if shards is not None:
            flag = shards.flag(flag)
    else:
        # the kernels widen the gradients to fp32 themselves
        flag, master_grads = zero_flag, grads
    step_count = state.step + 1
    opt_update(flag, master_grads, state.master_params, state.opt_state,
               step_count, lr_scale=None if lr_schedule is None
               else lr_schedule(step_count))
    halves = [(h, m) for h, m in zip(state.model_params, state.master_params)
              if h is not None]
    if shards is not None:
        shards.halves(state)
    elif halves:
        with torch.no_grad():
            torch._foreach_copy_([h for h, _ in halves],
                                 [m for _, m in halves])
    skip = flag > 0
    new_scaler, _ = update_scale_state(
        ScalerState(state.scaler.loss_scale, state.scaler.unskipped, flag),
        dynamic=dynamic, scale_window=scale_window,
        min_loss_scale=min_loss_scale, max_loss_scale=max_loss_scale)
    # written into the state's own tensors, so that a captured step's
    # outputs are its inputs; this step's skip flag is carried out in the
    # scaler state, as the JAX step does, so last_step_skipped reads it
    # without a host sync
    with torch.no_grad():
        sc = state.scaler
        sc.loss_scale.copy_(new_scaler.loss_scale)
        sc.unskipped.copy_(new_scaler.unskipped)
        sc.overflow.copy_(flag.reshape(sc.overflow.shape))
        state.step.copy_(torch.where(skip, state.step, step_count))
        telem = getattr(state, "telem", None)
        if telem is not None:
            new = _obs_telemetry.accumulate(
                telem, loss=loss, master_grads=master_grads, flag=flag,
                loss_scale=sc.loss_scale, mean_axes=mean_axes,
                grad_norm=None if shards is None
                else shards.grad_norm(master_grads))
            torch._foreach_copy_(list(telem), list(new))
    return state


class FlatMeta(NamedTuple):
    """The layout of the stacked master and slot buffers: one buffer a
    (param group, shape, model dtype) bucket, the bucket's tensors stacked
    on a new leading axis, so that each parameter's row is a view and the
    update of a group's buckets is one kernel launch."""
    buckets: list    # [(group_index, shape, dtype, [param indices])]
    pos: list        # per parameter: (bucket_id, index within the bucket)
    shapes: list     # per parameter: its shape


def build_flat_meta(params, group_idxs, model_dtypes):
    """The buckets of ``params`` in the order the groups list them."""
    buckets, pos, key2bid = [], [None] * len(params), {}
    for gi, idxs in enumerate(group_idxs):
        for i in idxs:
            key = (gi, tuple(params[i].shape), model_dtypes[i])
            if key not in key2bid:
                key2bid[key] = len(buckets)
                buckets.append((gi, tuple(params[i].shape), model_dtypes[i],
                                []))
            bid = key2bid[key]
            pos[i] = (bid, len(buckets[bid][3]))
            buckets[bid][3].append(i)
    return FlatMeta(buckets, pos, [tuple(p.shape) for p in params])


def flat_param_values(meta: FlatMeta, masters, model_params):
    """Each parameter's forward value: its row of the bucket's half stack,
    or of the fp32 master stack where the bucket is not cast (a view
    either way)."""
    return [(masters[bid] if model_params[bid] is None
             else model_params[bid])[j] for bid, j in meta.pos]


def flat_model_params(meta: FlatMeta, masters):
    """Each bucket's half stack (one cast of the whole stack), None for an
    fp32 bucket, whose forward values read the master."""
    return [None if d == _f32 else masters[bid].to(d)
            for bid, (_, _, d, _) in enumerate(meta.buckets)]


def stack_buckets(meta: FlatMeta, grads):
    """Per-parameter gradients stacked into the buckets' layout."""
    return [torch.stack([grads[i] for i in idxs])
            for _, _, _, idxs in meta.buckets]


def build_opt_update_flat(optimizer, meta: FlatMeta,
                          caller="make_train_step"):
    """The stacked update: ``(opt_update, opt_init)`` as
    :func:`build_opt_update`'s, over the buckets, one ``multi_tensor_adam``
    or ``multi_tensor_sgd`` launch a param group over that group's stacks.
    Only the elementwise optimizers are taken: LAMB's trust ratio and
    NovoGrad's running norms are per-tensor quantities that a stack would
    compute per bucket instead (``TypeError``, as in the JAX step).
    ``opt_init(bucket_shapes, device)`` makes the zero slots."""
    if not isinstance(optimizer, (FusedSGD, FusedAdam)):
        raise TypeError(
            f"{caller}: flat_master=True supports the elementwise "
            f"optimizers (FusedSGD, FusedAdam); {type(optimizer).__name__} "
            f"updates depend on per-tensor norms (LAMB trust ratio, "
            f"NovoGrad running norms) that stacked buffers would "
            f"change — use flat_master=False")
    group_buckets = [[b for b, bucket in enumerate(meta.buckets)
                      if bucket[0] == gi]
                     for gi in range(len(optimizer.param_groups))]
    per_group, init = build_opt_update(optimizer, [], group_buckets, caller)
    names = ("momentum",) if isinstance(optimizer, FusedSGD) else ("m", "v")

    def opt_init(bucket_shapes, device):
        return {k: [torch.zeros(s, dtype=_f32, device=device)
                    for s in bucket_shapes] for k in names}
    return per_group, opt_init


def init_step_state_flat(params, buffers, meta: FlatMeta, opt_init,
                         init_scale):
    """:func:`init_step_state` in the stacked layout."""
    dev = params[0].device
    masters = [torch.stack([params[i].detach().to(_f32) for i in idxs])
               for _, _, _, idxs in meta.buckets]
    return StepState(
        master_params=masters,
        model_params=flat_model_params(meta, masters),
        opt_state=opt_init([m.shape for m in masters], dev),
        scaler=ScalerState(torch.tensor(init_scale, dtype=_f32, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev),
                           torch.zeros((), dtype=torch.int32, device=dev)),
        stats=list(buffers),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def apply_fused_update_flat(state: StepState, grads, meta: FlatMeta,
                            opt_update, **kw):
    """The stacked twin of :func:`apply_fused_update`: the per-tensor
    gradients (exchanged already under DP) stacked once a bucket, then the
    unscale, overflow check, update and half-copy casts each over the
    stacks."""
    return apply_fused_update(state, stack_buckets(meta, grads), opt_update,
                              **kw)


def data_group(axis_name, device, what="make_train_step: axis_name="):
    """``(group, world, rank)`` of the mesh axes ``axis_name`` (a name or a
    tuple), resolved by :func:`apex_tpu_torch.parallel.mesh.resolve`:
    ``"data"`` alone is ``torch.distributed``'s default group (None)
    unless an entered mesh names it; a tuple is the group of the axes'
    product; an axis no entered mesh names raises.  Without
    ``torch.distributed`` the data axis is this one process.  A CUDA step
    needs an NCCL group: it never exchanges over gloo."""
    ax = resolve(axis_name, what)
    if dist.is_available() and dist.is_initialized():
        check_backend(ax.group, device)
    return ax.group, ax.size, ax.index


def check_backend(group, device):
    """Raise where a CUDA step's ``group`` is not an NCCL group."""
    if torch.device(device).type == "cuda" \
            and dist.get_backend(group) != "nccl":
        raise RuntimeError(
            f"a train step on {device} exchanges over NCCL; this process "
            f"group's backend is {dist.get_backend(group)!r} (start it with "
            f"parallel.init_distributed() on the card)")


def dp_exchange(grads, group, world, predivide_factor, always_fp32):
    """The JAX step's DP gradient exchange, one flattened all-reduce a
    dtype (``parallel.distributed.apply_flat_dist_call``): each buffer
    widened to fp32 with ``always_fp32``, divided by ``predivide_factor``
    (where it is not 1), summed over ``group``, divided by ``world /
    predivide_factor`` and cast back.  Returns new tensors in ``grads``'
    order (views of the exchanged buffers)."""
    post = world / predivide_factor

    def call(flat):
        gc = flat.float() if always_fp32 else flat
        if predivide_factor != 1.0:
            gc = gc / predivide_factor
        dist.all_reduce(gc, group=group)
        gc = gc / post
        return gc.to(flat.dtype) if always_fp32 else gc
    return _flat_exchange(grads, call)


def _flat_exchange(grads, call):
    """``call`` on one flattened buffer a dtype of ``grads``; the results
    cut back, in ``grads``' order."""
    from ..parallel.distributed import apply_flat_dist_call, split_by_type
    out = {}
    for bucket in split_by_type(grads):
        for g, r in zip(bucket, apply_flat_dist_call(bucket, call)):
            out[id(g)] = r
    return [out[id(g)] for g in grads]


def tp_sum(grads, group):
    """The sums of ``grads`` over ``group``, one flattened all-reduce a
    dtype (the JAX step's ``psum`` over ``tp_axis``, each tensor summed
    elementwise); new tensors in ``grads``' order."""
    def call(flat):
        dist.all_reduce(flat, group=group)
        return flat
    return _flat_exchange(grads, call)


def _refuse(what, owner):
    refuse(f"make_train_step: {what}", owner)


def make_train_step(model, optimizer, loss_fn: Callable,
                    half_dtype=None,
                    keep_batchnorm_fp32: bool = True,
                    dynamic_loss_scale: bool = True,
                    scale_window: int = 2000,
                    min_loss_scale: Optional[float] = None,
                    max_loss_scale: float = 2.0 ** 24,
                    loss_scale="dynamic",
                    axis_name=None,
                    tp_axis=None,
                    gradient_predivide_factor: float = 1.0,
                    allreduce_always_fp32: bool = False,
                    donate_state="auto",
                    grad_accum_steps: int = 1,
                    accum_steps: Optional[int] = None,
                    accum_stacked: bool = False,
                    lr_schedule: Optional[Callable] = None,
                    rng_seed: int = 0,
                    zero_sharding: bool = False,
                    zero_mesh=None,
                    zero_axis: str = "data",
                    zero_stage: int = 1,
                    flat_master: bool = False,
                    parallel=None,
                    example_batch=None,
                    devices=None,
                    auto_tune: int = 0,
                    plan_options=None,
                    telemetry: bool = False,
                    drain_every: int = 1,
                    overlap="auto"):
    """Build an O2-style train step: ``step(*batch) -> loss``.

    ``batch[0]`` feeds the model (its floating tensors cast to
    ``half_dtype``; integer ids stay as they are) and the whole batch feeds
    ``loss_fn(output, *batch[1:])``.  With ``half_dtype`` every parameter
    runs the forward as a half copy (BatchNorm's stay fp32 with
    ``keep_batchnorm_fp32``) while the optimizer and the scaler work on fp32
    masters.  The backward differentiates ``loss.float() * loss_scale``.
    ``loss_scale="dynamic"`` starts at ``min(max_loss_scale, 2**16)``,
    halves on an overflow (the step is skipped: masters, slots and step
    count unchanged) and doubles after ``scale_window`` clean steps; a
    number is a static scale.  A model whose ``forward`` takes a
    ``generator`` gets one on its device for each forward, seeded from
    :func:`dropout_seed` (``rng_seed``, the forward's index), for its
    dropout masks.  The step runs through the runtime executor: on the card
    its second call captures it as a CUDA graph, which later calls replay
    (see the module docstring).

    A model output may be a tuple, such as ``(hidden, table)`` from an
    ``output_hidden`` GPT with a chunked loss.  ``accum_steps`` (or
    ``grad_accum_steps``) K > 1 splits every batch element whose leaves
    share the model input's leading dim into K microbatches (with
    ``accum_stacked`` the batch is already (K, B, ...)) and broadcasts the
    rest; the scaled gradients and the losses are summed in fp32 and
    averaged, as the JAX step does.  ``lr_schedule(step) -> multiplier``
    (:mod:`apex_tpu_torch.optimizers.schedules`) scales each group's lr by
    its value at the 1-based device step count, on the device.

    ``FusedAdam``, ``FusedSGD``, ``FusedLAMB`` and ``FusedNovoGrad`` are
    ported.  A model's buffers (BatchNorm's running statistics) are its
    own, updated in place by its forward, as the JAX step carries them
    through a skipped step too.  ``donate_state`` has nothing to choose:
    the state is always updated in place.

    ``axis_name="data"``: data parallelism, one process a card.  Each rank
    calls the step on its own shard of the batch; the window's gradients
    are all-reduced over ``torch.distributed``'s default group with the
    DDP knobs (``gradient_predivide_factor`` splits the averaging around
    the sum, ``allreduce_always_fp32`` sums in fp32), once a window after
    the fp32 accumulation and before the unscale, so every rank sees the
    same gradients and skips the same windows (:func:`dp_exchange`).  The
    rank is folded into each forward's dropout seed, as the JAX key folds
    the axis index, so ranks draw masks of their own.  The returned loss is
    this rank's; with ``telemetry`` the accumulated loss is the group's
    mean.  Without ``torch.distributed`` the world is this one process.
    ``axis_name`` may also name other batch axes, or several (``("data",
    "sp")``), of a mesh entered with ``parallel.use_mesh``; the gradients
    are averaged over their product, and each axis's index is folded into
    the dropout seed, except the model's own ``sp_axis``, whose ranks must
    draw alike (the sequence-parallel models keep their shards' masks
    apart themselves and the ring's dropout seed shared).  An axis no mesh
    names raises ``NotImplementedError``.

    ``tp_axis``: tensor parallelism.  The model, built with the same
    ``tp_axis``, lists in ``tp_sharded_params()`` the parameters whose
    gradients are block-sparse on each rank; after the DP exchange and
    before the unscale those are summed over the TP group (one flattened
    all-reduce a dtype), once a window.  Every TP rank calls the step on
    the same batch; the dropout seed is not folded with the TP index
    (replicated activations drop alike; the attention folds it into its
    own seed).  ``parallel`` raises ``NotImplementedError`` naming ROADMAP
    A9.

    ``flat_master=True``: masters and optimizer slots stacked per (param
    group, shape, model dtype) bucket (:class:`FlatMeta`); the forward
    reads each parameter's row of its bucket (a view), and each group's
    update is one kernel launch over its stacks.  FusedSGD and FusedAdam
    only (LAMB and NovoGrad raise ``TypeError``), every parameter in a
    param group; it composes with ``axis_name`` (the gradients exchanged
    per tensor before the stack), accumulation and schedules, and excludes
    ``zero_sharding`` (``ValueError``).

    ``zero_sharding=True`` returns a
    :class:`~apex_tpu_torch.parallel.zero.ZeroTrainStep` over ``zero_axis``
    of ``zero_mesh`` (a ``torch.distributed`` ``DeviceMesh``; by default
    one over the default group, or a world of one without
    ``torch.distributed``) at ``zero_stage`` 0, 1 or 3; see
    :mod:`apex_tpu_torch.parallel.zero`.  It gathers each sharded copy once
    a window, so ``overlap`` (the JAX step's all-gather prefetch) is
    accepted and has nothing to overlap.  Each rank runs ``loss_fn`` over
    its rows of the global batch and the gradients are averaged over the
    ranks, which is the JAX step's global-batch loss only for a mean over
    rows with equal weight for every row: a summed loss gives ``1/n`` of
    the JAX gradients, and a mean over a mask whose counts differ between
    ranks weights each rank by its own count.

    ``telemetry=True`` adds an on-device accumulator to the state
    (``state.telem``, see ``observe.telemetry``), folded inside the
    captured step, and drains it every ``drain_every`` calls; the graph is
    keyed on it, so a step with telemetry captures its own graph."""
    if parallel is not None:
        _refuse("parallel=", PARALLEL)
    explicit_donate = donate_state is True
    _executor.donation.resolve(donate_state)
    if accum_steps is not None:
        if grad_accum_steps not in (1, accum_steps):
            raise ValueError(
                f"accum_steps={accum_steps} conflicts with "
                f"grad_accum_steps={grad_accum_steps}: they are the same "
                f"knob (accum_steps is the preferred spelling); pass one")
        grad_accum_steps = int(accum_steps)
    if accum_stacked and grad_accum_steps == 1:
        raise ValueError(
            "accum_stacked=True requires accum_steps > 1: stacked "
            "(K, B, ...) blocks only exist under accumulation")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, "
                         f"got {grad_accum_steps}")
    if telemetry and drain_every < 1:
        raise ValueError(f"drain_every must be >= 1, got {drain_every}")
    if flat_master and zero_sharding:
        raise ValueError(
            "flat_master=True excludes zero_sharding: ZeRO's win is "
            "per-parameter sharding of exactly the buffers flat_master "
            "concatenates")
    if zero_sharding:
        if zero_stage not in (0, 1, 3):
            raise ValueError(
                f"zero_stage must be 1 (optimizer-state sharding), 3 "
                f"(+ parameter sharding), or 0 (replicated state, data "
                f"parallelism alone); got {zero_stage!r}.  Stage 2 has no "
                f"switch of its own: the fused step holds no gradient "
                f"buffer between steps, and its gradients are "
                f"reduce-scattered into the master shards already")
        if axis_name is not None or tp_axis is not None:
            raise ValueError(
                "zero_sharding=True excludes axis_name/tp_axis: "
                "ZeroTrainStep takes the global batch and exchanges over "
                "zero_axis itself; tensor parallelism runs on the "
                "axis_name path")
        from ..parallel.zero import (ZeroTrainStep, check_zero_mesh,
                                     default_zero_mesh)
        dev = next(iter(model.parameters())).device
        if zero_mesh is None:
            zero_mesh = default_zero_mesh(zero_axis, dev)
        else:
            check_zero_mesh(zero_mesh, zero_axis)
        base = make_train_step(
            model, optimizer, loss_fn, half_dtype=half_dtype,
            keep_batchnorm_fp32=keep_batchnorm_fp32,
            dynamic_loss_scale=dynamic_loss_scale,
            scale_window=scale_window, min_loss_scale=min_loss_scale,
            max_loss_scale=max_loss_scale, loss_scale=loss_scale,
            grad_accum_steps=grad_accum_steps, accum_stacked=accum_stacked,
            lr_schedule=lr_schedule, rng_seed=rng_seed,
            telemetry=telemetry, drain_every=drain_every)
        return ZeroTrainStep(base, zero_mesh, zero_axis, stage=zero_stage)

    from ..inference.quant import is_quantized
    if is_quantized(model):
        raise ValueError(
            "this model has int8-quantized weights "
            "(apex_tpu_torch.inference.quantize_int8) — quantized models "
            "are inference-only; rebuild/reload the model to train")
    params = [p for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    buffers = list(model.buffers())
    group_idxs = match_param_groups(optimizer, params)
    model_dtypes = _model_dtypes(model, params, half_dtype,
                                 keep_batchnorm_fp32)
    dynamic = loss_scale == "dynamic"
    init_scale = (min(max_loss_scale, 2.0 ** 16) if dynamic
                  else float(loss_scale))
    flat_meta = None
    if flat_master:
        grouped = {i for idxs in group_idxs for i in idxs}
        if len(grouped) != len(params):
            raise ValueError(
                "flat_master=True requires every model parameter to be "
                "in an optimizer param_group (frozen params have no "
                "slot in the flat master buffers)")
        flat_meta = build_flat_meta(params, group_idxs, model_dtypes)
        opt_update, opt_init = build_opt_update_flat(optimizer, flat_meta)
        init_state = init_step_state_flat(params, buffers, flat_meta,
                                          opt_init, init_scale)
    else:
        opt_update, opt_init = build_opt_update(optimizer, params,
                                                group_idxs)
        init_state = init_step_state(params, buffers, model_dtypes,
                                     opt_init, init_scale)
    dev = params[0].device
    if telemetry:
        init_state = init_state._replace(
            telem=_obs_telemetry.init_telemetry(dev))
    zero_flag = torch.zeros((), dtype=torch.int32, device=dev)
    takes_generator = "generator" in inspect.signature(
        model.forward).parameters
    dp_group, dp_world, _ = (None, 1, 0) if axis_name is None \
        else data_group(axis_name, dev)
    tp_group, tp_ids = None, frozenset()
    if tp_axis is not None:
        tp_group = data_group(tp_axis, dev, "make_train_step: tp_axis=")[0]
        getter = getattr(model, "tp_sharded_params", None)
        if getter is None:
            raise ValueError(
                "tp_axis given but the model has no tp_sharded_params() — "
                "build the model with its tp_axis= option (models/gpt.py, "
                "models/bert.py) so the step knows which gradients are "
                "block-sparse")
        tp_ids = frozenset(id(p) for p in getter())
    tp_idx = [i for i, p in enumerate(params) if id(p) in tp_ids]
    # the axes whose index folds into the dropout seed: each batch axis but
    # the model's own sp_axis, whose ranks must draw alike
    sp = getattr(model, "sp_axis", None)
    fold_idx = [] if axis_name is None else [
        resolve(ax).index for ax in names_of(axis_name) if ax != sp]
    mean_axes = names_of(axis_name) if telemetry and axis_name is not None \
        else ()

    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point() \
                and x.dtype != half_dtype:
            return x.to(half_dtype)
        return x

    k_acc = grad_accum_steps

    # one dropout generator a forward of the window, seeded on the host
    # before every call (seed_calls), so a captured step's replays draw
    # what an eager call draws
    gens = [torch.Generator(device=dev) for _ in range(grad_accum_steps)] \
        if takes_generator else []

    def seed_calls(call_index, folds=()):
        """Seed the window's generators for call ``call_index``; each index
        of ``folds`` (the rank's index on each folded axis) is folded into
        each seed in turn."""
        for i, gen in enumerate(gens):
            seed = dropout_seed(rng_seed, call_index * grad_accum_steps + i)
            for idx in folds:
                seed = dropout_seed(seed, idx)
            gen.manual_seed(seed)

    def grads_of(leaves, gen, scale, *b):
        """The loss and the gradients of ``loss.float() * scale`` for one
        forward over the batch ``b``, drawing from ``gen``."""
        x = b[0] if half_dtype is None else tree_map(cast, b[0])
        kwargs = {} if gen is None else {"generator": gen}
        # O1's casts stay off: half_dtype is this step's only cast, as the
        # JAX step runs its forward outside the tape's policy
        with disable_casts(), torch.enable_grad():
            out = functional_call(model, dict(zip(names, leaves)), (x,),
                                  kwargs)
            loss = loss_fn(out, *b[1:])
            scaled = loss.float() * scale
        grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(v) if g is None else g
                               for v, g in zip(leaves, grads)]

    def microbatches(batch):
        """The K microbatches of ``batch``: every element whose leaves all
        share the model input's leading dim is split along it (indexed,
        with ``accum_stacked``); anything else is broadcast."""
        lead = [a for a in tree_leaves(batch[0])
                if isinstance(a, torch.Tensor) and a.dim() >= 1]
        if not lead:
            raise ValueError(
                f"grad_accum_steps={k_acc}: the model input (batch[0]) has "
                f"no leading batch dimension to split")
        n0 = lead[0].shape[0]

        def splittable(b):
            leaves = tree_leaves(b)
            return bool(leaves) and all(
                isinstance(a, torch.Tensor) and a.dim() >= 1
                and a.shape[0] == n0 for a in leaves)

        def leaf(a, i):
            n = a.shape[0]
            if accum_stacked:
                if n != k_acc:
                    raise ValueError(
                        f"accum_stacked=True with accum_steps={k_acc}: "
                        f"batch leading dim {n} is not the microbatch count "
                        f"(expected (K, B, ...) stacked blocks)")
                return a[i]
            if n % k_acc:
                raise ValueError(
                    f"grad_accum_steps={k_acc}: batch leading dim {n} is "
                    f"not divisible into microbatches")
            m = n // k_acc
            return a[i * m:(i + 1) * m]

        splits = [i == 0 or splittable(b) for i, b in enumerate(batch)]
        return [tuple(tree_map(lambda a: leaf(a, i), b) if sp else b
                      for b, sp in zip(batch, splits))
                for i in range(k_acc)]

    def window(scale, leaves, batch):
        """The window's loss and gradients of ``leaves``, which every
        microbatch differentiates."""
        if k_acc == 1:
            return grads_of(leaves, gens[0] if gens else None, scale,
                            *batch)
        # the JAX step's scan: fp32 sums of each microbatch's scaled
        # gradients and loss, then their means
        acc, loss_sum = None, torch.zeros((), dtype=_f32, device=dev)
        for i, mb in enumerate(microbatches(batch)):
            loss_i, g_i = grads_of(leaves, gens[i] if gens else None,
                                   scale, *mb)
            if acc is None:
                acc = [torch.zeros_like(g, dtype=_f32) for g in g_i]
            acc = [a + g.float() for a, g in zip(acc, g_i)]
            loss_sum = loss_sum + loss_i.float()
        return loss_sum / k_acc, [a / k_acc for a in acc]

    update_kw = dict(dynamic=dynamic, init_scale=init_scale,
                     scale_window=scale_window, min_loss_scale=min_loss_scale,
                     max_loss_scale=max_loss_scale, zero_flag=zero_flag,
                     lr_schedule=lr_schedule)

    def step_body(state: StepState, *batch):
        """One window on the state in place, drawing from ``gens`` as
        seeded; returns the loss."""
        vals = flat_param_values(flat_meta, state.master_params,
                                 state.model_params) if flat_master \
            else model_vals_of(state)
        leaves = [v.detach().requires_grad_(True) for v in vals]
        loss, grads = window(state.scaler.loss_scale, leaves, batch)
        if axis_name is not None and dist.is_initialized():
            # the DP exchange, once a window, before the unscale
            grads = dp_exchange(grads, dp_group, dp_world,
                                gradient_predivide_factor,
                                allreduce_always_fp32)
        if tp_idx and dist.is_initialized():
            # the TP assembly: each rank's block of a sharded parameter's
            # gradient, summed over the TP group
            summed = tp_sum([grads[i] for i in tp_idx], tp_group)
            for i, g in zip(tp_idx, summed):
                grads[i] = g
        if flat_master:
            apply_fused_update_flat(state, grads, flat_meta, opt_update,
                                    loss=loss, mean_axes=mean_axes,
                                    **update_kw)
        else:
            apply_fused_update(state, grads, opt_update, loss=loss,
                               mean_axes=mean_axes, **update_kw)
        return loss

    def seed_step(call_index):
        seed_calls(call_index, fold_idx)

    def raw_step_fn(state: StepState, call_index, *batch):
        seed_step(call_index)
        return state, step_body(state, *batch)

    # the window program, keyed as the JAX step keys it: a per-builder
    # token, K, the stacking and telemetry (the batch signature completes
    # the key); the state is held and updated in place
    program = _executor.Program(
        "train_step", (next(_STEP_TOKENS), grad_accum_steps, accum_stacked,
                       bool(telemetry)),
        step_body, donate_argnums=(0,), generators=gens)
    ts = TrainStep(model, optimizer, loss_fn, program, seed_step,
                   raw_step_fn, params, init_state)
    ts._telemetry = bool(telemetry)
    ts._drain_every = int(drain_every)
    ts._axis_name = axis_name
    ts._donate_state = explicit_donate
    ts._flat_meta = flat_meta
    ts._parts = SimpleNamespace(
        opt_update=opt_update, gens=gens, seed_calls=seed_calls,
        window=window, update_kw=update_kw, k_acc=grad_accum_steps,
        accum_stacked=accum_stacked, telemetry=bool(telemetry), device=dev)
    return ts
