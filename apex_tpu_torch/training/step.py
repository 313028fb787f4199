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
run as in the JAX step.  What the JAX step does beyond that is owed to
later slices and refused here with ``NotImplementedError``: data, tensor
and ZeRO parallelism, flat masters and telemetry.  An optimizer other than
the four fused ones raises ``TypeError``, as in the JAX step.
"""
from __future__ import annotations

import inspect
import itertools
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import functional_call
from torch.utils._pytree import tree_leaves, tree_map

from .. import ops
from ..amp.policy import disable_casts
from ..amp.scaler import ScalerState, update_scale_state
from ..kernels.dispatch import same_layout
from ..ops.multi_tensor import nonfinite_flag
from ..runtime import chaos as _chaos
from ..runtime import executor as _executor
from .._unported import PARALLEL, refuse
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

    def __call__(self, *batch):
        if _chaos.active():
            batch = _chaos_taint(self, batch)
        self._seed(self.calls)
        loss = _executor.executor.submit(self._program, (self.state,) + batch,
                                         step=self.calls + 1)
        self.calls += 1
        if self._guard is not None:
            # the step's device skip flag, which the next call overwrites
            # in place: the guard copies it out without a host sync
            self._guard.observe(self.state.scaler.overflow)
        return loss

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
        model-dtype value (the half copy where cast, else the fp32 master);
        the masters stay in ``self.state.master_params``."""
        st = self.state
        with torch.no_grad():
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
                       max_loss_scale, zero_flag, lr_schedule=None):
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
    (channels-last weights and their gradients) nothing is copied.
    Returns ``state``."""
    grads = [g if same_layout(g, m) else
             torch.empty_like(m, dtype=g.dtype).copy_(g)
             for g, m in zip(grads, state.master_params)]
    check_overflow = dynamic or init_scale != 1.0
    if check_overflow:
        inv = 1.0 / state.scaler.loss_scale
        master_grads = [g.float() * inv for g in grads]
        flag = nonfinite_flag(zero_flag, master_grads)
    else:
        # the kernels widen the gradients to fp32 themselves
        flag, master_grads = zero_flag, grads
    step_count = state.step + 1
    opt_update(flag, master_grads, state.master_params, state.opt_state,
               step_count, lr_scale=None if lr_schedule is None
               else lr_schedule(step_count))
    halves = [(h, m) for h, m in zip(state.model_params, state.master_params)
              if h is not None]
    if halves:
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
    return state


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
    through a skipped step too.  ``axis_name``, ``tp_axis``, the DDP knobs, ``zero_sharding``,
    ``flat_master``, ``parallel`` and ``telemetry`` raise
    ``NotImplementedError`` naming their ROADMAP item.  ``donate_state`` has
    nothing to choose: the state is always updated in place."""
    if axis_name is not None or gradient_predivide_factor != 1.0 \
            or allreduce_always_fp32:
        _refuse("data parallelism (axis_name and the DDP knobs)", PARALLEL)
    if tp_axis is not None:
        _refuse("tensor parallelism (tp_axis)", PARALLEL)
    if zero_sharding or zero_mesh is not None:
        _refuse("ZeRO sharding", PARALLEL)
    if flat_master:
        _refuse("flat_master", PARALLEL)
    if parallel is not None:
        _refuse("parallel=", PARALLEL)
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
    if telemetry:
        _refuse("telemetry", "ROADMAP A8, observe/")

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
    opt_update, opt_init = build_opt_update(optimizer, params, group_idxs)
    dynamic = loss_scale == "dynamic"
    init_scale = (min(max_loss_scale, 2.0 ** 16) if dynamic
                  else float(loss_scale))
    init_state = init_step_state(params, buffers, model_dtypes, opt_init,
                                 init_scale)
    dev = params[0].device
    zero_flag = torch.zeros((), dtype=torch.int32, device=dev)
    takes_generator = "generator" in inspect.signature(
        model.forward).parameters

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

    def seed_calls(call_index):
        for i, gen in enumerate(gens):
            gen.manual_seed(dropout_seed(rng_seed,
                                         call_index * grad_accum_steps + i))

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

    def step_body(state: StepState, *batch):
        """One window on the state in place, drawing from ``gens`` as
        seeded; returns the loss."""
        leaves = [v.detach().requires_grad_(True)
                  for v in model_vals_of(state)]
        scale = state.scaler.loss_scale
        if k_acc == 1:
            loss, grads = grads_of(leaves, gens[0] if gens else None, scale,
                                   *batch)
        else:
            # the JAX step's scan: fp32 sums of each microbatch's scaled
            # gradients and loss, then their means
            acc = [torch.zeros_like(v, dtype=_f32) for v in leaves]
            loss_sum = torch.zeros((), dtype=_f32, device=dev)
            for i, mb in enumerate(microbatches(batch)):
                loss_i, g_i = grads_of(leaves, gens[i] if gens else None,
                                       scale, *mb)
                acc = [a + g.float() for a, g in zip(acc, g_i)]
                loss_sum = loss_sum + loss_i.float()
            grads = [a / k_acc for a in acc]
            loss = loss_sum / k_acc
        apply_fused_update(
            state, grads, opt_update, dynamic=dynamic,
            init_scale=init_scale, scale_window=scale_window,
            min_loss_scale=min_loss_scale, max_loss_scale=max_loss_scale,
            zero_flag=zero_flag, lr_schedule=lr_schedule)
        return loss

    def raw_step_fn(state: StepState, call_index, *batch):
        seed_calls(call_index)
        return state, step_body(state, *batch)

    # the window program, keyed as the JAX step keys it: a per-builder
    # token, K, the stacking and telemetry (the batch signature completes
    # the key); the state is held and updated in place
    program = _executor.Program(
        "train_step", (next(_STEP_TOKENS), grad_accum_steps, accum_stacked,
                       bool(telemetry)),
        step_body, donate_argnums=(0,), generators=gens)
    return TrainStep(model, optimizer, loss_fn, program, seed_calls,
                     raw_step_fn, params, init_state)
