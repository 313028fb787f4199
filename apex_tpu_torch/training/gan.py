"""The multi-model, multi-loss train step of a GAN, the PyTorch counterpart
of ``apex_tpu/training/gan.py`` (the ``--fused`` path of
``examples/dcgan/main_amp.py``).

One call runs the alternating iteration on the device, in the JAX step's
order:

1. ``fake = netG(z)``, one generator forward;
2. the discriminator step: the gradients of ``d_loss_fn(netD(real),
   netD(fake.detach()))`` with respect to D's parameters, unscaled by D's
   own loss scale, and D's fused update (skipped on an overflow);
3. the generator step: the gradients of ``g_loss_fn(netD'(fake))`` with
   respect to G's parameters, through the *updated* discriminator D', and
   G's fused update under G's own loss scale.

The JAX step compiles this into one program in which XLA merges the two
generator forwards; here ``fake`` is computed once and its graph kept for
step 3, so G's BatchNorm statistics move once an iteration and D's three
times (real, fake, the G step), as there.  Each network keeps its own
``StepState`` (fp32 masters, optional half copies, optimizer slots, loss
scaler, step count) on the device, and the updates run the port's
multi-tensor kernels (``FusedAdam``: one Adam launch per network and dtype
group).  The iteration is submitted through the runtime executor as kind
``gan_train_step``, as the JAX builder submits it: on the card its second
call captures it as one CUDA graph, which later calls replay
(``make_train_step``'s rules: the state updated in place, the four
forwards' dropout generators seeded on the host before each call).  The
un-captured iteration is ``GanTrainStep._raw_step_fn(state, call_index,
real, z)``.  The forwards run with O1's casts off, as the JAX step runs
its model forwards outside the tape's policy: ``half_dtype`` is its only
cast.
"""
from __future__ import annotations

import inspect
import itertools
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import functional_call

from ..amp.policy import disable_casts
from ..runtime import executor as _executor
from .step import (StepState, _model_dtypes, apply_fused_update,
                   build_opt_update, dropout_seed, init_step_state,
                   match_param_groups, model_vals_of)


class GanStepState(NamedTuple):
    d: StepState
    g: StepState


_GAN_TOKENS = itertools.count()


class GanTrainStep:
    """Built by :func:`make_gan_train_step`; ``step(real, z) -> (errD,
    errG)`` runs one iteration through the executor and returns both
    losses as device scalars."""

    def __init__(self, netD, netG, optD, optG, program, seed_fn,
                 raw_step_fn, d_parts, g_parts, init_state):
        self.netD, self.netG = netD, netG
        self.optD, self.optG = optD, optG
        self._program = program
        self._seed = seed_fn
        #: the un-captured iteration, ``(state, call_index, real, z) ->
        #: (state, (errD, errG))``, updating ``state`` in place
        self._raw_step_fn = raw_step_fn
        self._d_parts, self._g_parts = d_parts, g_parts
        self.state = init_state
        #: host seconds of the first call (the JAX step's compile time)
        self.compile_s = None
        self.calls = 0

    def __call__(self, real, z):
        t0 = time.perf_counter() if self.compile_s is None else None
        self._seed(self.calls)
        losses = _executor.executor.submit(
            self._program, (self.state, real, z), step=self.calls + 1)
        self.calls += 1
        if t0 is not None:
            self.compile_s = time.perf_counter() - t0
        return losses

    def graph_stats(self):
        """The captured graphs of this step (see ``TrainStep``)."""
        return _executor.graph_stats(self._program)

    def sync_to_objects(self):
        """Write each network's parameters back into its modules: the half
        copy where cast, else the fp32 master (the buffers are the
        modules' own already)."""
        with torch.no_grad():
            for (params, _), sub in ((self._d_parts, self.state.d),
                                     (self._g_parts, self.state.g)):
                for p, m, half in zip(params, sub.master_params,
                                      sub.model_params):
                    p.data = m if half is None else half


class _Net:
    """One network's pieces: its parameters (names, objects), buffers,
    forward dtypes, optimizer update and whether it takes a generator."""

    def __init__(self, model, optimizer, half_dtype, keep_batchnorm_fp32,
                 caller):
        self.model = model
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.buffers = list(model.buffers())
        group_idxs = match_param_groups(optimizer, self.params, caller=caller)
        self.dtypes = _model_dtypes(model, self.params, half_dtype,
                                    keep_batchnorm_fp32)
        self.update, self.opt_init = build_opt_update(
            optimizer, self.params, group_idxs, caller=caller)
        self.takes_generator = "generator" in inspect.signature(
            model.forward).parameters

    def run(self, vals, x, gen):
        """One forward of the network with parameter values ``vals`` (its
        buffers are updated in place, as a training forward does), drawing
        from ``gen`` if it takes a generator."""
        kwargs = {"generator": gen} if self.takes_generator else {}
        return functional_call(self.model, dict(zip(self.names, vals)), (x,),
                               kwargs)


def make_gan_train_step(netD, netG, optD, optG,
                        d_loss_fn: Callable, g_loss_fn: Callable,
                        half_dtype=None,
                        keep_batchnorm_fp32: bool = True,
                        loss_scale="dynamic",
                        scale_window: int = 2000,
                        min_loss_scale: Optional[float] = None,
                        max_loss_scale: float = 2.0 ** 24,
                        donate_state="auto",
                        lr_schedule: Optional[Callable] = None,
                        rng_seed: int = 0):
    """Build the GAN iteration: ``step(real, z) -> (errD, errG)``.

    ``d_loss_fn(d_real_out, d_fake_out) -> scalar`` and
    ``g_loss_fn(d_fake_out) -> scalar`` (e.g. BCE with logits against real
    and fake labels).  With ``half_dtype`` both networks run their
    forwards on half copies (BatchNorm's fp32 with
    ``keep_batchnorm_fp32``) and ``real`` and ``z`` are cast to it.
    ``loss_scale="dynamic"`` gives each network a scale starting at
    ``min(max_loss_scale, 2**16)`` that halves on an overflow of that
    network's gradients (its step skipped, the other network's not) and
    doubles after ``scale_window`` clean steps; a number is a static
    scale.  ``lr_schedule(step)`` multiplies each optimizer's lr by its
    value at that network's 1-based step count.  A network whose
    ``forward`` takes a ``generator`` gets one per forward, seeded from
    ``rng_seed`` and the call index.  ``donate_state`` has nothing to
    choose: the state is always updated in place.  The iteration runs
    through the runtime executor (see the module docstring)."""
    d = _Net(netD, optD, half_dtype, keep_batchnorm_fp32,
             "make_gan_train_step(netD)")
    g = _Net(netG, optG, half_dtype, keep_batchnorm_fp32,
             "make_gan_train_step(netG)")
    dynamic = loss_scale == "dynamic"
    init_scale = (min(max_loss_scale, 2.0 ** 16) if dynamic
                  else float(loss_scale))
    dev = d.params[0].device
    zero_flag = torch.zeros((), dtype=torch.int32, device=dev)

    def finish(sub: StepState, grads, net):
        return apply_fused_update(
            sub, grads, net.update, dynamic=dynamic, init_scale=init_scale,
            scale_window=scale_window, min_loss_scale=min_loss_scale,
            max_loss_scale=max_loss_scale, zero_flag=zero_flag,
            lr_schedule=lr_schedule)

    def cast(x):
        if half_dtype is not None and x.is_floating_point():
            return x.to(half_dtype)
        return x

    def grads_of(loss, scale, leaves):
        grads = torch.autograd.grad(loss.float() * scale, leaves,
                                    allow_unused=True)
        return [torch.zeros_like(v) if gr is None else gr
                for v, gr in zip(leaves, grads)]

    # the four forwards' generators, seeded on the host before every call
    gens = [torch.Generator(device=dev) for _ in range(4)] \
        if d.takes_generator or g.takes_generator else []

    def seed_calls(call_index):
        for i, gen in enumerate(gens):
            gen.manual_seed(dropout_seed(rng_seed, 4 * call_index + i))

    def body(state: GanStepState, real, z):
        real, z = cast(real), cast(z)
        gs = gens or [None] * 4
        g_leaves = [v.detach().requires_grad_(True)
                    for v in model_vals_of(state.g)]
        d_leaves = [v.detach().requires_grad_(True)
                    for v in model_vals_of(state.d)]
        with disable_casts(), torch.enable_grad():
            # 1) the generator forward, kept for the generator step
            fake = g.run(g_leaves, z, gs[0])
            # 2) the discriminator step on real and detached fake
            errD = d_loss_fn(d.run(d_leaves, real, gs[1]),
                             d.run(d_leaves, fake.detach(), gs[2]))
            d_grads = grads_of(errD, state.d.scaler.loss_scale, d_leaves)
        finish(state.d, d_grads, d)
        # 3) the generator step through the updated discriminator
        with disable_casts(), torch.enable_grad():
            d_vals = [v.detach() for v in model_vals_of(state.d)]
            errG = g_loss_fn(d.run(d_vals, fake, gs[3]))
            g_grads = grads_of(errG, state.g.scaler.loss_scale, g_leaves)
        finish(state.g, g_grads, g)
        return errD.detach(), errG.detach()

    def raw_step_fn(state: GanStepState, call_index, real, z):
        seed_calls(call_index)
        return state, body(state, real, z)

    init_state = GanStepState(
        d=init_step_state(d.params, d.buffers, d.dtypes, d.opt_init,
                          init_scale),
        g=init_step_state(g.params, g.buffers, g.dtypes, g.opt_init,
                          init_scale))
    program = _executor.Program(
        "gan_train_step", (next(_GAN_TOKENS),), body, donate_argnums=(0,),
        generators=gens)
    return GanTrainStep(netD, netG, optD, optG, program, seed_calls,
                        raw_step_fn, (d.params, d.buffers),
                        (g.params, g.buffers), init_state)
