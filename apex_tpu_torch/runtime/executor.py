"""The one-runtime executor, the PyTorch counterpart of
``apex_tpu/runtime/executor.py``: the one place that captures and replays
a ``torch.cuda.CUDAGraph``, as the JAX executor's ``_jit`` is the one
``jax.jit``.

A step is described by a :class:`Program` and handed to
:meth:`Executor.submit`, which resolves it through the step cache
(:mod:`.step_cache`: one entry a signature, a "compile" on a new one) and
counts one dispatch a call.  What an entry does with a call:

* On the card, the first call of a signature runs the program eagerly on a
  side stream (PyTorch's rule before a capture); it is also the step's
  first real dispatch.  The second call captures the program into a graph
  whose memory pool its program owns, then replays it.  Every later call
  copies its inputs into the graph's static input buffers and replays.  A
  capture that fails raises: nothing goes on eagerly in its place.
* On the CPU there is no graph: the same static-buffer body runs eagerly on
  every call, with the same counting.

The arguments in ``donate_argnums`` are held: the program updates their
tensors in place, so the graph reads and writes them where they lie, and a
held tensor that moved after the capture raises.  Every other tensor is
copied into a static buffer of the entry first.  A graph bakes every host
value in, so what changes from call to call on the host must reach the
program through its ``generators``: the caller seeds them before each
submit, and the graph, which registers them, draws what an eager call
seeded so would draw.  A graph also bakes in the addresses of the
device tensors that the kernel wrappers keep in caches of their own (the
multi-tensor kernels' scalar vectors and chunk tables): the entry holds
every such tensor the capture read (``kernels.dispatch.hold``), so a cache
that drops it later does not free memory the graph still reads.  The
launch counters of the kernel wrappers (``kernels.dispatch.LAUNCHES``)
count where the wrappers launch: the warm-up and the capture, not a
replay, which runs no Python.  A replay's outputs are its static output
tensors, so each is returned as a clone.

The train, serve and rollout kinds (:data:`TRAIN_KINDS`,
:data:`SERVE_KINDS`, :data:`ROLLOUT_KINDS`) run each dispatch inside
``observe.span("dispatch", kind=...)`` and heartbeat the stall watchdog
with the caller's ``step`` once the dispatch was enqueued; other kinds
span only under ``step_cache.set_dispatch_spans(True)`` and never
heartbeat.  :func:`drain_telemetry` is the train steps' one read-back of
their on-device telemetry.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .._unported import PARALLEL, refuse
from ..kernels import dispatch as _dispatch
from ..observe import registry as _obs
from ..observe import spans as _spans
from ..observe import telemetry as _obs_telemetry
from ..observe import watchdog as _obs_watchdog
from . import step_cache as _sc

#: program kinds that are whole-training-window dispatches: each gets a
#: ``span("dispatch")`` and a watchdog heartbeat
TRAIN_KINDS = frozenset({"train_step", "zero_train_step",
                         "gan_train_step"})

#: serving-loop kinds (``apex_tpu_torch.serve``): like the train kinds the
#: unit of forward progress, so every tick spans and heartbeats
SERVE_KINDS = frozenset({"prefill_step", "decode_step",
                         "draft_prefill_step", "spec_verify_step"})

#: rollout-loop kinds (``apex_tpu_torch.rollout``'s weight publish: the
#: masters copied into the serve parameters, one dispatch)
ROLLOUT_KINDS = frozenset({"weight_publish"})

_BEAT_KINDS = TRAIN_KINDS | SERVE_KINDS | ROLLOUT_KINDS

_UNSET = object()


class DonationPolicy:
    """The JAX package's buffer-donation setting, kept for its API.  The
    port's steps always update their state in place, which is what
    donation buys the JAX package: donation is always on, and a request to
    turn it off (to keep a step's input buffers) is refused."""

    def __init__(self, mode="auto"):
        self._mode = self._checked(mode)

    @staticmethod
    def _checked(mode):
        if mode not in (True, False, "auto"):
            raise ValueError(f"donation mode must be True/False/'auto', "
                             f"got {mode!r}")
        if mode is False:
            refuse("donation off (a step that keeps its input buffers)",
                   "the port's steps update their state in place")
        return mode

    @property
    def mode(self):
        return self._mode

    def set(self, mode) -> None:
        self._mode = self._checked(mode)

    @property
    def enabled(self) -> bool:
        return True

    def resolve(self, request) -> bool:
        """True for every request the port can honour."""
        self._checked(request)
        return True


#: process-global donation policy
donation = DonationPolicy()

# the overlap knobs: "h2d" double-buffers the input copies of
# Executor.drive; "gather" is the JAX package's ZeRO all-gather prefetch,
# accepted and resolved here with nothing to overlap: the port's ZeRO step
# (parallel/zero.py) gathers each sharded copy once a window, at its top
_OVERLAP = {"gather": "auto", "h2d": "auto"}


def set_overlap(gather=None, h2d=None) -> None:
    """Set the executor's overlap knobs, each True/False/"auto" (None
    leaves it)."""
    for name, mode in (("gather", gather), ("h2d", h2d)):
        if mode is None:
            continue
        if mode not in (True, False, "auto"):
            raise ValueError(f"overlap {name} mode must be "
                             f"True/False/'auto', got {mode!r}")
        _OVERLAP[name] = mode


def overlap_enabled(which: str, override=None) -> bool:
    """A knob resolved to a bool; ``override`` True/False wins.  "auto"
    turns a knob on where a card is present (on the CPU gloo runs a
    collective on its own thread, so there is nothing to hide it under;
    forcing it on there gives the same results)."""
    mode = _OVERLAP[which] if override in (None, "auto") else override
    if mode == "auto":
        return torch.cuda.is_available()
    return bool(mode)


class Program:
    """One step program: ``fn(*args)`` with the arguments in
    ``donate_argnums`` held (updated in place) and the others copied into
    static buffers, drawing only from ``generators`` (which the caller
    seeds before each submit).  ``static_key`` must capture every Python
    value ``fn`` closes over.  The JAX ``in_shardings``, ``out_shardings``
    and ``wrap`` (a planner's shard_map) are refused.

    The program owns its entries, and with them their graphs and memory
    pool: they are freed with it (and so with the step that holds it)."""

    __slots__ = ("kind", "static_key", "fn", "donate_argnums", "generators",
                 "_entries", "_pool", "__weakref__")

    def __init__(self, kind: str, static_key, fn: Callable, *,
                 donate_argnums: Tuple[int, ...] = (), generators=(),
                 in_shardings=_UNSET, out_shardings=_UNSET,
                 wrap: Optional[Callable] = None):
        if in_shardings is not _UNSET or out_shardings is not _UNSET \
                or wrap is not None:
            refuse("Program(in_shardings=, out_shardings=, wrap=)", PARALLEL)
        self.kind = kind
        self.static_key = static_key
        self.fn = fn
        self.donate_argnums = tuple(donate_argnums)
        self.generators = tuple(generators)
        self._entries: dict = {}
        self._pool = None

    def entries(self):
        """This program's entries, one a signature."""
        return list(self._entries.values())


# the entry whose warm-up or capture is under way on this thread, so that
# code inside a step (nn.checkpoint_forward's rewind) can reach it
_active = threading.local()


def rewind_twins(gens):
    """For a rewind of the generators ``gens`` inside a step (a
    recomputation that must draw again what the forward drew):

    * outside any capture, None: rewind them by their states.  In an
      entry's warm-up this also notes each generator's offset from where
      the step started it.
    * inside a capture, one generator a generator of ``gens``, registered
      with the graph: draw the recomputation from these.  Before every
      replay each takes its parent's seed and offset plus the offset the
      warm-up noted, so that it draws what its parent drew at the call.

    A rewound generator must be one of the program's ``generators``."""
    entry = getattr(_active, "entry", None)
    if entry is None:
        return None
    if getattr(_active, "graph", None) is None:
        entry.note_rewind(gens)
        return None
    return entry.take_twins(gens)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Entry:
    """One signature of one program: its static input buffers and, on the
    card, its graph.  ``captures``, ``replays``, ``capture_s`` (host
    seconds of the capture) and ``pool_bytes`` (the card memory the
    capture reserved) describe it."""

    def __init__(self, program: Program, args):
        leaves, _ = tree_flatten(args)
        held = set()
        for i in program.donate_argnums:
            held.update(id(t) for t in _tensors(args[i]))
        self._held = [isinstance(t, torch.Tensor) and id(t) in held
                      for t in leaves]
        self._buffers = [None] * len(leaves)
        self.cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
                        for t in leaves)
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.capture_s = None
        self.pool_bytes = None
        self.error = None
        self._graph = None
        self._out = None
        # the cached device tensors the capture read, held for the graph
        self._kept: list = []
        self._held_ptrs = None
        self._gens = program.generators
        # the rewinds of the warm-up: per rewind, (generator index, offset
        # from the step's start) a generator; then their twins
        self._rewinds: list = []
        self._twins: list = []
        self._cursor = 0

    def _static_args(self, args):
        """``args`` with every non-held tensor replaced by this entry's
        static buffer holding its value."""
        leaves, spec = tree_flatten(args)
        out = []
        for i, (t, held) in enumerate(zip(leaves, self._held)):
            if not isinstance(t, torch.Tensor) or held:
                out.append(t)
                continue
            buf = self._buffers[i]
            if buf is None:
                buf = self._buffers[i] = torch.empty_like(t)
            if buf is not t:
                buf.copy_(t)
            out.append(buf)
        return tree_unflatten(out, spec), leaves

    def _check_held(self, leaves):
        ptrs = [t.data_ptr() for t, h in zip(leaves, self._held) if h]
        if self._held_ptrs is None:
            self._held_ptrs = ptrs
        elif ptrs != self._held_ptrs:
            raise RuntimeError(
                "a held (donated) argument of a captured program lies at "
                "another address than at its capture: the graph would "
                "update the old tensors; keep the state's tensors and "
                "update them in place")

    def run(self, program: Program, args):
        if self.error is not None:
            raise RuntimeError(f"this program's capture failed: "
                               f"{self.error}")
        static, leaves = self._static_args(args)
        if not self.cuda:
            self.calls += 1
            return program.fn(*static)
        self._check_held(leaves)
        cur = torch.cuda.current_stream()
        if self.calls == 0:
            out = self._warm_up(program, static, cur)
        elif self._graph is None:
            out = self._capture(program, static, cur)
        else:
            self._seed_twins()
            self._graph.replay()
            self.replays += 1
            out = tree_map(lambda t: t.clone()
                           if isinstance(t, torch.Tensor) else t, self._out)
        self.calls += 1
        return out

    def note_rewind(self, gens):
        plan = []
        for g in gens:
            idx = next((i for i, pg in enumerate(self._gens) if pg is g),
                       None)
            if idx is None:
                raise RuntimeError(
                    "a rewind inside a captured step draws from a generator "
                    "the step's program does not own; pass the step's "
                    "generator on")
            plan.append((idx, g.get_offset() - self._start[idx]))
        self._rewinds.append(plan)

    def take_twins(self, gens):
        if self._cursor >= len(self._twins):
            raise RuntimeError("the capture rewinds more often than its "
                               "warm-up did")
        plan = self._twins[self._cursor]
        self._cursor += 1
        if [self._gens[i] for i, _, _ in plan] != list(gens):
            raise RuntimeError("the capture rewinds other generators than "
                               "its warm-up did")
        return [twin for _, _, twin in plan]

    def _seed_twins(self):
        for plan in self._twins:
            for idx, k, twin in plan:
                parent = self._gens[idx]
                twin.manual_seed(parent.initial_seed())
                twin.set_offset(parent.get_offset() + k)

    def _warm_up(self, program, static, cur):
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        self._start = [g.get_offset() for g in self._gens]
        self._rewinds = []
        _active.entry = self
        try:
            with torch.cuda.stream(side):
                out = program.fn(*static)
        finally:
            _active.entry = None
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
        return out

    def _capture(self, program, static, cur):
        if program._pool is None:
            program._pool = torch.cuda.graph_pool_handle()
        # kept after its instantiation, so that graph_dot can read back
        # the kernels a replay launches
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in program.generators:
            graph.register_generator_state(gen)
        self._twins = [
            [(idx, k, torch.Generator(device=self._gens[idx].device))
             for idx, k in plan] for plan in self._rewinds]
        for plan in self._twins:
            for _, _, twin in plan:
                graph.register_generator_state(twin)
        self._cursor = 0
        # torch.cuda.graph empties the allocator's cache before it
        # captures; emptied here first, the reserved memory's rise is the
        # pool's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        _active.entry, _active.graph = self, graph
        # no cycle collection inside the capture: a graph freed there (an
        # earlier program's, in a dead reference cycle) destroys its
        # executable while the stream captures, which invalidates this
        # capture (CUDA error 901 at the next launch)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _dispatch.holding(self._kept), \
                    torch.cuda.graph(graph, pool=program._pool):
                out = program.fn(*static)
            graph.instantiate()
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
            raise RuntimeError(
                f"capturing the {program.kind} program failed; it does not "
                f"run eagerly in its place: {self.error}") from e
        finally:
            if collecting:
                gc.enable()
            _active.entry = _active.graph = None
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self._graph, self._out = graph, out
        self.captures += 1
        if self._cursor != len(self._twins):
            raise RuntimeError("the capture rewound less often than its "
                               "warm-up did")
        self._seed_twins()
        graph.replay()
        self.replays += 1
        return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, out)


class Executor:
    """The dispatch choke point over a :class:`~.step_cache.StepCache`;
    the process-global :data:`executor` is the one the library uses."""

    def __init__(self, cache: Optional[_sc.StepCache] = None):
        self._cache = cache if cache is not None else _sc.step_cache

    @property
    def cache(self) -> _sc.StepCache:
        return self._cache

    def stats(self) -> dict:
        """The step cache's counters."""
        return self._cache.stats()

    def compile(self, program: Program, args):
        """The entry of ``program`` for ``args`` (a new one counted as a
        compile, an existing one as a cache hit), without dispatching."""
        sig = _sc.signature(args)

        def build():
            entry = program._entries.get(sig)
            if entry is None:
                entry = program._entries[sig] = _Entry(program, args)
            return entry
        entry = self._cache.program(program.kind, program.static_key, args,
                                    build)
        if program._entries.get(sig) is not entry:
            # a live entry of another program under the same key: each
            # program replays only its own graph
            entry = build()
        return entry

    def submit(self, program: Program, args, *, step: Optional[int] = None):
        """Compile-or-hit, count one dispatch, span, run, heartbeat (see
        the module docstring).  ``step``: the caller's 1-based step count
        for the watchdog heartbeat of the train and serve kinds, sent
        after the dispatch was enqueued (execution is asynchronous; a card
        that stops blocks the host at its next synchronizing call)."""
        entry = self.compile(program, args)
        self._cache._bump("dispatches", program.kind)
        beat = program.kind in _BEAT_KINDS
        if beat or _sc._DISPATCH_SPANS:
            with _spans.span("dispatch", kind=program.kind):
                out = entry.run(program, args)
        else:
            out = entry.run(program, args)
        if beat and step is not None:
            _obs_watchdog.heartbeat(step=step)
        return out

    def drive(self, step, loader, *, max_steps: Optional[int] = None,
              **prefetch_kwargs):
        """Run ``step`` over a loader with the next window's host-to-device
        copy in flight under the current step: a
        :class:`~.data.DataPrefetcher` is used as it is, any other iterable
        of host batches is wrapped in one (``prefetch_kwargs`` passed on;
        ``depth`` 2 where ``overlap_enabled("h2d")``, else 1).  Returns the
        list of the steps' losses."""
        from .data import DataPrefetcher
        own = not isinstance(loader, DataPrefetcher)
        if own:
            prefetch_kwargs.setdefault(
                "depth", 2 if overlap_enabled("h2d") else 1)
            loader = DataPrefetcher(loader, **prefetch_kwargs)
        losses = []
        try:
            for batch in loader:
                losses.append(step(*batch))
                if max_steps is not None and len(losses) >= max_steps:
                    break
        finally:
            if own:
                loader.close()
        return losses


#: process-global executor shared by every step
executor = Executor()


def graph_stats(program: Program) -> dict:
    """A program's captures, replays, capture seconds and pool bytes,
    summed over its entries."""
    es = program.entries()
    return dict(entries=len(es), captures=sum(e.captures for e in es),
                replays=sum(e.replays for e in es),
                capture_s=sum(e.capture_s or 0.0 for e in es),
                pool_bytes=sum(e.pool_bytes or 0 for e in es))


def graph_dot(program: Program) -> list:
    """The DOT text that ``cudaGraphDebugDotPrint`` writes of each of
    ``program``'s captured graphs: their nodes, each kernel node named by
    its function, i.e. the launches of one replay."""
    import os
    import tempfile
    import warnings
    out = []
    for e in program.entries():
        if e._graph is None:
            continue
        with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
            # torch warns on every dump that it is a debugging call
            warnings.simplefilter("ignore", UserWarning)
            path = os.path.join(d, "graph.dot")
            e._graph.enable_debug_mode()
            e._graph.debug_dump(path)
            with open(path) as f:
                out.append(f.read())
    return out


def read_telemetry(telem) -> dict:
    """The five scalars of a :class:`~apex_tpu_torch.observe.telemetry.
    StepTelemetry` on the host, through one device-to-host copy (a
    ``torch.stack`` in fp64, which holds the int32 counts exactly, and one
    ``.cpu()``: the only host sync of the telemetry path)."""
    host = torch.stack([t.to(torch.float64) for t in telem]).cpu().tolist()
    return dict(zip(telem._fields, host))


def drain_telemetry(step) -> Optional[dict]:
    """Read a step's on-device telemetry accumulator to the host and reset
    it, for every step kind with ``.state.telem`` and ``.calls``.

    One read (:func:`read_telemetry`); then a ``train.telemetry`` event, the
    ``train.loss`` / ``train.grad_norm`` / ``train.loss_scale`` gauges and
    the ``train.overflow_windows`` counter, as in the JAX package.  The
    accumulator is reset **in place** (``zero_`` / ``fill_``), where the JAX
    drain rebinds a fresh one: a captured step goes on writing the tensors
    it was captured with.  Returns the record, or None when telemetry is
    off or no window completed since the last drain."""
    telem = step.state.telem
    if telem is None:
        return None
    host = read_telemetry(telem)
    windows = int(host["windows"])
    if windows == 0:
        return None
    rec = _obs.event(
        "train.telemetry",
        step=step.calls,
        windows=windows,
        loss_mean=float(host["loss_sum"]) / windows,
        grad_norm=float(host["grad_norm"]),
        loss_scale=float(host["loss_scale"]),
        overflow_count=int(host["overflow_count"]))
    _obs.gauge("train.loss").set(rec["loss_mean"])
    _obs.gauge("train.grad_norm").set(rec["grad_norm"])
    _obs.gauge("train.loss_scale").set(rec["loss_scale"])
    _obs.counter("train.overflow_windows").inc(rec["overflow_count"])
    _obs_telemetry.reset_(telem)
    return rec
