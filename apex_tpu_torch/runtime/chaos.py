"""Deterministic, seedable fault injection (chaos), the PyTorch port's copy
of ``apex_tpu/runtime/chaos.py``: the same hook names, the same
``at=``/``after=``/``times=`` counting and the same seeded determinism.
Each firing is mirrored as a ``chaos.inject`` event into the observe
registry (outside the controller's lock, as in the JAX module), beside the
controller's ``log``.  Hook points that the port does not run yet (``host.loss``,
``coordinator.loss``, ``heartbeat.delay``, ``device.loss``,
``ckpt.reshard``, ``serve.session_snapshot`` and ``serve.migrate``, owned
by ROADMAP A9 and A10) keep their names in the tables below for the slices
that port them; ``serve.kv_handoff`` fires in
``resilience.stream_kv_handoff``.

The reference repo can claim "bitwise accurate" save/resume but cannot
*prove* it under failure: nothing in an eager CUDA stack can kill a save
mid-write on purpose, stall a collective, or force an overflow storm at a
chosen step.  Here every recovery path in the resilience runtime
(`runtime.resilience`, `parallel.distributed`) threads
through named hook points, and a :class:`ChaosController` installed for the
duration of a test decides — deterministically — what happens at each one.

Hook points currently wired (grep for ``chaos.hook(`` to enumerate):

====================  =====================================================
point                 fires
====================  =====================================================
``ckpt.mid_write``    half-way through the checkpoint payload write (tmp
                      file has partial bytes; final path untouched)
``ckpt.pre_rename``   payload fully written + fsynced, rename not yet done
``ckpt.post_rename``  checkpoint durable at its final path
``ckpt.reshard``      start of each component's cross-plan reshard during
                      elastic restore (disk already read; device
                      placement pending — a kill here must leave the
                      checkpoint loadable by the next attempt)
``ckpt.shard_write``  before each schema-3 shard file write
                      (``resilience.stream_components_to_dir``); a kill
                      here leaves a partial shard directory with NO
                      manifest — the previous checkpoint must stay the
                      newest valid one
``host.loss``         each cluster member's heartbeat tick
                      (``cluster.membership.Member.beat``); ``"kill"``
                      fells the host (it stops heartbeating and drops
                      out of the next membership epoch)
``coordinator.loss``  before each coordinator failure-detection scan
                      (``cluster.coordinator.Coordinator.scan``);
                      ``"kill"`` fells the coordinator — a successor
                      rebuilt over the same KV store must keep epochs
                      monotonic
``heartbeat.delay``   in the heartbeat path, after the liveness decision
                      is armed; a CALLABLE action's return value (or
                      ``delay_s``) skews that member's heartbeat
                      timestamp backwards — under ``miss_threshold``
                      consecutive misses this must NOT produce a new
                      membership epoch (false-positive guard)
``device.loss``       each elastic device-set detection
                      (``runtime.elastic.current_devices``); a CALLABLE
                      action's return value replaces the device set — an
                      int ``k`` keeps the first ``k`` devices, a sequence
                      becomes the set verbatim — simulating
                      preempt→shrink→regrow deterministically on the
                      8-virtual-CPU-device mesh
``dist.init``         before each ``torch.distributed`` init attempt
``dist.collective``   inside ``timed_flat_dist_call``'s worker thread
``train.step``        before each fused ``TrainStep.__call__`` dispatch
``amp.backward``      at ``scale_loss`` exit on the eager amp surface,
                      before gradients are unscaled
====================  =====================================================

Serve-fleet hook points (the elastic serving failure surface;
docs/resilience.md carries the failure-mode table):

==========================  ===============================================
point                       fires
==========================  ===============================================
``serve.kv_handoff``        before each KV block file of a streamed
                            handoff or session snapshot
                            (``resilience.stream_kv_handoff``); a kill
                            leaves a manifest-less shard directory the
                            adopter must reject, a fail is a recoverable
                            stream fault (the disagg coordinator discards
                            and re-streams once)
``serve.session_snapshot``  before each live-session KV snapshot the
                            serve fleet writes
                            (``serve.elastic.ServeFleet``); a kill fells
                            the snapshotting replica mid-cycle (its
                            debris must be rejected, the previous
                            committed snapshot stands), a fail skips this
                            round cleanly
``serve.migrate``           before each restore of a lost session into a
                            survivor's pool; a kill fells the ADOPTING
                            replica (the snapshot stays on shared storage
                            for the next epoch), a fail abandons the
                            restore cleanly — the session falls back to
                            the recompute re-prefill path
==========================  ===============================================

Actions: ``"kill"`` raises :class:`ChaosKilled` (a simulated preemption —
deliberately NOT a subclass of ``Exception``-wrapping framework errors, so
recovery code that catches "expected" failures still dies to it the way a
real SIGKILL would end the process); ``"fail"`` raises
:class:`ChaosInjectedFailure` (or a caller-supplied exception) — the
recoverable-error case retry loops must absorb; ``"delay"`` sleeps, for
timeout paths; ``"nonfinite_grads"`` is returned to the hook's caller,
which interprets it (the fused train step taints the batch so every
gradient goes non-finite).  A callable action is invoked with the hook
context and its return value handed back.

Zero cost when idle: every hook site guards on :func:`active`, one global
``is None`` check, so production steps pay nothing.

Usage (tests)::

    from apex_tpu_torch.runtime import chaos

    with chaos.session(seed=0) as c:
        c.on("ckpt.mid_write", action="kill")          # next save dies mid-write
        with pytest.raises(chaos.ChaosKilled):
            manager.save(step=5, model=model.state_dict())
    # controller uninstalled; c.log records every firing for assertions
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Optional

_ACTIONS = ("kill", "fail", "delay", "nonfinite_grads")


class ChaosError(RuntimeError):
    """Base class for injected faults."""


class ChaosKilled(ChaosError):
    """Simulated preemption/SIGKILL at a hook point.  Recovery code must
    treat this as process death: never catch it to continue the operation
    that was killed."""


class ChaosInjectedFailure(ChaosError):
    """Injected *recoverable* failure (a flaky peer, a full disk): the
    error retry/backoff paths are expected to absorb this one."""


class _Fault:
    __slots__ = ("point", "action", "at", "after", "times", "delay_s",
                 "probability", "exc")

    def __init__(self, point, action, at, after, times, delay_s,
                 probability, exc):
        if not (callable(action) or action in _ACTIONS):
            raise ValueError(f"unknown chaos action {action!r}; "
                             f"expected one of {_ACTIONS} or a callable")
        self.point = point
        self.action = action
        self.at = frozenset(at) if at is not None else None
        self.after = after
        self.times = times
        self.delay_s = delay_s
        self.probability = probability
        self.exc = exc

    def matches(self, count, rng):
        if self.times == 0:
            return False
        if self.at is not None:
            if count not in self.at:
                return False
        elif count < self.after:
            return False
        if self.probability < 1.0 and rng.random() >= self.probability:
            return False
        return True


class ChaosController:
    """Deterministic fault scheduler.

    ``seed`` drives the single ``random.Random`` consulted for
    probabilistic faults; with the default ``probability=1.0`` no
    randomness is consumed at all, so runs are reproducible by
    construction.  Each hook point keeps its own 0-based call counter
    (``counts``); faults select on it via ``at=`` (explicit indices) or
    ``after=`` (threshold).
    """

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._faults: list[_Fault] = []
        #: per-point hook-call counters (0-based index of the NEXT call)
        self.counts: dict[str, int] = {}
        #: every firing, as (point, call_index, action) — assert on this
        self.log: list[tuple] = []

    def on(self, point: str, action="kill", *, at=None, after: int = 0,
           times: Optional[int] = None, delay_s: float = 0.0,
           probability: float = 1.0,
           exc: Optional[BaseException] = None) -> "ChaosController":
        """Arm ``action`` at hook ``point``.

        ``at``: iterable of call indices (0-based, per point) to fire on;
        ``after``: fire on every call from this index (when ``at`` is None);
        ``times``: total firings before the fault disarms (-1 = unlimited;
        default: one per ``at`` index, else 1);
        ``delay_s``: sleep length for ``action="delay"``;
        ``probability``: per-eligible-call firing probability (seeded);
        ``exc``: exception instance for ``action="fail"``.
        Returns self for chaining.
        """
        if isinstance(at, int):
            at = (at,)
        if times is None:
            times = len(at) if at is not None else 1
        with self._lock:
            self._faults.append(_Fault(point, action, at, after, times,
                                       delay_s, probability, exc))
        return self

    def fire(self, point: str, **ctx):
        """Advance ``point``'s counter and run the first matching fault.
        Returns the action result (a string like ``"nonfinite_grads"``, a
        callable's return value, or None when nothing fired)."""
        with self._lock:
            count = self.counts.get(point, 0)
            self.counts[point] = count + 1
            fault = None
            for f in self._faults:
                if f.point == point and f.matches(count, self._rng):
                    if f.times > 0:
                        f.times -= 1
                    fault = f
                    break
            if fault is None:
                return None
            action_name = (fault.action if not callable(fault.action)
                           else getattr(fault.action, "__name__",
                                        "callable"))
            self.log.append((point, count, action_name))
        # mirrored into the observe registry outside the lock (a JSONL
        # sink may do IO), so injections land in the same event stream as
        # the telemetry they perturb
        from ..observe import registry as _obs
        _obs.event("chaos.inject", point=point, call=count,
                   action=action_name)
        if callable(fault.action):
            return fault.action(dict(ctx, point=point, call=count))
        if fault.action == "delay":
            time.sleep(fault.delay_s)
            return "delay"
        if fault.action == "kill":
            raise ChaosKilled(f"chaos: killed at {point!r} (call {count})")
        if fault.action == "fail":
            if fault.exc is not None:
                raise fault.exc
            raise ChaosInjectedFailure(
                f"chaos: injected failure at {point!r} (call {count})")
        return fault.action  # "nonfinite_grads" et al: caller interprets

    # -- installation ------------------------------------------------------
    def __enter__(self):
        install(self)
        return self

    def __exit__(self, *exc):
        uninstall(self)
        return False


_controller: Optional[ChaosController] = None


def active() -> bool:
    """True when a controller is installed — THE guard every hook site
    checks first, so idle cost is one global read."""
    return _controller is not None


def install(controller: ChaosController):
    global _controller
    if _controller is not None:
        raise RuntimeError("a ChaosController is already installed")
    _controller = controller


def uninstall(controller: Optional[ChaosController] = None):
    global _controller
    if controller is not None and _controller is not controller:
        return
    _controller = None


def hook(point: str, **ctx):
    """Fire hook ``point`` on the installed controller (no-op when none)."""
    c = _controller
    if c is None:
        return None
    return c.fire(point, **ctx)


@contextlib.contextmanager
def session(seed: int = 0):
    """``with chaos.session(seed=0) as c: c.on(...)`` — install a fresh
    controller for the scope, uninstall on exit (exception-safe)."""
    c = ChaosController(seed=seed)
    install(c)
    try:
        yield c
    finally:
        uninstall(c)
