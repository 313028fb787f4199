"""Stall watchdog: a heartbeat thread that notices when training or
serving stops, the port's copy of ``apex_tpu/observe/watchdog.py``.

The train step and the executor's train and serve dispatches call
:func:`heartbeat` after each enqueue; :class:`StallWatchdog` polls and,
when no heartbeat lands within ``deadline_s``, emits one typed
``watchdog.stall`` diagnostic carrying the last open span, the last
completed step, the backend and a remediation hint, then stays quiet
until progress resumes (one diagnostic a stall, not one a poll).

A heartbeat comes after the enqueue returns, so a card that stops
(a hung kernel, a collective whose peer never joined) shows as the host
blocking at its next synchronizing call with no heartbeat after it.  The
watchdog's thread makes no CUDA call: the device's name is read once, on
the starting thread, in :meth:`StallWatchdog.start`, so a diagnostic
never waits behind the card it reports on.

``heartbeat()`` is a lock and two stores: cheap enough to call every
step.  It is host-side instrumentation.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from . import registry as _registry
from . import spans as _spans

STALL_HINT = (
    "the host made no progress within the deadline: a kernel on the card "
    "may be hung, or a collective may be waiting for a peer that never "
    "joined it (a rank that died or never reached the same call); check "
    "the last span below for the phase that stopped making progress, and "
    "the other ranks' logs for the first one that stopped"
)

_hb_lock = threading.Lock()
_last_beat: Optional[float] = None
_last_step: Optional[int] = None


def heartbeat(step: Optional[int] = None) -> None:
    """Record forward progress; called after each train or serve
    dispatch."""
    global _last_beat, _last_step
    with _hb_lock:
        _last_beat = time.monotonic()
        if step is not None:
            _last_step = step


def last_heartbeat():
    with _hb_lock:
        return _last_beat, _last_step


def _backend_name() -> str:
    """The card's name (``torch.cuda.get_device_name``) where CUDA is
    present, else ``"cpu"``."""
    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception as e:       # a broken driver: say so, do not raise
        return f"unavailable: {type(e).__name__}"
    return "cpu"


class StallWatchdog:
    """Daemon thread firing a diagnostic when heartbeats stop.

    >>> wd = StallWatchdog(deadline_s=30.0)
    >>> wd.start()
    ... # train; TrainStep.__call__ heartbeats automatically
    >>> wd.stop()
    """

    def __init__(self, deadline_s: float, poll_s: Optional[float] = None,
                 on_stall: Optional[Callable[[Dict[str, Any]], None]] = None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else self.deadline_s / 4.0
        self.on_stall = on_stall
        self.stalls: list = []       # diagnostics, for tests / callers
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start_time: Optional[float] = None
        self._fired_for: Optional[float] = None   # beat we already flagged
        self._backend: Optional[str] = None

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._backend = _backend_name()
        self._start_time = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="apex-tpu-torch-stall-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 4 + 1.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            beat, step = last_heartbeat()
            anchor = beat if beat is not None else self._start_time
            silence = time.monotonic() - anchor
            if silence < self.deadline_s:
                continue
            if self._fired_for == anchor:
                continue             # already diagnosed this stall
            self._fired_for = anchor
            self._fire(silence, step)

    def _fire(self, silence_s: float, step: Optional[int]) -> None:
        diag = {
            "deadline_s": self.deadline_s,
            "since_last_step_s": silence_s,
            "last_step": step,
            "last_span": _spans.last_span(),
            "backend": self._backend,
            "hint": STALL_HINT,
        }
        self.stalls.append(diag)
        _registry.event("watchdog.stall", **diag)
        if self.on_stall is not None:
            try:
                self.on_stall(diag)
            except Exception:
                pass                 # a bad callback must not kill the thread
