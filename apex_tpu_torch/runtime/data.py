"""Input pipeline: host-to-device prefetch, the PyTorch counterpart of
``apex_tpu/runtime/data.py`` (the reference examples' ``data_prefetcher``,
``examples/imagenet/main_amp.py``).

A background thread takes the loader's batches (and with ``accum_steps``
stacks K of them into one block) on the host.  The consumer copies each
into a pinned host buffer and from there to the card on a side CUDA
stream, while the step before it still runs; the step's stream waits for
the copy by an event, and the copy into a slot waits, by another event,
for the step that read the slot before.  ``depth`` slots are in flight:
2 overlaps the next window's copy with the current step, 1 serialises
them.  uint8 NHWC images cross as bytes and are normalised on the card,
``(x / 255 - mean) / std`` in fp32, into NCHW (or kept NHWC with
``channels_last``, the input of a ``nn.to_channels_last`` model), then
cast to ``half_dtype``.  The JAX package's native normaliser
(``csrc/runtime.cpp``) is not used.  On the CPU the same arithmetic runs
without streams.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..observe import spans as _spans

#: windows copied to the device by every prefetcher (one copy of the
#: images and the targets of a window counts one), and their bytes
COUNTS = {"h2d": 0, "h2d_bytes": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


class DataPrefetcher:
    """Wrap an iterable of ``(images, target)`` host batches; yields device
    tensors one window ahead of consumption (see the module docstring).

    ``images`` is uint8 NHWC (normalised on the device) or any float
    array (cast to ``half_dtype`` there); ``target`` any integer array.
    ``accum_steps=K`` delivers stacked ``(K, B, ...)`` blocks for
    ``make_train_step(accum_steps=K, accum_stacked=True)``, one copy a
    window; a trailing partial window is dropped.  ``next()`` returns
    ``(None, None)`` at the end, as the reference's does.  ``threads`` (the
    JAX native normaliser's) has nothing to choose here."""

    def __init__(self, loader, mean=None, std=None, half_dtype=None,
                 device=None, depth: int = 2, threads: int = 0,
                 channels_last: bool = False, accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.accum_steps = accum_steps
        self.channels_last = channels_last
        self.half_dtype = half_dtype
        self.device = resolve_device(device)
        self.depth = depth
        mean = [0.485, 0.456, 0.406] if mean is None else mean
        std = [0.229, 0.224, 0.225] if std is None else std
        self.mean = torch.tensor(np.asarray(mean, np.float32),
                                 device=self.device)
        self.std = torch.tensor(np.asarray(std, np.float32),
                                device=self.device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        # per slot: pinned host buffers, the copy's done event, the event
        # of the step that last read the slot
        self._slots = [dict(pinned=None, copied=None, read=None)
                       for _ in range(depth)]
        self._next_slot = 0
        self._inflight: list = []       # (slot, images, target) issued
        self._handed = None             # the slot the consumer holds
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._host_done = False
        self._worker = threading.Thread(target=self._run, args=(iter(loader),),
                                        daemon=True)
        self._worker.start()

    # -- the host thread ---------------------------------------------------

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, loader):
        try:
            window = []
            for images, target in loader:
                if self._stop.is_set():
                    return
                window.append((np.ascontiguousarray(images),
                               np.ascontiguousarray(target)))
                if len(window) < self.accum_steps:
                    continue
                if self.accum_steps == 1:
                    item = window[0]
                else:
                    item = (np.stack([w[0] for w in window]),
                            np.stack([w[1] for w in window]))
                window = []
                if not self._put(item):
                    return
        except Exception as e:  # surfaced in the consumer
            self._put(e)
            return
        self._put(None)

    # -- the device side ---------------------------------------------------

    def _prepare(self, x):
        """The device images in the output layout and dtype."""
        if x.dtype == torch.uint8 and x.dim() >= 4:
            x = (x.float() / 255.0 - self.mean) / self.std
            if not self.channels_last:
                x = x.movedim(-1, -3).contiguous()
        if self.half_dtype is not None and x.is_floating_point():
            x = x.to(self.half_dtype)
        return x

    def _issue(self) -> bool:
        """Start the copy of the next host window into the next slot;
        False at the end of the loader."""
        if self._host_done:
            return False
        item = self._q.get()
        if item is None:
            self._host_done = True
            return False
        if isinstance(item, Exception):
            self._host_done = True
            raise item
        images, target = (torch.from_numpy(a) for a in item)
        COUNTS["h2d"] += 1
        COUNTS["h2d_bytes"] += images.nbytes + target.nbytes
        fields = {} if self.accum_steps == 1 \
            else {"accum_steps": self.accum_steps}
        with _spans.span("h2d", **fields):
            return self._copy(images, target)

    def _copy(self, images, target) -> bool:
        """Issue the copy of one window (see :meth:`_issue`)."""
        if not self._cuda:
            self._inflight.append((None, self._prepare(images.clone()),
                                   target.clone()))
            return True
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % self.depth
        if slot["copied"] is not None:
            slot["copied"].synchronize()     # its pinned buffers are free
        pin = slot["pinned"]
        if pin is None or pin[0].shape != images.shape \
                or pin[1].shape != target.shape \
                or pin[0].dtype != images.dtype:
            pin = slot["pinned"] = (
                torch.empty(images.shape, dtype=images.dtype,
                            pin_memory=True),
                torch.empty(target.shape, dtype=target.dtype,
                            pin_memory=True))
        pin[0].copy_(images)
        pin[1].copy_(target)
        with torch.cuda.stream(self._stream):
            if slot["read"] is not None:
                self._stream.wait_event(slot["read"])
            x = pin[0].to(self.device, non_blocking=True)
            y = pin[1].to(self.device, non_blocking=True)
            x = self._prepare(x)
            done = torch.cuda.Event()
            done.record(self._stream)
        slot["copied"] = done
        self._inflight.append((slot, x, y))
        return True

    def next(self):
        if self._done:
            return None, None
        if self._handed is not None and self._cuda:
            # the steps enqueued since the last next() read that slot
            slot, x, y = self._handed
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            slot["read"] = ev
        self._handed = None
        while len(self._inflight) < self.depth and self._issue():
            pass
        if not self._inflight:
            self._done = True
            return None, None
        slot, x, y = self._inflight.pop(0)
        if self._cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(slot["copied"])
            x.record_stream(cur)
            y.record_stream(cur)
            self._handed = (slot, x, y)
        # the next window's copy goes out now, under this window's step
        while len(self._inflight) < self.depth - 1 and self._issue():
            pass
        return x, y

    def close(self):
        """Stop the host thread and drop queued windows (safe at any
        time)."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._worker.join(timeout=5)
        self._inflight.clear()

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass

    def __iter__(self):
        while True:
            inp, tgt = self.next()
            if inp is None:
                return
            yield inp, tgt
