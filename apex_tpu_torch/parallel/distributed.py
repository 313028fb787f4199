"""Data parallelism on ``torch.distributed``, the PyTorch counterpart of
``apex_tpu/parallel/distributed.py`` (and of the reference's
``apex/parallel/distributed.py``).

One difference of model.  The JAX package is single-controller: one
process drives every device, ``DistributedDataParallel`` takes the global
batch and shards it over a mesh axis, and XLA inserts the gradient
all-reduce into the compiled backward.  The port is one process per card,
as NVIDIA Apex is: each rank runs its own forward and backward on its own
shard of the batch, and the wrapper exchanges the gradients.
:meth:`DistributedDataParallel.shard_batch` returns this rank's slice of a
global batch, so the mean of the exchanged gradients equals the JAX
package's global-batch gradient.

The exchange runs inside ``backward()``, as NVIDIA Apex's does: a hook on
each parameter (``register_post_accumulate_grad_hook``) marks its gradient
ready; buckets of about ``message_size`` elements, one dtype each, in the
reverse order of the parameters, are all-reduced as soon as they and every
bucket before them are ready, and a final flush queued on the autograd
engine (``queue_callback``) exchanges what is left and waits for every
exchange.  With ``delay_allreduce=True`` there is one exchange at the end
instead.  Either way every exchanged gradient is in place when
``backward()`` returns, so amp's ``scale_loss`` exit, which unscales right
after, sees exchanged gradients.  With :meth:`DistributedDataParallel.
attach_optimizer` the exchange waits for the end of an accumulation window
instead; under amp it still comes before the unscale, so every rank sees
the same gradients and makes the same overflow-skip decision (the JAX
package decides once for all devices; one process per card must exchange
first to do the same).  On the card the backend is NCCL;
``init_distributed`` never falls back to gloo there.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from .._unported import PARALLEL, accept_defaults
from ..kernels.dispatch import is_dense, resolve_device
from ..runtime import chaos as _chaos
from ..runtime.resilience import CollectiveTimeoutError, DistributedInitError


def world_size(group=None) -> int:
    """Ranks in ``group`` (the default group), 1 without
    ``torch.distributed``."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group`` (the default group), 0 without
    ``torch.distributed``."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def num_processes() -> int:
    """Processes of the job: one per card, so the world size."""
    return world_size()


def _env_int(*names):
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: Optional[float] = None,
                     max_retries: Optional[int] = None,
                     backoff_s: float = 1.0,
                     backoff_factor: float = 2.0,
                     max_backoff_s: float = 30.0,
                     device=None,
                     _initialize=None):
    """Start ``torch.distributed`` from explicit arguments or the
    environment the ``apex_tpu_torch.parallel.multiproc`` launcher exports,
    with a bounded retry loop.

    ``coordinator_address`` (``host:port``) defaults to
    ``APEX_TPU_COORDINATOR``, else ``MASTER_ADDR:MASTER_PORT``;
    ``num_processes`` to ``APEX_TPU_NUM_PROCESSES``, else ``WORLD_SIZE``;
    ``process_id`` to ``APEX_TPU_PROCESS_ID``, else ``RANK``.  The backend
    is NCCL on the card (each process takes the card ``LOCAL_RANK`` names)
    and gloo when ``device="cpu"``: a card never falls back to gloo.
    Attempts are retried with exponential backoff (``backoff_s``, times
    ``backoff_factor``, at most ``max_backoff_s``) until ``max_retries``
    more attempts (``APEX_TPU_INIT_RETRIES``, default 4) or the deadline
    ``timeout_s`` (``APEX_TPU_INIT_TIMEOUT``, default 300 s) run out;
    then :class:`DistributedInitError` names the coordinator, the rank,
    the process count, the attempts and the last error.  Chaos hook
    ``dist.init`` fires before every attempt (``"fail"`` is retried,
    ``"kill"`` propagates).  After a successful start the rank announces
    itself in the default store (:func:`announce_presence`).
    ``_initialize`` replaces ``torch.distributed.init_process_group`` in
    tests."""
    dev = resolve_device(device)
    if coordinator_address is None:
        coordinator_address = os.environ.get("APEX_TPU_COORDINATOR")
        if coordinator_address is None and "MASTER_ADDR" in os.environ:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("APEX_TPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("APEX_TPU_PROCESS_ID", "RANK")
    if timeout_s is None:
        timeout_s = float(os.environ.get("APEX_TPU_INIT_TIMEOUT", 300.0))
    if max_retries is None:
        max_retries = int(os.environ.get("APEX_TPU_INIT_RETRIES", 4))
    if _initialize is None:
        _initialize = dist.init_process_group
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else dev)

    deadline = time.monotonic() + timeout_s
    delay = backoff_s
    last_exc = None
    attempt = -1
    for attempt in range(max_retries + 1):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            if _chaos.active():
                _chaos.hook("dist.init", attempt=attempt)
            _initialize(backend=backend,
                        init_method=f"tcp://{coordinator_address}",
                        world_size=num_processes, rank=process_id,
                        timeout=datetime.timedelta(
                            seconds=max(1, int(remaining))))
            announce_presence()
            return backend
        except _chaos.ChaosKilled:
            raise           # simulated preemption: die like the real thing
        except Exception as e:  # noqa: BLE001: every init failure retries
            last_exc = e
            sleep = min(delay, max_backoff_s,
                        max(deadline - time.monotonic(), 0.0))
            if sleep > 0 and attempt < max_retries:
                time.sleep(sleep)
            delay *= backoff_factor
    raise DistributedInitError(
        f"init_distributed gave up after {attempt + 1} attempt(s) / "
        f"{timeout_s:.0f}s deadline (coordinator="
        f"{coordinator_address!r}, process_id={process_id}, "
        f"num_processes={num_processes}): {last_exc}") from last_exc


#: the presence registry's keys in the default store, one a rank
_PRESENCE = "apex_tpu/members/"
#: test seam: when set, a callable returning the list of missing ranks
_PRESENCE_PROBE = None


def _store():
    if not dist.is_initialized():
        return None
    try:
        return dist.distributed_c10d._get_default_store()
    except Exception:       # noqa: BLE001: no store, no registry
        return None


def announce_presence():
    """Register this rank in the presence registry, a key a rank in
    ``torch.distributed``'s default store holding the hostname
    (best-effort; nothing without ``torch.distributed``).
    ``init_distributed`` calls it after a successful start, so that a
    later collective timeout can name the ranks that never arrived."""
    store = _store()
    if store is None:
        return
    import socket
    try:
        store.set(f"{_PRESENCE}{rank()}", socket.gethostname())
    except Exception:       # noqa: BLE001: best-effort
        pass


def missing_ranks() -> Optional[list]:
    """Ranks with no registration in the presence registry, or None when
    that cannot be told (one process, no store)."""
    if _PRESENCE_PROBE is not None:
        return _PRESENCE_PROBE()
    store = _store()
    if store is None:
        return None
    try:
        return [r for r in range(world_size())
                if not store.check([f"{_PRESENCE}{r}"])]
    except Exception:       # noqa: BLE001: the store cannot tell
        return None


def split_by_type(tensors):
    """Tensors bucketed by dtype, in order (the reference's
    ``split_half_float_double``, with bfloat16)."""
    buckets = {}
    for t in tensors:
        buckets.setdefault(t.dtype, []).append(t)
    return list(buckets.values())


def _flat(t):
    """``t``'s elements as one 1-d tensor in the order they lie in memory:
    a view of a dense tensor of any layout (a channels-last gradient is not
    transposed into logical order), else a copy in logical order."""
    if is_dense(t):
        return t.as_strided((t.numel(),), (1,))
    return t.reshape(-1)


def _like(piece, t):
    """The 1-d ``piece`` that :func:`_flat` made of ``t``, as a tensor of
    ``t``'s shape and layout (a view; logical order where ``t`` is not
    dense)."""
    if is_dense(t):
        return piece.as_strided(t.shape, t.stride())
    return piece.view(t.shape)


def apply_flat_dist_call(bucket, call, extra_args=None):
    """Apply ``call`` to one flattened buffer of ``bucket`` (one dtype) and
    return the results cut back into the tensors' shapes and layouts; each
    tensor enters the buffer in its memory order, so a channels-last one
    is neither transposed in nor out."""
    flat = torch.cat([_flat(t) for t in bucket])
    flat = call(flat) if extra_args is None else call(flat, *extra_args)
    out, offset = [], 0
    for t in bucket:
        out.append(_like(flat[offset:offset + t.numel()], t))
        offset += t.numel()
    return out


def flat_dist_call(tensors, call, extra_args=None):
    """:func:`apply_flat_dist_call` over each dtype bucket of ``tensors``;
    the results in the order of the buckets."""
    out = []
    for bucket in split_by_type(tensors):
        out.extend(apply_flat_dist_call(bucket, call, extra_args))
    return out


def timed_flat_dist_call(tensors, call, extra_args=None,
                         timeout_s: float = 60.0):
    """:func:`flat_dist_call` with a deadline: the collective runs on a
    worker thread, and past ``timeout_s`` a
    :class:`~apex_tpu_torch.runtime.resilience.CollectiveTimeoutError`
    names this rank, the world size and the ranks missing from the
    presence registry (:func:`announce_presence`) where it can.  Chaos
    hook ``dist.collective`` fires inside the worker (``"delay"`` is the
    slow peer).  The abandoned worker is a daemon thread: the caller is
    expected to checkpoint and die or start again, not to retry the
    wedged collective."""
    import threading
    box = {}

    def worker():
        try:
            if _chaos.active():
                _chaos.hook("dist.collective")
            box["out"] = flat_dist_call(tensors, call, extra_args)
        except BaseException as e:  # surfaced below
            box["exc"] = e

    t = threading.Thread(target=worker, daemon=True,
                         name="apex-tpu-torch-collective")
    t.start()
    t.join(timeout_s)
    if "exc" in box:
        raise box["exc"]
    if "out" in box:
        return box["out"]
    missing = missing_ranks()
    suspect = (f"ranks never present in the presence registry: {missing}"
               if missing
               else "missing rank unknown (no presence registry — single "
                    "process or init_distributed not used)")
    raise CollectiveTimeoutError(
        f"collective did not complete within {timeout_s:g}s on rank "
        f"{rank()} of {world_size()} process(es); {suspect}")


def _exchange(flat, group, always_fp32, predivide_factor, average,
              async_op=False):
    """All-reduce ``flat`` with the DDP knobs: widened to fp32 first with
    ``always_fp32``, divided by ``predivide_factor`` before the sum and
    multiplied by ``predivide_factor / world`` after it with ``average``
    (the JAX package's order).  Returns ``(work, finish)``: ``finish()``
    gives the exchanged buffer in ``flat``'s dtype once ``work`` is done."""
    buf = flat.float() if always_fp32 and flat.dtype != torch.float32 \
        else flat
    if predivide_factor != 1.0:
        buf = buf / predivide_factor
    work = dist.all_reduce(buf, group=group, async_op=async_op)

    def finish():
        out = buf
        if average:
            out = out * (predivide_factor / dist.get_world_size(group))
        return out.to(flat.dtype)
    return work, finish


def all_reduce_mean(tensors, group=None, always_fp32: bool = False,
                    predivide_factor: float = 1.0, average: bool = True,
                    mesh=None):
    """The mean (``average``) or sum of ``tensors`` over the ranks of
    ``group``, one flattened exchange per dtype, honouring the DDP dtype
    and predivide knobs.  Returns new tensors; without
    ``torch.distributed`` (one process) the tensors themselves.  The JAX
    package's ``mesh`` is taken at None only: ``group`` plays its part."""
    accept_defaults("all_reduce_mean: a JAX mesh", PARALLEL,
                    mesh=(mesh, None))
    if not dist.is_initialized() or not tensors:
        return list(tensors)

    def call(flat):
        _, finish = _exchange(flat, group, always_fp32, predivide_factor,
                              average)
        return finish()
    out = dict()
    for bucket in split_by_type(tensors):
        for t, r in zip(bucket, apply_flat_dist_call(bucket, call)):
            out[id(t)] = r
    return [out[id(t)] for t in tensors]


def broadcast_module(module, group=None, src: int = 0):
    """Every parameter and buffer of ``module`` overwritten with rank
    ``src``'s, in place (one flattened broadcast per dtype)."""
    tensors = [t.data for t in list(module.parameters())
               + list(module.buffers())]
    if not dist.is_initialized() or not tensors:
        return

    def call(flat):
        dist.broadcast(flat, src=src, group=group)
        return flat
    with torch.no_grad():
        for t, r in zip([t for b in split_by_type(tensors) for t in b],
                        flat_dist_call(tensors, call)):
            t.copy_(r)


class Reducer:
    """Manual gradient averaging (reference ``distributed.py:89-126``):
    ``reduce()`` averages the wrapped module's gradients, or a list of
    tensors in place, over the ranks."""

    def __init__(self, module_or_grads_list, group=None,
                 allreduce_always_fp32: bool = False,
                 gradient_predivide_factor: float = 1.0, mesh=None):
        accept_defaults("Reducer: a JAX mesh", PARALLEL, mesh=(mesh, None))
        self.group = group
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_predivide_factor = gradient_predivide_factor
        if isinstance(module_or_grads_list, torch.nn.Module):
            self.module = module_or_grads_list
            broadcast_module(self.module, group)
        else:
            self.module = None
            self.grads = list(module_or_grads_list)

    def reduce(self):
        if self.module is not None:
            params = [p for p in self.module.parameters()
                      if p.grad is not None]
            new = all_reduce_mean(
                [p.grad for p in params], self.group,
                always_fp32=self.allreduce_always_fp32,
                predivide_factor=self.gradient_predivide_factor)
            for p, g in zip(params, new):
                p.grad = g
        else:
            new = all_reduce_mean(
                self.grads, self.group,
                always_fp32=self.allreduce_always_fp32,
                predivide_factor=self.gradient_predivide_factor)
            with torch.no_grad():
                for t, g in zip(self.grads, new):
                    t.copy_(g)


class DistributedDataParallel(torch.nn.Module):
    """Module wrapper for data-parallel training, one process per card
    (reference ``apex/parallel/distributed.py:129``).

    Construction broadcasts rank 0's parameters and buffers; the backward
    exchanges the gradients in buckets (see the module docstring).
    ``exchanges`` counts the all-reduce calls the wrapper has made.
    ``process_group`` picks the group (default: every rank).  The
    reference's options for its own buckets, streams and buffers
    (``allreduce_trigger_params``, ``retain_allreduce_buffers``,
    ``num_allreduce_streams``, ``allreduce_communicators``,
    ``gradient_average_split_factor``, ``prof``) are checked as it checks
    them, and any other value than their default raises
    ``NotImplementedError``, as does the JAX package's ``mesh`` other than
    None."""

    def __init__(self, module: torch.nn.Module, message_size: int = 10000000,
                 delay_allreduce: bool = False,
                 shared_param: Optional[bool] = None,
                 allreduce_trigger_params=None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators=None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 gradient_average_split_factor=None,
                 prof: bool = False,
                 process_group=None,
                 mesh=None):
        super().__init__()
        accept_defaults("DistributedDataParallel: a JAX mesh", PARALLEL,
                        mesh=(mesh, None))
        if shared_param is not None:
            raise ValueError(
                "shared_param is no longer supported as an option.  It was "
                "misleadingly named and didn't do what it claimed to do.  "
                "The new behavior is shared_param=True.")
        if allreduce_communicators is not None:
            if len(allreduce_communicators[0]) != num_allreduce_streams or \
                    not isinstance(allreduce_communicators[1], (list, tuple)):
                raise ValueError("allreduce_communicators must be a tuple "
                                 "(groups, streams) matching "
                                 "num_allreduce_streams")
        if delay_allreduce and num_allreduce_streams > 1:
            raise ValueError("Setting delay_allreduce=True makes "
                             "num_allreduce_streams irrelevant.")
        if allreduce_trigger_params is not None and delay_allreduce:
            raise ValueError("Setting allreduce_trigger_params is only valid "
                             "if delay_allreduce=False.")
        unported = [name for name, value, default in (
            ("allreduce_trigger_params", allreduce_trigger_params, None),
            ("retain_allreduce_buffers", retain_allreduce_buffers, False),
            ("num_allreduce_streams", num_allreduce_streams, 1),
            ("allreduce_communicators", allreduce_communicators, None),
            ("gradient_average_split_factor", gradient_average_split_factor,
             None),
            ("prof", prof, False)) if value != default]
        if unported:
            raise NotImplementedError(
                f"DistributedDataParallel: {', '.join(unported)} not ported "
                f"(the exchange uses its own buckets, one stream, and no "
                f"retained buffers)")
        if not dist.is_initialized():
            raise RuntimeError(
                "DistributedDataParallel needs torch.distributed: call "
                "apex_tpu_torch.parallel.init_distributed() (or "
                "torch.distributed.init_process_group) first")

        self.module = module
        self.message_size = message_size
        self.delay_allreduce = delay_allreduce
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.process_group = process_group
        self.exchanges = 0
        # with attach_optimizer the exchange moves to the end of the window
        # (amp's unscale or optimizer.step(), whichever comes first)
        self._exchange_in_backward = True
        self._window_open = False

        # amp tags on the wrapped module, mirrored as the JAX wrapper does
        # (the port's amp casts through hooks on the module itself, which
        # a call through this wrapper runs)
        for attr in ("_amp_input_cast_dtype", "_amp_output_cast_dtype",
                     "_amp_policy"):
            if hasattr(module, attr):
                setattr(self, attr, getattr(module, attr))

        broadcast_module(module, process_group)
        self._params = [p for p in module.parameters() if p.requires_grad]
        self._buckets = self._make_buckets()
        self._bucket_of = {id(p): b for b, bucket in enumerate(self._buckets)
                           for p in bucket}
        self._reset_backward_state()
        for p in self._params:
            p.register_post_accumulate_grad_hook(self._grad_ready)

    # -- buckets --------------------------------------------------------
    def _make_buckets(self):
        """Buckets of about ``message_size`` elements, one dtype each, in
        the reverse order of the parameters (the order backward tends to
        produce their gradients)."""
        buckets, open_ = [], {}
        for p in reversed(self._params):
            b = open_.setdefault(p.dtype, [])
            b.append(p)
            if sum(q.numel() for q in b) >= self.message_size:
                buckets.append(b)
                open_[p.dtype] = []
        buckets += [b for b in open_.values() if b]
        return buckets

    def _reset_backward_state(self):
        self._ready = [0] * len(self._buckets)
        self._next_bucket = 0
        self._pending = []
        self._callback_queued = False

    def _grad_ready(self, param):
        if not self._exchange_in_backward:
            self._window_open = True
            return
        if not self._callback_queued:
            self._callback_queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish_backward)
        if self.delay_allreduce:
            return
        b = self._bucket_of[id(param)]
        self._ready[b] += 1
        # launch in bucket order, so every rank issues the same sequence
        while self._next_bucket < len(self._buckets) and \
                self._ready[self._next_bucket] == \
                len(self._buckets[self._next_bucket]):
            self._launch(self._buckets[self._next_bucket])
            self._next_bucket += 1

    def _launch(self, bucket):
        params = [p for p in bucket if p.grad is not None]
        if not params:
            return
        flat = torch.cat([_flat(p.grad) for p in params])
        work, finish = _exchange(
            flat, self.process_group, self.allreduce_always_fp32,
            self.gradient_predivide_factor, self.gradient_average,
            async_op=True)
        self.exchanges += 1
        self._pending.append((params, work, finish))

    def _finish_pending(self):
        """Wait for every exchange launched and write its result back into
        the gradients it was made from."""
        pending, self._pending = self._pending, []
        for params, work, finish in pending:
            work.wait()
            out, offset = finish(), 0
            with torch.no_grad():
                for p in params:
                    n = p.grad.numel()
                    p.grad.copy_(_like(out[offset:offset + n], p.grad))
                    offset += n

    def _finish_backward(self):
        """The flush at the end of backward: exchange every bucket not yet
        exchanged (all of them with ``delay_allreduce``), wait, and write
        the exchanged gradients back."""
        try:
            for bucket in self._buckets[self._next_bucket:]:
                self._launch(bucket)
            self._finish_pending()
        finally:
            self._reset_backward_state()

    # -- the API ------------------------------------------------------
    def shard_batch(self, x):
        """This rank's slice of a global batch (leading dimension split in
        equal parts, in rank order)."""
        n = world_size(self.process_group)
        if x.shape[0] % n:
            raise ValueError(f"shard_batch: batch {x.shape[0]} does not "
                             f"split over {n} ranks")
        per = x.shape[0] // n
        r = rank(self.process_group)
        return x[r * per:(r + 1) * per]

    def allreduce_gradients(self):
        """Exchange the wrapped module's ``.grad``s now, with the wrapper's
        knobs: one exchange per dtype (the reference's end-of-backward
        fallback, ``distributed.py:491-510``)."""
        self._window_open = False
        params = [p for p in self._params if p.grad is not None]
        if not params:
            return
        for bucket in split_by_type(params):
            self._launch(bucket)
        self._finish_pending()

    def exchange_window(self):
        """Exchange the gradients that backward has made since the last
        exchange, if there are any.  With :meth:`attach_optimizer`, amp
        calls this before it unscales (at ``scale_loss``'s exit, or at a
        ``step()`` that finalizes a delayed unscale), and ``step()`` calls
        it before it updates; the first of them exchanges the window."""
        if self._window_open:
            self.allreduce_gradients()

    def attach_optimizer(self, optimizer):
        """Move the exchange to the end of the accumulation window: backward
        exchanges nothing, and the window's accumulated ``.grad``s are
        exchanged once, by :meth:`exchange_window`, before amp unscales
        them or else at ``optimizer.step()``.  Requires
        ``delay_allreduce=True``.  Under K-microbatch accumulation
        (``amp.scale_loss(delay_unscale=True)`` K - 1 times, one ``step()``)
        that is one exchange per window.

        Unlike the JAX package's, where one controller decides for every
        device, each rank decides amp's overflow skip on its own: the
        exchange therefore comes before amp's unscale and overflow check,
        so every rank checks the same gradients and skips the same window
        (which has been exchanged all the same).  Returns the optimizer."""
        if not self.delay_allreduce:
            raise ValueError(
                "attach_optimizer requires delay_allreduce=True — with "
                "eager per-backward exchange semantics a step-boundary "
                "allreduce would exchange the same gradients twice")
        if getattr(optimizer, "_ddp_attached", None) is self:
            return optimizer
        inner_step = optimizer.step

        def step_with_exchange(closure=None):
            self.exchange_window()
            return inner_step() if closure is None else inner_step(closure)

        optimizer.step = step_with_exchange
        optimizer._ddp_attached = self
        self._exchange_in_backward = False
        return optimizer

    def forward(self, *inputs, **kwargs):
        return self.module(*inputs, **kwargs)
