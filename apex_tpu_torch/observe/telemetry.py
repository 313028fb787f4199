"""On-device step telemetry, the PyTorch counterpart of
``apex_tpu/observe/telemetry.py``.

The fused train step runs as one CUDA graph a batch signature
(``runtime.executor``), with no host sync inside.  Telemetry must not
break that, so the observable quantities (the window's loss, the global
gradient norm, the loss scale, the overflow count) are accumulated on the
device, in pure torch ops that a graph capture records, into five 0-d
tensors of the step's state (``StepState.telem``), and read back only
every ``drain_every`` windows (``TrainStep.drain_telemetry``).

Nothing here syncs with the host or allocates on the host; it is the one
piece of ``observe`` that runs inside a captured step.  The train step
copies :func:`accumulate`'s results into the state's own tensors, so a
replay writes the tensors the drain reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


_f32 = torch.float32


class StepTelemetry(NamedTuple):
    """On-device accumulator riding in ``StepState.telem``.

    - ``loss_sum``: sum of per-window mean losses since the last drain
      (the host divides by ``windows`` for the mean).
    - ``grad_norm``: global L2 norm of the *last* window's master
      gradients.
    - ``loss_scale``: loss scale after the last window's update.
    - ``overflow_count``: overflow-skipped windows since the last drain.
    - ``windows``: windows accumulated since the last drain.
    """
    loss_sum: torch.Tensor
    grad_norm: torch.Tensor
    loss_scale: torch.Tensor
    overflow_count: torch.Tensor
    windows: torch.Tensor


def init_telemetry(device=None) -> StepTelemetry:
    """A fresh accumulator on ``device`` (the card unless the caller asks
    for the CPU): zero sums and counts, a loss scale of 1."""
    from ..kernels.dispatch import resolve_device
    dev = resolve_device(device)
    return StepTelemetry(
        loss_sum=torch.zeros((), dtype=_f32, device=dev),
        grad_norm=torch.zeros((), dtype=_f32, device=dev),
        loss_scale=torch.ones((), dtype=_f32, device=dev),
        overflow_count=torch.zeros((), dtype=torch.int32, device=dev),
        windows=torch.zeros((), dtype=torch.int32, device=dev))


def reset_(telem: StepTelemetry) -> None:
    """Set ``telem`` back to :func:`init_telemetry`'s values in place (a
    captured step goes on writing these tensors)."""
    with torch.no_grad():
        telem.loss_sum.zero_()
        telem.grad_norm.zero_()
        telem.loss_scale.fill_(1.0)
        telem.overflow_count.zero_()
        telem.windows.zero_()


def global_grad_norm(grads) -> torch.Tensor:
    """The global L2 norm of ``grads`` as an fp32 0-d tensor: each
    tensor's norm taken in fp32 (``torch._foreach_norm`` with an fp32
    result reads a half gradient in its own dtype and accumulates in fp32;
    no fp32 copy is made), then the norm of those norms.  The one order of
    the sum: the step's accumulator and any recompute that is held to it
    bit for bit take the norm here."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros((), dtype=_f32)
    norms = torch._foreach_norm(grads, 2, dtype=_f32)
    return torch.linalg.vector_norm(torch.stack(norms))


def accumulate(telem: StepTelemetry, *, loss, master_grads, flag,
               loss_scale, mean_axes=(), grad_norm=None) -> StepTelemetry:
    """Fold one window's observables into new tensors (safe inside a
    graph capture).

    ``master_grads`` are the (unscaled) gradients the optimizer consumed;
    a half gradient is read in fp32 (:func:`global_grad_norm`), never
    summed in its own dtype.  ``flag`` is the window's overflow flag (1 =
    skipped).  ``mean_axes`` are the mesh axes the loss is averaged over,
    as the JAX step pmeans it: their product's ranks, resolved by
    :func:`apex_tpu_torch.parallel.mesh.resolve` (``"data"`` alone the
    default group unless an entered mesh names it; any other axis needs
    the mesh), where the loss is all-reduced and divided by their number
    (inside the capture, on the card); without ``torch.distributed`` the
    world is this one process, and an axis no mesh names raises.  Only the loss needs it: the
    gradients have been exchanged already, so every rank holds the same
    norm, flag and scale.  ``grad_norm``, where given, is the window's
    gradient norm computed by the caller (ZeRO's over the group, whose
    ``master_grads`` are this rank's shards) in place of the norm of
    ``master_grads``."""
    dev = telem.windows.device
    gnorm = (global_grad_norm(master_grads) if grad_norm is None
             else grad_norm).to(dev)
    loss = loss.detach().to(_f32).reshape(()) if loss is not None \
        else torch.zeros((), dtype=_f32, device=dev)
    if tuple(mean_axes):
        from ..parallel.mesh import resolve
        ax = resolve(tuple(mean_axes), "accumulate: mean_axes=")
        if dist.is_available() and dist.is_initialized():
            loss = loss.clone()
            dist.all_reduce(loss, group=ax.group)
            loss = loss / ax.size
    scale = loss_scale.detach().to(_f32).reshape(()) \
        if isinstance(loss_scale, torch.Tensor) \
        else torch.full((), float(loss_scale), dtype=_f32, device=dev)
    return StepTelemetry(
        loss_sum=telem.loss_sum + loss,
        grad_norm=gnorm,
        loss_scale=scale,
        overflow_count=telem.overflow_count
        + flag.reshape(()).to(torch.int32),
        windows=telem.windows + 1)
