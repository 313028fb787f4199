"""Device rule, launch counters and masking constants for the kernels.

The counterpart of ``apex_tpu/kernels/dispatch.py``, cut to what a first
slice needs.  There is no tier policy here: a tensor on the card launches
the hand-written kernel (or the wrapper raises), and a tensor that the
caller put on the CPU takes the kernel's plain PyTorch version.  No
threshold measured on a TPU decides anything on the card.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# the masked-vocabulary convention of the JAX package: a logit at
# MASKED_FILL means "this column does not exist"; consumers treat anything
# at or below MASKED_LOGIT_THR as masked
MASKED_FILL = -1e30
MASKED_LOGIT_THR = -1e29

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


# launches per kernel: each wrapper registers its kernel's name when its
# module is imported and adds one where it launches the kernel, nowhere else
LAUNCHES: dict = {}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def counts() -> dict:
    return dict(LAUNCHES)


# the list that keeps, for the CUDA graph being captured on this thread,
# the cached device tensors it reads (see hold)
_holder = threading.local()


@contextlib.contextmanager
def holding(keep: list):
    """While the block runs, :func:`hold` appends to ``keep``: a graph's
    capture, whose owner holds ``keep`` as long as the graph lives."""
    prev = getattr(_holder, "keep", None)
    _holder.keep = keep
    try:
        yield keep
    finally:
        _holder.keep = prev


def hold(t):
    """``t``, a device tensor a wrapper keeps in a cache of its own and
    hands to a kernel, kept alive for as long as the CUDA graph being
    captured lives (inside :func:`holding`; elsewhere nothing is kept): a
    graph bakes in the addresses it read, and a cache that drops ``t``
    later must not free memory the graph still reads."""
    keep = getattr(_holder, "keep", None)
    if keep is not None:
        keep.append(t)
    return t


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Without CUDA and without ``device="cpu"`` this raises
    instead of carrying on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device


def use_kernel(*tensors) -> bool:
    """The device rule: True when every given tensor lies on one CUDA
    device (launch the kernel), False when all lie on the CPU (take the
    plain version).  Anything else raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devs}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def is_dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill ``t.numel()`` consecutive places of its
    storage, each once, in some order of its dims: a contiguous tensor, a
    ``torch.channels_last`` one, any permutation of a contiguous one."""
    if t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last):
        return True
    order = sorted(range(t.dim()), key=t.stride, reverse=True)
    return t.permute(order).is_contiguous()


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` have one shape and put each element at the
    same place of their storage (strides equal along every dim longer than
    1: a size-1 dim's stride places nothing)."""
    if a.stride() == b.stride():
        return a.shape == b.shape
    return a.shape == b.shape and all(
        x == y for x, y, n in zip(a.stride(), b.stride(), a.shape) if n > 1)


def check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32, "
                        f"bfloat16 or float16)")


def dtype_code(dtype: torch.dtype) -> int:
    """The dtype code the C entry points take."""
    return KERNEL_DTYPES.index(dtype)
