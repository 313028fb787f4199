"""Adam / AdamW over a list of tensors: the CUDA kernel
``csrc/multi_tensor_adam.cu`` and its plain PyTorch version.

Port of ``apex_tpu/kernels/multi_tensor.py::fused_adam``: over
``[grads, params, exp_avgs, exp_avg_sqs]``, in fp32 and in the op order of
the JAX package's ``_adam_kernel``, with the derived scalars (1 - beta, the
bias corrections) computed by the JAX package's exact expressions and
entering as fp32 values (:func:`adam_scalars`): on the host when the step is
a Python number, on the device when it is a tensor, so a train step whose
step count lives on the card makes no host round trip.

Two differences from the JAX function, both of them what an in-place
update needs: p, m and v are updated in place (and returned), and the
``noop_flag`` is the skip flag: when it is set, every tensor is left as it
was (the JAX train step computes the update and then selects the old
values; the result is the same).  Like the reference, the update never
writes the flag.  The gradients, and each of p, m and v, are fp32, bf16 or
fp16 (one dtype a list): every value is updated in fp32 and written back in
its own dtype, as the JAX function casts its results back.  A CUDA tensor
launches the kernel, one launch per list of up to 256 tensors; a CPU tensor
takes :func:`fused_adam_reference`.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .dispatch import LAUNCHES, KERNEL_DTYPES, dtype_code, use_kernel

LAUNCHES.setdefault("fused_adam", 0)

# the slots of the fp32 scalar vector the kernel reads
LR, WD, B1, OMB1, B2, OMB2, EPS, BC1, BC2 = range(9)


def _static_nonzero(x) -> bool:
    """Whether a hyperparameter enters the update: False only for a Python
    zero (a tensor always counts, as a traced value does in the JAX
    package)."""
    return not (isinstance(x, (int, float)) and x == 0.0)


_SCALARS: collections.OrderedDict = collections.OrderedDict()


def _cached_vector(values, device):
    """An fp32 vector of ``values`` on ``device``, kept across calls (at
    most 64 of them), so a repeated call copies nothing to the card."""
    key = (tuple(values), str(device))
    t = _SCALARS.get(key)
    if t is None:
        t = torch.tensor(values, dtype=torch.float32).to(device)
        _SCALARS[key] = t
        if len(_SCALARS) > 64:
            _SCALARS.popitem(last=False)
    else:
        _SCALARS.move_to_end(key)
    return t


def adam_scalars(lr, beta1, beta2, eps, step, bias_correction, weight_decay,
                 device):
    """The nine fp32 scalars of the update (lr, wd, b1, 1 - b1, b2, 1 - b2,
    eps, bc1, bc2) as a (9,) tensor on ``device``; ``lr`` is a number or a
    device scalar.  Each is the JAX package's expression rounded to fp32:
    ``1 - beta ** step`` in double on the host for a Python ``step``,
    ``1 - f32(beta) ** f32(step)`` on the device for a tensor ``step``;
    weight decay enters as 0 when it is a Python zero."""
    if isinstance(lr, torch.Tensor):
        # a device lr (a scheduled one): the rest as for a number, then lr
        # put in its slot on the device
        rest = adam_scalars(0.0, beta1, beta2, eps, step, bias_correction,
                            weight_decay, device)
        lr_t = lr.to(device=device, dtype=torch.float32).reshape(1)
        return torch.cat([lr_t, rest[LR + 1:]])
    wd = weight_decay if _static_nonzero(weight_decay) else 0.0
    head = [lr, wd, beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps]
    for name, x in zip(("lr", "weight_decay", "beta1", "beta2", "eps"),
                       (lr, wd, beta1, beta2, eps)):
        if not isinstance(x, (int, float)):
            raise TypeError(f"adam_scalars: {name} must be a Python number "
                            f"(lr may be a tensor), got {type(x).__name__}")
    if not bias_correction:
        return _cached_vector(head + [1.0, 1.0], device)
    if isinstance(step, (int, float)):
        return _cached_vector(
            head + [1.0 - beta1 ** step, 1.0 - beta2 ** step], device)
    const = _cached_vector(head, device)
    stepf = step.to(device=device, dtype=torch.float32).reshape(())
    bc = 1.0 - const[B1:B2 + 1:B2 - B1] ** stepf    # (b1, b2), a view
    return torch.cat([const, bc])


def _sqrt_rn(x):
    """The correctly rounded fp32 square root, as the kernel's
    ``__fsqrt_rn``.  PyTorch's vectorised fp32 sqrt on the CPU misses it in
    the last bit for some inputs; the fp64 root rounded to fp32 is exact."""
    return torch.sqrt(x.double()).float()


def _adam_math(g, p, m, v, s, decoupled, use_wd):
    """One Adam / AdamW update of fp32 ``g, p, m, v`` with the scalars ``s``
    (0-dim fp32 tensors on their device), one rounding per operation in the
    op order of the kernel.  Returns the new (p, m, v)."""
    if use_wd and not decoupled:
        g = g + s[WD] * p
    m = s[B1] * m + s[OMB1] * g
    v = s[B2] * v + s[OMB2] * g * g
    update = (m / s[BC1]) / (_sqrt_rn(v / s[BC2]) + s[EPS])
    if use_wd and decoupled:
        update = update + s[WD] * p
    return p - s[LR] * update, m, v


def fused_adam_reference(noop_flag, tensor_lists, scal, mode, use_wd):
    """The plain version of the kernel: the same update in PyTorch
    operations on the scalar vector ``scal`` from :func:`adam_scalars`, in
    place, leaving every tensor untouched when ``noop_flag`` is set."""
    s = list(scal.unbind())
    skip = noop_flag.reshape(()) > 0
    with torch.no_grad():
        for g, p, m, v in zip(*tensor_lists):
            np_, nm, nv = _adam_math(g.float(), p.float(), m.float(),
                                     v.float(), s, mode == 1, use_wd)
            for dst, new in ((p, np_), (m, nm), (v, nv)):
                dst.copy_(torch.where(skip, dst, new.to(dst.dtype)))


def _validate(noop_flag, tensor_lists, mode):
    if len(tensor_lists) != 4:
        raise ValueError(f"fused_adam takes [grads, params, exp_avgs, "
                         f"exp_avg_sqs], got {len(tensor_lists)} lists")
    gs, ps, ms, vs = tensor_lists
    if not len(gs) == len(ps) == len(ms) == len(vs):
        raise ValueError(f"fused_adam: list lengths differ ({len(gs)}, "
                         f"{len(ps)}, {len(ms)}, {len(vs)})")
    if mode not in (0, 1):
        raise ValueError(f"fused_adam: mode must be 0 (L2) or 1 "
                         f"(decoupled), got {mode}")
    if not isinstance(noop_flag, torch.Tensor) or noop_flag.numel() != 1 \
            or noop_flag.dtype != torch.int32:
        raise TypeError("fused_adam: noop_flag must be a one-element int32 "
                        "tensor")
    for name, lst in (("gradients", gs), ("params", ps), ("exp_avgs", ms),
                      ("exp_avg_sqs", vs)):
        dtypes = {t.dtype for t in lst}
        if len(dtypes) > 1:
            raise TypeError(f"fused_adam: the {name} of one list share a "
                            f"dtype, got {sorted(map(str, dtypes))}")
    for i, (g, p, m, v) in enumerate(zip(*tensor_lists)):
        if g.dtype not in KERNEL_DTYPES:
            raise TypeError(f"fused_adam: gradient {i} dtype {g.dtype} not "
                            f"supported (float32, bfloat16 or float16)")
        for name, t in (("param", p), ("exp_avg", m), ("exp_avg_sq", v)):
            if t.dtype not in KERNEL_DTYPES:
                raise TypeError(f"fused_adam: {name} {i} dtype {t.dtype} not "
                                f"supported (float32, bfloat16 or float16)")
            if t.shape != g.shape:
                raise ValueError(f"fused_adam: {name} {i} shape "
                                 f"{tuple(t.shape)} != gradient shape "
                                 f"{tuple(g.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"fused_adam: {name} {i} must be "
                                 f"contiguous (it is updated in place)")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("multi_tensor_adam")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apex_adam_max_tensors.argtypes = []
    lib.apex_adam_max_tensors.restype = i
    lib.apex_adam_chunk.argtypes = []
    lib.apex_adam_chunk.restype = i
    lib.apex_adam.argtypes = [ctypes.POINTER(p), p, i, i, p, p] + [i] * 6 \
        + [p]
    lib.apex_adam.restype = i
    return lib


_TABLES: collections.OrderedDict = collections.OrderedDict()


def _table(ps, ms, vs, chunk):
    """The kernel's device table for one list (p, m, v addresses, sizes,
    chunk -> (tensor, offset) map) and its chunk count, kept across calls
    (at most 64 lists): the in-place updates keep the addresses, so a train
    step builds it once."""
    key = (ps[0].device.index,) + tuple(
        (p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel())
        for p, m, v in zip(ps, ms, vs))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit
    nt = len(ps)
    sizes = np.array([p.numel() for p in ps], np.int64)
    per = (sizes + chunk - 1) // chunk
    owner = np.repeat(np.arange(nt, dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    offset = (np.arange(owner.size, dtype=np.int64) - first) * chunk
    addrs = np.array([[t.data_ptr() for t in lst] for lst in (ps, ms, vs)],
                     np.int64).reshape(-1)
    flat = np.concatenate([addrs, sizes,
                           np.stack([owner, offset], 1).reshape(-1)])
    hit = (torch.from_numpy(flat).to(ps[0].device), int(owner.size))
    _TABLES[key] = hit
    if len(_TABLES) > 64:
        _TABLES.popitem(last=False)
    return hit


def _launch(noop_flag, tensor_lists, scal, mode, use_wd):
    lib = _lib()
    maxt, chunk = lib.apex_adam_max_tensors(), lib.apex_adam_chunk()
    gs, ps, ms, vs = tensor_lists
    flag = noop_flag.reshape(())
    with torch.cuda.device(ps[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, len(gs), maxt):
            sub = slice(i, i + maxt)
            table, nc = _table(ps[sub], ms[sub], vs[sub], chunk)
            if nc == 0:
                continue            # every tensor of the list is empty
            gsub = [g.contiguous() for g in gs[sub]]
            grads = (ctypes.c_void_p * len(gsub))(
                *[g.data_ptr() for g in gsub])
            err = lib.apex_adam(grads, table.data_ptr(), len(gsub), nc,
                                scal.data_ptr(), flag.data_ptr(),
                                dtype_code(gsub[0].dtype), int(use_wd),
                                int(mode == 1), dtype_code(ps[0].dtype),
                                dtype_code(ms[0].dtype),
                                dtype_code(vs[0].dtype), stream)
            _build.check(lib, err, "fused_adam")
            LAUNCHES["fused_adam"] += 1


def fused_adam(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
               mode: int, bias_correction: bool, weight_decay):
    """Adam (``mode`` 0, L2) or AdamW (``mode`` 1, decoupled) over
    ``tensor_lists = [grads, params, exp_avgs, exp_avg_sqs]``, in place;
    nothing changes when ``noop_flag`` (a one-element int32 tensor) is set.
    ``step`` is the 1-based step count, a Python int or a device tensor.
    Returns ``(noop_flag, params, exp_avgs, exp_avg_sqs)``."""
    _validate(noop_flag, tensor_lists, mode)
    gs, ps, ms, vs = tensor_lists
    if not gs:
        return noop_flag, [], [], []
    scal = adam_scalars(lr, beta1, beta2, eps, step, bias_correction,
                        weight_decay, ps[0].device)
    use_wd = _static_nonzero(weight_decay)
    if use_kernel(noop_flag, *gs, *ps, *ms, *vs):
        _launch(noop_flag, tensor_lists, scal, mode, use_wd)
    else:
        fused_adam_reference(noop_flag, tensor_lists, scal, mode, use_wd)
    return noop_flag, list(ps), list(ms), list(vs)
