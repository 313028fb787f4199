"""Adam / AdamW and momentum SGD over a list of tensors: the CUDA kernels
``csrc/multi_tensor_adam.cu`` and ``csrc/multi_tensor_sgd.cu`` and their
plain PyTorch versions.

Port of ``apex_tpu/kernels/multi_tensor.py::fused_adam``: over
``[grads, params, exp_avgs, exp_avg_sqs]``, in fp32 and in the op order of
the JAX package's ``_adam_kernel``, with the derived scalars (1 - beta, the
bias corrections) computed by the JAX package's exact expressions and
entering as fp32 values (:func:`adam_scalars`): on the host when the step is
a Python number, on the device when it is a tensor, so a train step whose
step count lives on the card makes no host round trip.

Port of ``apex_tpu/kernels/multi_tensor.py::fused_sgd``: over ``[grads,
params, momenta]`` or, with a half model copy of the params written in the
same pass, ``[grads, master_params, momenta, model_params]``, in fp32 and in
the op order of ``_sgd_kernel`` (:func:`fused_sgd`).  Its gradients may mix
dtypes within one list (bf16 conv gradients beside fp32 BatchNorm ones):
the kernel reads each tensor's gradient in its own dtype.

Two differences from the JAX functions, both of them what an in-place
update needs: the tensors are updated in place (and returned), and the
``noop_flag`` is the skip flag: when it is set, every tensor is left as it
was (the JAX functions compute the update and the caller or the function
then selects the old values; the result is the same).  Neither update
writes the flag.  Every value is updated in fp32 and written back in its
own dtype, as the JAX functions cast their results back.  A CUDA tensor
launches the kernel, one launch per list of up to 256 tensors; a CPU tensor
takes the plain version (:func:`fused_adam_reference`,
:func:`fused_sgd_reference`).

The kernels walk each tensor as one span of its elements, so any dense
layout is theirs: a list of ``torch.channels_last`` conv weights, with
their gradients, slots and copies in the same layout, is updated where it
lies.  The wrappers take exactly that (:func:`check_layouts`) and raise on
anything else; no gradient is copied into another layout.

Both kernels cut each tensor into chunks of one size, one 256-thread block
a chunk, which :func:`_chunk_for` picks per list and card: a power of two
of elements that moves at most ``CHUNK_BYTES``, halved where the list would
give the card fewer than ``CHUNKS_PER_SM`` chunks an SM, down to
``MIN_CHUNK``.  Both updates are elementwise, so the chunk changes no bit
of the result.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .dispatch import (LAUNCHES, KERNEL_DTYPES, decide, dtype_code, hold,
                       is_dense, kernel_probe, multi_tensor_fp,
                       register_kernel, same_layout, use_kernel)

LAUNCHES.setdefault("fused_adam", 0)
LAUNCHES.setdefault("fused_sgd", 0)

register_kernel(
    "multi_tensor_sgd",
    xla_fallback="apex_tpu_torch.kernels.multi_tensor.fused_sgd_reference",
    threshold_probe=kernel_probe,
    doc="B11: packed momentum-SGD group update (fused_sgd)")
register_kernel(
    "multi_tensor_adam",
    xla_fallback="apex_tpu_torch.kernels.multi_tensor.fused_adam_reference",
    threshold_probe=kernel_probe,
    doc="B12: packed Adam/AdamW group update (fused_adam)")


def group_fp(op: str, params, grads) -> str:
    """The ledger key of one multi-tensor launch: the op, the list's
    elements and tensors, the gradients' dtype (the JAX ``group_fp``)."""
    return multi_tensor_fp(op, sum(p.numel() for p in params), len(params),
                           grads[0].dtype)

# the slots of the fp32 scalar vector the kernel reads
LR, WD, B1, OMB1, B2, OMB2, EPS, BC1, BC2 = range(9)

# the chunk a list is cut into: the largest power of two of elements whose
# reads and writes come to at most CHUNK_BYTES (2048 elements in fp32, 4096
# with half parameters and moments: the sizes that timed fastest on the
# H100 at every list from DCGAN's 0.66 M values to GPT-2 small's 124 M; a
# smaller block of work shortens the last wave of blocks; PERF.md), halved
# while the list gives fewer than CHUNKS_PER_SM chunks an SM, down to
# MIN_CHUNK; each a multiple of 8, so an aligned tensor keeps every chunk's
# vector accesses aligned in every dtype
CHUNK_BYTES = 65536
CHUNKS_PER_SM = 4
MIN_CHUNK = 1024


def _static_nonzero(x) -> bool:
    """Whether a hyperparameter enters the update: False only for a Python
    zero (a tensor always counts, as a traced value does in the JAX
    package)."""
    return not (isinstance(x, (int, float)) and x == 0.0)


_SCALARS: collections.OrderedDict = collections.OrderedDict()


def _cached_vector(values, device):
    """An fp32 vector of ``values`` on ``device``, kept across calls (at
    most 64 of them), so a repeated call copies nothing to the card; a
    CUDA graph that reads it holds it (``hold``)."""
    key = (tuple(values), str(device))
    t = _SCALARS.get(key)
    if t is None and _capturing(device):
        # a copy from the host cannot be captured into a CUDA graph: the
        # graph fills the vector itself
        return torch.stack([torch.full((), v, dtype=torch.float32,
                                       device=device) for v in values])
    if t is None:
        t = torch.tensor(values, dtype=torch.float32).to(device)
        _SCALARS[key] = t
        if len(_SCALARS) > 64:
            _SCALARS.popitem(last=False)
    else:
        _SCALARS.move_to_end(key)
    return hold(t)


def _capturing(device) -> bool:
    return torch.device(device).type == "cuda" and \
        torch.cuda.is_current_stream_capturing()


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


def check_layouts(op, i, param, others):
    """The layout rule of both kernels, which walk each tensor as one span
    of ``numel`` elements from its first: param ``i`` must be dense (any
    order of its dims: contiguous, ``torch.channels_last``, ...), and each
    ``(name, tensor)`` of ``others``, the i-th tensor of each other list,
    must have its layout.  Nothing is copied into another layout: a
    channels-last list is updated where it lies, anything else raises,
    naming the tensor."""
    stride = param.stride()
    if all(t.stride() == stride for _, t in others) and is_dense(param):
        return                  # the common case, in few calls
    if not is_dense(param):
        raise ValueError(
            f"{op}: param {i} (shape {tuple(param.shape)}, strides "
            f"{param.stride()}) is not dense; it is updated in place as "
            f"one span of its elements")
    for name, t in others:
        if not same_layout(t, param):
            raise ValueError(
                f"{op}: {name} {i} has strides {t.stride()}, param {i} "
                f"{param.stride()} (shape {tuple(param.shape)}): every "
                f"tensor of the i-th place takes the param's layout")


def _validate_adam(noop_flag, tensor_lists, mode):
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
        check_layouts("fused_adam", i, p, [("gradient", g), ("exp_avg", m),
                                           ("exp_avg_sq", v)])


@functools.lru_cache(maxsize=None)
def _adam_lib():
    lib = _build.load("multi_tensor_adam")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apex_adam_max_tensors.argtypes = []
    lib.apex_adam_max_tensors.restype = i
    lib.apex_adam_chunk.argtypes = []
    lib.apex_adam_chunk.restype = i
    lib.apex_adam.argtypes = [ctypes.POINTER(p), p, i, i, i, p, p] \
        + [i] * 6 + [p]
    lib.apex_adam.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    """The SM count of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _step_bytes(tensor_lists):
    """The bytes an update moves per element of ``tensor_lists`` ([grads,
    ...]), near enough to size its chunks by: the widest gradient read, and
    each other list read and written."""
    return max(g.element_size() for g in tensor_lists[0]) \
        + 2 * sum(lst[0].element_size() for lst in tensor_lists[1:])


@functools.lru_cache(maxsize=256)
def _chunk_cached(sizes, sms, step_bytes, largest):
    chunk = 1 << (min(largest, CHUNK_BYTES // step_bytes).bit_length() - 1)
    while chunk > MIN_CHUNK and \
            sum(-(-n // chunk) for n in sizes) < CHUNKS_PER_SM * sms:
        chunk //= 2
    return chunk


def _chunk_for(sizes, sms, step_bytes, largest=65536):
    """The chunk, in elements, that a launch over tensors of ``sizes``
    elements, moving ``step_bytes`` bytes per element, on a card of ``sms``
    SMs cuts them into: the largest power of two at most ``largest`` (the
    most the library takes) and ``CHUNK_BYTES / step_bytes`` at which they
    give at least ``CHUNKS_PER_SM * sms`` chunks, or ``MIN_CHUNK`` where
    none does."""
    return _chunk_cached(tuple(int(n) for n in sizes), int(sms),
                         int(step_bytes), int(largest))


_TABLES: collections.OrderedDict = collections.OrderedDict()


def _table(first, second, third, chunk):
    """A kernel's device table for one list of tensors (the addresses of
    the tensors of ``first``, ``second`` and ``third``, a ``None`` list
    giving null addresses; the sizes of ``first``; the chunk -> (tensor,
    offset) map, for chunks of ``chunk`` elements) and its chunk count,
    kept across calls (at most 64 lists): the in-place updates keep the
    addresses, so a train step builds it once.  A CUDA graph that reads a
    table holds it (``hold``)."""
    lists = (first, second, third)
    addrs = np.array([[0] * len(first) if lst is None else
                      [t.data_ptr() for t in lst] for lst in lists],
                     np.int64)
    key = (first[0].device.index, addrs.tobytes(),
           tuple(t.numel() for t in first), chunk)
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        hold(hit[0])
        return hit
    nt = len(first)
    sizes = np.array([t.numel() for t in first], np.int64)
    per = (sizes + chunk - 1) // chunk
    owner = np.repeat(np.arange(nt, dtype=np.int64), per)
    start = np.repeat(np.cumsum(per) - per, per)
    offset = (np.arange(owner.size, dtype=np.int64) - start) * chunk
    flat = np.concatenate([addrs.reshape(-1), sizes,
                           np.stack([owner, offset], 1).reshape(-1)])
    hit = (torch.from_numpy(flat).to(first[0].device), int(owner.size))
    _TABLES[key] = hit
    if len(_TABLES) > 64:
        _TABLES.popitem(last=False)
    hold(hit[0])
    return hit


def _launch_adam(noop_flag, tensor_lists, scal, mode, use_wd):
    gs, ps, ms, vs = tensor_lists
    decide("multi_tensor_adam", group_fp("adam", ps, gs), ps[0].device)
    lib = _adam_lib()
    maxt, largest = lib.apex_adam_max_tensors(), lib.apex_adam_chunk()
    flag = noop_flag.reshape(())
    sms = _sms(ps[0].device.index)
    with torch.cuda.device(ps[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, len(gs), maxt):
            sub = slice(i, i + maxt)
            chunk = _chunk_for([t.numel() for t in ps[sub]], sms,
                               _step_bytes([lst[sub] for lst in tensor_lists]),
                               largest)
            table, nc = _table(ps[sub], ms[sub], vs[sub], chunk)
            if nc == 0:
                continue            # every tensor of the list is empty
            gsub = gs[sub]
            grads = (ctypes.c_void_p * len(gsub))(
                *[g.data_ptr() for g in gsub])
            err = lib.apex_adam(grads, table.data_ptr(), len(gsub), nc,
                                chunk, scal.data_ptr(), flag.data_ptr(),
                                dtype_code(gsub[0].dtype), int(use_wd),
                                int(mode == 1), dtype_code(ps[0].dtype),
                                dtype_code(ms[0].dtype),
                                dtype_code(vs[0].dtype), stream)
            _build.check(lib, err, "fused_adam")
            LAUNCHES["fused_adam"] += 1


def fused_adam(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
               mode: int, bias_correction: bool, weight_decay, *,
               bias_corrections=None):
    """Adam (``mode`` 0, L2) or AdamW (``mode`` 1, decoupled) over
    ``tensor_lists = [grads, params, exp_avgs, exp_avg_sqs]``, in place;
    nothing changes when ``noop_flag`` (a one-element int32 tensor) is set.
    ``step`` is the 1-based step count, a Python int or a device tensor;
    ``bias_corrections``, two fp32 device scalars, replace its ``1 - beta
    ** step`` (amp's deferred mode).  Returns ``(noop_flag, params,
    exp_avgs, exp_avg_sqs)``."""
    _validate_adam(noop_flag, tensor_lists, mode)
    gs, ps, ms, vs = tensor_lists
    if not gs:
        return noop_flag, [], [], []
    if bias_correction and bias_corrections is not None:
        head = adam_scalars(lr, beta1, beta2, eps, 1, False, weight_decay,
                            ps[0].device)
        scal = torch.cat([head[:BC1], torch.stack(
            [b.reshape(()).float() for b in bias_corrections])])
    else:
        scal = adam_scalars(lr, beta1, beta2, eps, step, bias_correction,
                            weight_decay, ps[0].device)
    use_wd = _static_nonzero(weight_decay)
    if use_kernel(noop_flag, *gs, *ps, *ms, *vs):
        _launch_adam(noop_flag, tensor_lists, scal, mode, use_wd)
    else:
        fused_adam_reference(noop_flag, tensor_lists, scal, mode, use_wd)
    return noop_flag, list(ps), list(ms), list(vs)


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

# the slots of the fp32 scalar vector the SGD kernel reads
SGD_LR, SGD_WD, SGD_SCALE, SGD_MOM, SGD_OMD = range(5)
_COPY_DTYPES = (torch.bfloat16, torch.float16)


def sgd_scalars(lr, weight_decay, scale, momentum, dampening, device):
    """The five fp32 scalars of the SGD update (lr, wd, scale, momentum,
    1 - dampening) as a (5,) tensor on ``device``.  ``lr`` and ``scale``
    are numbers or device scalars (a scheduled lr, an amp scale), ``wd`` a
    number or a device scalar (0 when it is a Python zero); ``momentum`` and
    ``dampening`` are Python numbers, and ``1 - dampening`` is taken in
    double before its rounding to fp32, as the JAX kernel's Python float
    is."""
    for name, x in (("momentum", momentum), ("dampening", dampening)):
        if not isinstance(x, (int, float)):
            raise TypeError(f"sgd_scalars: {name} must be a Python number, "
                            f"got {type(x).__name__}")
    wd = weight_decay if _static_nonzero(weight_decay) else 0.0
    vals = [lr, wd, scale, momentum, 1.0 - dampening]
    if all(isinstance(v, (int, float)) for v in vals):
        return _cached_vector(vals, device)
    return torch.stack([
        v.to(device=device, dtype=torch.float32).reshape(())
        if isinstance(v, torch.Tensor)
        else torch.full((), v, dtype=torch.float32, device=device)
        for v in vals])


def _sgd_math(g, p, m, s, has_mom, nesterov, first_run, wd_after, use_wd):
    """One SGD update of fp32 ``g, p, m`` with the scalars ``s`` (0-dim
    fp32 tensors on their device), one rounding per operation in the op
    order of the kernel.  Returns the new (p, m); m is returned as it came
    without momentum."""
    gf = g * s[SGD_SCALE]
    if use_wd and not wd_after:
        gf = gf + s[SGD_WD] * p
    upd = gf
    if has_mom:
        m = gf if first_run else s[SGD_MOM] * m + s[SGD_OMD] * gf
        upd = gf + s[SGD_MOM] * m if nesterov else m
    if use_wd and wd_after:
        upd = upd + s[SGD_WD] * p
    return p - s[SGD_LR] * upd, m


def fused_sgd_reference(noop_flag, tensor_lists, scal, has_mom, nesterov,
                        first_run, wd_after_momentum, use_wd):
    """The plain version of the kernel: the same update in PyTorch
    operations on the scalar vector ``scal`` from :func:`sgd_scalars`, in
    place, leaving every tensor untouched when ``noop_flag`` is set; with
    momentum off (``has_mom`` False) the momenta are not written."""
    s = list(scal.unbind())
    skip = noop_flag.reshape(()) > 0
    copies = tensor_lists[3] if len(tensor_lists) == 4 \
        else [None] * len(tensor_lists[0])
    with torch.no_grad():
        for g, p, m, c in zip(*tensor_lists[:3], copies):
            np_, nm = _sgd_math(g.float(), p.float(), m.float(), s, has_mom,
                                nesterov, first_run, wd_after_momentum,
                                use_wd)
            out = [(p, np_)] + ([(m, nm)] if has_mom else []) \
                + ([] if c is None else [(c, np_)])
            for dst, new in out:
                dst.copy_(torch.where(skip, dst, new.to(dst.dtype)))


def _validate_sgd(noop_flag, tensor_lists):
    depth = len(tensor_lists)
    if depth not in (3, 4):
        raise ValueError(f"fused_sgd supports depth 3 or 4, got {depth}")
    if len({len(lst) for lst in tensor_lists}) != 1:
        raise ValueError(f"fused_sgd: list lengths differ "
                         f"{tuple(len(lst) for lst in tensor_lists)}")
    if not isinstance(noop_flag, torch.Tensor) or noop_flag.numel() != 1 \
            or noop_flag.dtype != torch.int32:
        raise TypeError("fused_sgd: noop_flag must be a one-element int32 "
                        "tensor")
    for name, lst in zip(("params", "momenta", "model params"),
                         tensor_lists[1:]):
        dtypes = {t.dtype for t in lst}
        if len(dtypes) > 1:
            raise TypeError(f"fused_sgd: the {name} of one list share a "
                            f"dtype, got {sorted(map(str, dtypes))}")
    for i, (g, p, m, *c) in enumerate(zip(*tensor_lists)):
        if g.dtype not in KERNEL_DTYPES:
            raise TypeError(f"fused_sgd: gradient {i} dtype {g.dtype} not "
                            f"supported (float32, bfloat16 or float16)")
        if p.dtype not in KERNEL_DTYPES:
            raise TypeError(f"fused_sgd: param {i} dtype {p.dtype} not "
                            f"supported (float32, bfloat16 or float16)")
        if m.dtype != torch.float32:
            raise TypeError(f"fused_sgd: momentum {i} must be float32, got "
                            f"{m.dtype}")
        if c and c[0].dtype not in _COPY_DTYPES:
            raise TypeError(f"fused_sgd: model param {i} dtype {c[0].dtype} "
                            f"not supported (bfloat16 or float16)")
        for name, t in [("param", p), ("momentum", m)] + \
                [("model param", x) for x in c]:
            if t.shape != g.shape:
                raise ValueError(f"fused_sgd: {name} {i} shape "
                                 f"{tuple(t.shape)} != gradient shape "
                                 f"{tuple(g.shape)}")
        check_layouts("fused_sgd", i, p, [("gradient", g), ("momentum", m)]
                      + [("model param", x) for x in c])


@functools.lru_cache(maxsize=None)
def _sgd_lib():
    lib = _build.load("multi_tensor_sgd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apex_sgd_max_tensors.argtypes = []
    lib.apex_sgd_max_tensors.restype = i
    lib.apex_sgd_chunk.argtypes = []
    lib.apex_sgd_chunk.restype = i
    lib.apex_sgd.argtypes = [ctypes.POINTER(p), ctypes.POINTER(ctypes.c_ubyte),
                             p, i, i, i, p, p] + [i] * 7 + [p]
    lib.apex_sgd.restype = i
    return lib


def _launch_sgd(noop_flag, tensor_lists, scal, has_mom, nesterov, first_run,
                wd_after_momentum, use_wd):
    gs, ps, ms = tensor_lists[:3]
    decide("multi_tensor_sgd", group_fp("sgd", ps, gs), ps[0].device)
    lib = _sgd_lib()
    maxt, largest = lib.apex_sgd_max_tensors(), lib.apex_sgd_chunk()
    cs = tensor_lists[3] if len(tensor_lists) == 4 else None
    cdtype = -1 if cs is None else dtype_code(cs[0].dtype)
    flag = noop_flag.reshape(())
    sms = _sms(ps[0].device.index)
    with torch.cuda.device(ps[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, len(gs), maxt):
            sub = slice(i, i + maxt)
            chunk = _chunk_for([t.numel() for t in ps[sub]], sms,
                               _step_bytes([lst[sub] for lst in tensor_lists]),
                               largest)
            table, nc = _table(ps[sub], ms[sub],
                               None if cs is None else cs[sub], chunk)
            if nc == 0:
                continue            # every tensor of the list is empty
            gsub = gs[sub]
            grads = (ctypes.c_void_p * len(gsub))(
                *[g.data_ptr() for g in gsub])
            codes = (ctypes.c_ubyte * len(gsub))(
                *[dtype_code(g.dtype) for g in gsub])
            err = lib.apex_sgd(grads, codes, table.data_ptr(), len(gsub), nc,
                               chunk, scal.data_ptr(), flag.data_ptr(),
                               dtype_code(ps[0].dtype), cdtype, int(use_wd),
                               int(wd_after_momentum), int(has_mom),
                               int(first_run), int(nesterov), stream)
            _build.check(lib, err, "fused_sgd")
            LAUNCHES["fused_sgd"] += 1


def fused_sgd(noop_flag, tensor_lists, wd, momentum, dampening, lr,
              nesterov: bool, first_run: bool, wd_after_momentum: bool,
              scale=1.0):
    """Momentum SGD over ``[grads, params, momenta]`` (depth 3) or
    ``[grads, master_params, momenta, model_params]`` (depth 4, the half
    model copy written from the new params), in place; nothing changes when
    ``noop_flag`` (a one-element int32 tensor) is set.  ``scale``
    multiplies each gradient first (amp's unscale folded in); ``lr``,
    ``wd`` and ``scale`` may be device scalars.  The gradients of one list
    may mix fp32, bf16 and fp16; the momenta are fp32, the params of one
    dtype, the model copy bf16 or fp16.  Returns ``(noop_flag, params,
    momenta[, model_params])``, the JAX function's tuple."""
    _validate_sgd(noop_flag, tensor_lists)
    gs, ps, ms = tensor_lists[:3]
    out = (noop_flag, list(ps), list(ms)) + (
        (list(tensor_lists[3]),) if len(tensor_lists) == 4 else ())
    if not gs:
        return out
    scal = sgd_scalars(lr, wd, scale, momentum, dampening, ps[0].device)
    args = (float(momentum) != 0.0, bool(nesterov), bool(first_run),
            bool(wd_after_momentum), _static_nonzero(wd))
    if use_kernel(noop_flag, *(t for lst in tensor_lists for t in lst)):
        _launch_sgd(noop_flag, tensor_lists, scal, *args)
    else:
        fused_sgd_reference(noop_flag, tensor_lists, scal, *args)
    return out
