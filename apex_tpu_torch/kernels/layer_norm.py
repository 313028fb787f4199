"""LayerNorm forward and backward: the CUDA kernels ``csrc/layer_norm.cu``
and their plain PyTorch versions.

Port of ``apex_tpu/kernels/layer_norm.py::ln_forward``: normalise over the
last dim of ``x2d (rows, N)`` with fp32 two-pass statistics (the mean, then
the mean of squared deviations), optional affine; returns ``y`` in x's dtype
and ``mean``, ``rstd`` of shape ``(rows, 1)`` in fp32.  And of
``ln_backward``: from the saved statistics, ``dx`` in x's dtype and, for the
affine form, ``dgamma``/``dbeta`` summed over the rows in fp32.  A CUDA
tensor launches the kernel; a CPU tensor takes the plain version
(:func:`ln_forward_reference`, :func:`ln_backward_reference`).

The kernels read the affine parameters in their own dtypes (fp32, bf16 or
fp16, each independent of x's) and have two routes, which
:func:`norm_route` picks before the launch (the RMSNorm kernels use the
same rule): ``vec``, 16-byte accesses of the rows (x and y; g, x and dx)
and the parameters, for a width that is a multiple of 16 bytes' worth of
x's dtype and 16-byte aligned bases; ``scalar``, one element per access,
for the rest.  Each route has its own counter (``ln_forward_vec``,
``ln_forward_scalar``; ``ln_backward_rows_vec``,
``ln_backward_rows_scalar``) beside the totals ``ln_forward`` and
``ln_backward_rows``.  The backward's column-sum kernel rounds each fp32
sum once to the dtype asked for: fp32 from :func:`ln_backward`, the
weight's dtype from ``_backward`` (the autograd Function's path, as
the JAX ``custom_vjp`` casts them).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .dispatch import LAUNCHES, check_dtype, decide, dtype_code, \
    kernel_probe, register_kernel, rows_fp, use_kernel

MAX_N = 16384     # the longest row the kernel takes (csrc/layer_norm.cu)

# the forward entry point's route codes (csrc/norm_common.cuh), in order
ROUTES = ("scalar", "vec")
VEC_BYTES = 16    # the vec route's access: one 16-byte chunk a thread

LAUNCHES.setdefault("ln_forward", 0)
for _route in ROUTES:
    LAUNCHES.setdefault(f"ln_forward_{_route}", 0)
# the backward is two launches: dx with per-block partial column sums (on
# either route), then the column reduction of the partials into
# dgamma/dbeta (affine form only)
LAUNCHES.setdefault("ln_backward_rows", 0)
for _route in ROUTES:
    LAUNCHES.setdefault(f"ln_backward_rows_{_route}", 0)
LAUNCHES.setdefault("ln_backward_cols", 0)

register_kernel(
    "layer_norm",
    xla_fallback="apex_tpu_torch.kernels.layer_norm.ln_forward_reference",
    threshold_probe=kernel_probe,
    doc="B3: LayerNorm forward (vec, scalar)")
register_kernel(
    "layer_norm_bwd",
    xla_fallback="apex_tpu_torch.kernels.layer_norm.ln_backward_reference",
    threshold_probe=kernel_probe,
    doc="B4: LayerNorm backward, rows then column sums")


def norm_route(dtype, n, *addresses):
    """The norm kernels' route for x of ``dtype`` and width ``n`` at the
    given base addresses (x and y, or g, x and dx, and the parameters):
    ``"vec"`` or ``"scalar"`` (see the module note)."""
    if (n % (VEC_BYTES // dtype.itemsize) or n > MAX_N
            or any(a % VEC_BYTES for a in addresses)):
        return "scalar"
    return "vec"


def ln_forward_reference(x2d, weight, bias, eps):
    """The plain version, the same arithmetic in PyTorch operations."""
    xf = x2d.float()
    mean = xf.mean(dim=1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x2d.dtype), mean, rstd


def ln_backward_reference(g2d, x2d, mean, rstd, weight,
                          sum_dtype=torch.float32):
    """The plain version of the backward, the same arithmetic in PyTorch
    operations: ``(dx,)`` or ``(dx, dgamma, dbeta)``, the sums taken in fp32
    and rounded once to ``sum_dtype``."""
    g = g2d.float()
    xhat = (x2d.float() - mean) * rstd
    gh = g * weight.float() if weight is not None else g
    c1 = gh.mean(dim=1, keepdim=True)
    c2 = (gh * xhat).mean(dim=1, keepdim=True)
    dx = ((gh - c1 - xhat * c2) * rstd).to(x2d.dtype)
    if weight is None:
        return (dx,)
    return (dx, (g * xhat).sum(dim=0).to(sum_dtype),
            g.sum(dim=0).to(sum_dtype))


def _validate(x2d, weight, bias, what="ln_forward"):
    if x2d.dim() != 2:
        raise ValueError(f"{what} takes x2d (rows, N), got shape "
                         f"{tuple(x2d.shape)}")
    check_dtype(x2d, f"{what} x2d")
    n = x2d.shape[1]
    if not 0 < n <= MAX_N:
        raise ValueError(f"{what}: N = {n} outside the kernel's range "
                         f"1..{MAX_N}")
    if (weight is None) != (bias is None):
        raise ValueError(f"{what}: weight and bias are both given or "
                         "both None")
    if weight is not None:
        for name, t in (("weight", weight), ("bias", bias)):
            if tuple(t.shape) != (n,):
                raise ValueError(f"{what}: {name} shape "
                                 f"{tuple(t.shape)} != ({n},)")
            check_dtype(t, f"{what} {name}")
    if not x2d.is_contiguous():
        raise ValueError(f"{what}: x2d must be contiguous")


def _validate_bwd(g2d, x2d, mean, rstd, weight):
    # the backward takes no bias: the weight stands in for the pair check
    _validate(x2d, weight, weight, "ln_backward")
    rows, n = x2d.shape
    if tuple(g2d.shape) != (rows, n):
        raise ValueError(f"ln_backward: g shape {tuple(g2d.shape)} != x "
                         f"shape {(rows, n)}")
    check_dtype(g2d, "ln_backward g")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if tuple(t.shape) != (rows, 1) or t.dtype != torch.float32:
            raise ValueError(f"ln_backward: {name} must be fp32 of shape "
                             f"{(rows, 1)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("layer_norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apex_ln_fwd.argtypes = [p, p, i, p, i, p, p, p, i, i, ctypes.c_float,
                                i, i, p]
    lib.apex_ln_fwd.restype = i
    lib.apex_ln_bwd_parts.argtypes = [i] * 4
    lib.apex_ln_bwd_parts.restype = i
    lib.apex_ln_bwd.argtypes = [p] * 5 + [i] + [p] * 3 + [i] * 5 + [p]
    lib.apex_ln_bwd.restype = i
    lib.apex_ln_bwd_cols.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.apex_ln_bwd_cols.restype = i
    return lib


@functools.lru_cache(maxsize=256)
def _bwd_parts(device_index, rows, n, dtype, route):
    """Rows of partial sums the backward kernel writes for this shape, x's
    dtype and route (its grid on this device, from the function that sizes
    the launch)."""
    with torch.cuda.device(device_index):
        parts = _lib().apex_ln_bwd_parts(rows, n, dtype_code(dtype),
                                         ROUTES.index(route))
    if parts <= 0:
        raise RuntimeError(f"ln_backward ({route} route): no grid for "
                           f"({rows}, {n}) {dtype}")
    return parts


def _launch(x2d, weight, bias, eps):
    rows, n = x2d.shape
    decide("layer_norm", rows_fp(rows, n, x2d.dtype), x2d.device)
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd
    affine = weight is not None
    if affine:
        # read in their own dtypes by the kernel: no cast
        weight, bias = weight.contiguous(), bias.contiguous()
    ptrs = [t.data_ptr() for t in (x2d, y, weight, bias) if t is not None]
    route = norm_route(x2d.dtype, n, *ptrs)
    lib = _lib()
    with torch.cuda.device(x2d.device):
        err = lib.apex_ln_fwd(
            x2d.data_ptr(), weight.data_ptr() if affine else None,
            dtype_code(weight.dtype) if affine else 0,
            bias.data_ptr() if affine else None,
            dtype_code(bias.dtype) if affine else 0,
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, n,
            float(eps), dtype_code(x2d.dtype), ROUTES.index(route),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"ln_forward ({route} route)")
    LAUNCHES["ln_forward"] += 1
    LAUNCHES[f"ln_forward_{route}"] += 1
    return y, mean, rstd


def ln_forward(x2d, weight, bias, eps):
    """x2d (rows, N); weight/bias (N,) or None.  -> (y, mean, rstd), the
    statistics fp32 with shape (rows, 1)."""
    _validate(x2d, weight, bias)
    if use_kernel(x2d, weight, bias):
        return _launch(x2d, weight, bias, eps)
    return ln_forward_reference(x2d, weight, bias, eps)


def _launch_bwd(g2d, x2d, mean, rstd, weight, sum_dtype):
    rows, n = x2d.shape
    decide("layer_norm_bwd", rows_fp(rows, n, x2d.dtype), x2d.device)
    dx = torch.empty_like(x2d)
    affine = weight is not None
    if rows == 0:
        if not affine:
            return (dx,)
        z = torch.zeros(n, dtype=sum_dtype, device=x2d.device)
        return dx, z, z.clone()
    g2d = g2d.to(x2d.dtype).contiguous()
    if affine:
        weight = weight.contiguous()    # read in its own dtype: no cast
    ptrs = [t.data_ptr() for t in (g2d, x2d, dx, weight) if t is not None]
    route = norm_route(x2d.dtype, n, *ptrs)
    dev = x2d.device
    lib = _lib()
    parts = _bwd_parts(dev.index, rows, n, x2d.dtype, route)
    pw = pb = None
    if affine:
        pw = torch.empty((parts, n), dtype=torch.float32, device=dev)
        pb = torch.empty_like(pw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_ln_bwd(
            g2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr() if affine else None,
            dtype_code(weight.dtype) if affine else 0, dx.data_ptr(),
            pw.data_ptr() if affine else None,
            pb.data_ptr() if affine else None, parts, rows, n,
            dtype_code(x2d.dtype), ROUTES.index(route), stream)
        _build.check(lib, err, f"ln_backward ({route} route)")
        LAUNCHES["ln_backward_rows"] += 1
        LAUNCHES[f"ln_backward_rows_{route}"] += 1
        if not affine:
            return (dx,)
        dw = torch.empty(n, dtype=sum_dtype, device=dev)
        db = torch.empty_like(dw)
        err = lib.apex_ln_bwd_cols(pw.data_ptr(), pb.data_ptr(),
                                   dw.data_ptr(), db.data_ptr(), parts, n,
                                   dtype_code(sum_dtype), stream)
        _build.check(lib, err, "ln_backward (column sums)")
        LAUNCHES["ln_backward_cols"] += 1
    return dx, dw, db


def _backward(g2d, x2d, mean, rstd, weight, sum_dtype):
    """:func:`ln_backward` with dgamma/dbeta rounded once to ``sum_dtype``
    (the kernel writes them so, no cast after it)."""
    _validate_bwd(g2d, x2d, mean, rstd, weight)
    if use_kernel(g2d, x2d, mean, rstd, weight):
        return _launch_bwd(g2d, x2d, mean, rstd, weight, sum_dtype)
    return ln_backward_reference(g2d, x2d, mean, rstd, weight, sum_dtype)


def ln_backward(g2d, x2d, mean, rstd, weight):
    """g2d, x2d (rows, N); mean, rstd (rows, 1) fp32 from the forward;
    weight (N,) or None.  -> ``(dx,)`` in x's dtype, or ``(dx, dgamma,
    dbeta)`` with the sums fp32 of shape (N,)."""
    return _backward(g2d, x2d, mean, rstd, weight, torch.float32)
