"""RMSNorm forward and backward: the CUDA kernels ``csrc/rms_norm.cu`` and
their plain PyTorch versions.

Port of ``apex_tpu/kernels/rms_norm.py::rms_forward``: normalise ``x2d
(rows, N)`` by the fp32 reciprocal root mean square of its last dim,
optional weight (no bias, no mean); returns ``y`` in x's dtype and ``rstd``
of shape ``(rows, 1)`` in fp32.  And of ``rms_backward``: from the saved
``rstd``, ``dx`` in x's dtype and, for the affine form, ``dw`` summed over
the rows in fp32.  A CUDA tensor launches the kernel; a CPU tensor takes
the plain version (:func:`rms_forward_reference`,
:func:`rms_backward_reference`).

The kernels read the weight in its own dtype and take the LayerNorm
kernels' two routes, ``vec`` and ``scalar``, by the same rule
(:func:`~apex_tpu_torch.kernels.layer_norm.norm_route`), each with its own
counter (``rms_forward_vec``, ``rms_forward_scalar``;
``rms_backward_rows_vec``, ``rms_backward_rows_scalar``) beside the totals
``rms_forward`` and ``rms_backward_rows``.  The backward's column-sum
kernel rounds dw once to the dtype asked for: fp32 from
:func:`rms_backward`, the weight's dtype from ``_backward`` (the autograd
Function's path).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .dispatch import LAUNCHES, check_dtype, dtype_code, use_kernel
from .layer_norm import ROUTES, norm_route

MAX_N = 16384     # the longest row the kernel takes (csrc/rms_norm.cu)

LAUNCHES.setdefault("rms_forward", 0)
for _route in ROUTES:
    LAUNCHES.setdefault(f"rms_forward_{_route}", 0)
# the backward is two launches: dx with per-block partial column sums (on
# either route), then the column reduction of the partials into dw (affine
# form only)
LAUNCHES.setdefault("rms_backward_rows", 0)
for _route in ROUTES:
    LAUNCHES.setdefault(f"rms_backward_rows_{_route}", 0)
LAUNCHES.setdefault("rms_backward_cols", 0)


def rms_forward_reference(x2d, weight, eps):
    """The plain version, the same arithmetic in PyTorch operations."""
    xf = x2d.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=1, keepdim=True) + eps)
    y = xf * rstd
    if weight is not None:
        y = y * weight.float()
    return y.to(x2d.dtype), rstd


def rms_backward_reference(g2d, x2d, rstd, weight, sum_dtype=torch.float32):
    """The plain version of the backward: ``(dx,)`` or ``(dx, dw)``, the
    sum taken in fp32 and rounded once to ``sum_dtype``."""
    g = g2d.float()
    xhat = x2d.float() * rstd
    gh = g * weight.float() if weight is not None else g
    c2 = (gh * xhat).mean(dim=1, keepdim=True)
    dx = ((gh - xhat * c2) * rstd).to(x2d.dtype)
    if weight is None:
        return (dx,)
    return dx, (g * xhat).sum(dim=0).to(sum_dtype)


def _validate(x2d, weight, what="rms_forward"):
    if x2d.dim() != 2:
        raise ValueError(f"{what} takes x2d (rows, N), got shape "
                         f"{tuple(x2d.shape)}")
    check_dtype(x2d, f"{what} x2d")
    n = x2d.shape[1]
    if not 0 < n <= MAX_N:
        raise ValueError(f"{what}: N = {n} outside the kernel's range "
                         f"1..{MAX_N}")
    if weight is not None:
        if tuple(weight.shape) != (n,):
            raise ValueError(f"{what}: weight shape "
                             f"{tuple(weight.shape)} != ({n},)")
        check_dtype(weight, f"{what} weight")
    if not x2d.is_contiguous():
        raise ValueError(f"{what}: x2d must be contiguous")


def _validate_bwd(g2d, x2d, rstd, weight):
    _validate(x2d, weight, "rms_backward")
    rows, n = x2d.shape
    if tuple(g2d.shape) != (rows, n):
        raise ValueError(f"rms_backward: g shape {tuple(g2d.shape)} != x "
                         f"shape {(rows, n)}")
    check_dtype(g2d, "rms_backward g")
    if tuple(rstd.shape) != (rows, 1) or rstd.dtype != torch.float32:
        raise ValueError(f"rms_backward: rstd must be fp32 of shape "
                         f"{(rows, 1)}, got {rstd.dtype} "
                         f"{tuple(rstd.shape)}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rms_norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apex_rms_fwd.argtypes = [p, p, i, p, p, i, i, ctypes.c_float, i, i,
                                 p]
    lib.apex_rms_fwd.restype = i
    lib.apex_rms_bwd_parts.argtypes = [i] * 4
    lib.apex_rms_bwd_parts.restype = i
    lib.apex_rms_bwd.argtypes = [p] * 4 + [i, p, p] + [i] * 5 + [p]
    lib.apex_rms_bwd.restype = i
    lib.apex_rms_bwd_cols.argtypes = [p, p] + [i] * 3 + [p]
    lib.apex_rms_bwd_cols.restype = i
    return lib


@functools.lru_cache(maxsize=256)
def _bwd_parts(device_index, rows, n, dtype, route):
    """Rows of partial sums the backward kernel writes for this shape, x's
    dtype and route (its grid on this device, from the function that sizes
    the launch)."""
    with torch.cuda.device(device_index):
        parts = _lib().apex_rms_bwd_parts(rows, n, dtype_code(dtype),
                                          ROUTES.index(route))
    if parts <= 0:
        raise RuntimeError(f"rms_backward ({route} route): no grid for "
                           f"({rows}, {n}) {dtype}")
    return parts


def _launch(x2d, weight, eps):
    rows, n = x2d.shape
    y = torch.empty_like(x2d)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    if rows == 0:
        return y, rstd
    affine = weight is not None
    if affine:
        weight = weight.contiguous()   # read in its own dtype: no cast
    ptrs = [t.data_ptr() for t in (x2d, y, weight) if t is not None]
    route = norm_route(x2d.dtype, n, *ptrs)
    lib = _lib()
    with torch.cuda.device(x2d.device):
        err = lib.apex_rms_fwd(
            x2d.data_ptr(), weight.data_ptr() if affine else None,
            dtype_code(weight.dtype) if affine else 0, y.data_ptr(),
            rstd.data_ptr(), rows, n, float(eps), dtype_code(x2d.dtype),
            ROUTES.index(route), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"rms_forward ({route} route)")
    LAUNCHES["rms_forward"] += 1
    LAUNCHES[f"rms_forward_{route}"] += 1
    return y, rstd


def rms_forward(x2d, weight, eps):
    """x2d (rows, N); weight (N,) or None.  -> (y, rstd), rstd fp32 with
    shape (rows, 1)."""
    _validate(x2d, weight)
    if use_kernel(x2d, weight):
        return _launch(x2d, weight, eps)
    return rms_forward_reference(x2d, weight, eps)


def _launch_bwd(g2d, x2d, rstd, weight, sum_dtype):
    rows, n = x2d.shape
    dx = torch.empty_like(x2d)
    affine = weight is not None
    if rows == 0:
        if not affine:
            return (dx,)
        return dx, torch.zeros(n, dtype=sum_dtype, device=x2d.device)
    g2d = g2d.to(x2d.dtype).contiguous()
    if affine:
        weight = weight.contiguous()    # read in its own dtype: no cast
    ptrs = [t.data_ptr() for t in (g2d, x2d, dx, weight) if t is not None]
    route = norm_route(x2d.dtype, n, *ptrs)
    dev = x2d.device
    lib = _lib()
    parts = _bwd_parts(dev.index, rows, n, x2d.dtype, route)
    pw = None
    if affine:
        pw = torch.empty((parts, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.apex_rms_bwd(
            g2d.data_ptr(), x2d.data_ptr(), rstd.data_ptr(),
            weight.data_ptr() if affine else None,
            dtype_code(weight.dtype) if affine else 0, dx.data_ptr(),
            pw.data_ptr() if affine else None, parts, rows, n,
            dtype_code(x2d.dtype), ROUTES.index(route), stream)
        _build.check(lib, err, f"rms_backward ({route} route)")
        LAUNCHES["rms_backward_rows"] += 1
        LAUNCHES[f"rms_backward_rows_{route}"] += 1
        if not affine:
            return (dx,)
        dw = torch.empty(n, dtype=sum_dtype, device=dev)
        err = lib.apex_rms_bwd_cols(pw.data_ptr(), dw.data_ptr(), parts, n,
                                    dtype_code(sum_dtype), stream)
        _build.check(lib, err, "rms_backward (column sums)")
        LAUNCHES["rms_backward_cols"] += 1
    return dx, dw


def _backward(g2d, x2d, rstd, weight, sum_dtype):
    """:func:`rms_backward` with dw rounded once to ``sum_dtype`` (the
    kernel writes it so, no cast after it)."""
    _validate_bwd(g2d, x2d, rstd, weight)
    if use_kernel(g2d, x2d, rstd, weight):
        return _launch_bwd(g2d, x2d, rstd, weight, sum_dtype)
    return rms_backward_reference(g2d, x2d, rstd, weight, sum_dtype)


def rms_backward(g2d, x2d, rstd, weight):
    """g2d, x2d (rows, N); rstd (rows, 1) fp32 from the forward; weight
    (N,) or None.  -> ``(dx,)`` in x's dtype, or ``(dx, dw)`` with dw fp32
    of shape (N,)."""
    return _backward(g2d, x2d, rstd, weight, torch.float32)
