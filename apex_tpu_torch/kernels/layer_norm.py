"""LayerNorm forward: the CUDA kernel ``csrc/layer_norm.cu`` and its plain
PyTorch version.

Port of ``apex_tpu/kernels/layer_norm.py::ln_forward``: normalise over the
last dim of ``x2d (rows, N)`` with fp32 two-pass statistics (the mean, then
the mean of squared deviations), optional affine; returns ``y`` in x's dtype
and ``mean``, ``rstd`` of shape ``(rows, 1)`` in fp32.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`ln_forward_reference`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .dispatch import LAUNCHES, check_dtype, dtype_code, use_kernel

MAX_N = 16384     # the longest row the kernel takes (csrc/layer_norm.cu)

LAUNCHES.setdefault("ln_forward", 0)


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


def _validate(x2d, weight, bias):
    if x2d.dim() != 2:
        raise ValueError(f"ln_forward takes x2d (rows, N), got shape "
                         f"{tuple(x2d.shape)}")
    check_dtype(x2d, "ln_forward x2d")
    n = x2d.shape[1]
    if not 0 < n <= MAX_N:
        raise ValueError(f"ln_forward: N = {n} outside the kernel's range "
                         f"1..{MAX_N}")
    if (weight is None) != (bias is None):
        raise ValueError("ln_forward: weight and bias are both given or "
                         "both None")
    if weight is not None:
        for name, t in (("weight", weight), ("bias", bias)):
            if tuple(t.shape) != (n,):
                raise ValueError(f"ln_forward: {name} shape "
                                 f"{tuple(t.shape)} != ({n},)")
            check_dtype(t, f"ln_forward {name}")
    if not x2d.is_contiguous():
        raise ValueError("ln_forward: x2d must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("layer_norm")
    lib.apex_ln_fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.apex_ln_fwd.restype = ctypes.c_int
    return lib


def _launch(x2d, weight, bias, eps):
    rows, n = x2d.shape
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd
    if weight is not None:
        # the kernel reads the affine parameters as fp32
        weight = weight.to(torch.float32).contiguous()
        bias = bias.to(torch.float32).contiguous()
    lib = _lib()
    with torch.cuda.device(x2d.device):
        err = lib.apex_ln_fwd(
            x2d.data_ptr(),
            None if weight is None else weight.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, n,
            float(eps), dtype_code(x2d.dtype),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "ln_forward")
    LAUNCHES["ln_forward"] += 1
    return y, mean, rstd


def ln_forward(x2d, weight, bias, eps):
    """x2d (rows, N); weight/bias (N,) or None.  -> (y, mean, rstd), the
    statistics fp32 with shape (rows, 1)."""
    _validate(x2d, weight, bias)
    if use_kernel(x2d, weight, bias):
        return _launch(x2d, weight, bias, eps)
    return ln_forward_reference(x2d, weight, bias, eps)
