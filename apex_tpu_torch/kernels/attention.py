"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_attention_tc.cu`` (the ``tc`` route), ``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu`` (the ``simt`` route) and their plain
PyTorch versions.

Port of ``apex_tpu/kernels/attention.py::flash_attention_fwd``: q3 (BH, Sq,
D), k3/v3 (BH, Sk, D), an additive bias broadcastable as (BH|1, Sq|1, Sk),
top-left causal masking with an optional Mistral band, the scale applied
after q.k^T, masked scores at the finite -1e30.  Returns ``out`` in q's
dtype and the per-row logsumexp ``lse (BH, Sq)`` in fp32.  And of
``flash_attention_bwd``: the probabilities recomputed from ``lse``,
``delta = rowsum(g * out)`` in fp32 (plain PyTorch, as the JAX package
computes it outside its kernels), then ``dq``, ``dk``, ``dv`` in the
inputs' dtypes.  A CUDA tensor launches the kernels; a CPU tensor takes the
plain versions (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_reference`).

Attention dropout rides inside the kernels as in the JAX package: with
``dropout_p > 0`` each probability is multiplied by ``1 / (1 - p)`` or 0
after the softmax (its sum and ``lse`` keep the undropped values), the
mask a counter-based hash of (seed, batch*head, global row, global column)
that the backward regenerates from the same seed.  Its plain version is
:func:`dropout_keep_reference`, bit for bit the JAX package's
(``_hash_keep_u32``, ``_mult_from_hash``).  The seed reaches the kernels as
a device vector ``[seed, row_off, col_off]``, so drawing it on the card
costs no host sync.

Two routes of hand-written kernels, chosen by :func:`flash_route` before
the launch from the dtype, the head dim and the base addresses: ``"tc"``
(bf16 or fp16, D = 64, 16-byte-aligned bases) runs every product on the
tensor cores (``wgmma`` fed by TMA); ``"simt"`` takes everything else with
fp32 FMAs over the inputs widened to fp32 (fp32, where tensor cores would
compute TF32; other head dims).  Each route and kernel has its own launch
counter beside the three totals.  What the ``tc`` route rounds:

- the scores q.k^T and dO.v^T are products of two 16-bit values, exact in
  fp32, summed in fp32: the plain version's up to the order of the sums;
- forward: the probabilities (times the dropout mask) are rounded to the
  input dtype only as the operand of p.v; the row sum and ``lse`` keep the
  fp32 probabilities;
- backward: ``dv = round(p * mult)^T . dO``; ``ds = p * (dp * mult -
  delta)`` in fp32, rounded to the input dtype as the operand of ``dq =
  ds . k`` and ``dk = ds^T . q``; the scale is applied in fp32 at the end.

FlashAttention-2/3 and cuDNN round the same operands; the JAX kernels keep
them in fp32, so the route matches the plain versions within the rounding
of those operands, not to the last bit.  Its plain model is
:func:`flash_attention_tc_reference` / :func:`flash_attention_bwd_tc_reference`
(the plain versions with those roundings; at fp32 input, the plain
versions themselves).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .dispatch import LAUNCHES, MASKED_FILL, attention_fp, check_dtype, \
    decide, dtype_code, kernel_probe, register_kernel, use_kernel

MAX_HEAD_DIM = 128   # the simt sources keep D / 16 output columns a thread
TC_HEAD_DIM = 64     # the tc route's head dim: one 128-byte swizzle row

ROUTES = ("simt", "tc")
KERNELS = ("fwd", "bwd_dq", "bwd_dkv")
for _kernel in KERNELS:
    LAUNCHES.setdefault(f"flash_attention_{_kernel}", 0)
    for _route in ROUTES:
        LAUNCHES.setdefault(f"flash_attention_{_kernel}_{_route}", 0)


register_kernel(
    "flash_attention",
    xla_fallback="apex_tpu_torch.kernels.attention.flash_attention_reference",
    threshold_probe=kernel_probe,
    doc="B1: blockwise online-softmax attention forward (simt, tc)")
register_kernel(
    "flash_attention_bwd",
    xla_fallback=("apex_tpu_torch.kernels.attention."
                  "flash_attention_bwd_reference"),
    threshold_probe=kernel_probe,
    doc="B2: the flash backward, dq then dk/dv (simt, tc)")


def flash_fp(q3, k3, causal) -> str:
    """The ledger key of a flash launch on ``(B·H, S, D)`` operands."""
    bh, sq, d = q3.shape
    return attention_fp(1, bh, sq, k3.shape[1], d, q3.dtype, causal)


def flash_route(dtype, d, *addresses):
    """The kernels' route for inputs of ``dtype`` and head dim ``d`` at the
    given base addresses: ``"tc"`` or ``"simt"`` (see the module note)."""
    if (dtype not in (torch.bfloat16, torch.float16) or d != TC_HEAD_DIM
            or any(a % 16 for a in addresses)):
        return "simt"
    return "tc"


def _count(kernel, route):
    LAUNCHES[f"flash_attention_{kernel}"] += 1
    LAUNCHES[f"flash_attention_{kernel}_{route}"] += 1


def _scores(q3, k3, bias, scale, causal, window):
    """fp32 scores as the kernels see them: scale after q.k^T, the bias,
    then the causal / band mask at -1e30."""
    sq, sk = q3.shape[1], k3.shape[1]
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        rows = torch.arange(sq, device=q3.device)[:, None]
        cols = torch.arange(sk, device=q3.device)[None, :]
        keep = rows >= cols
        if window is not None:
            keep = keep & (cols > rows - window)
        s = torch.where(keep, s, MASKED_FILL)
    return s


_U32 = 0xFFFFFFFF


def _mul32(a, c):
    """``a * c mod 2**32`` for an int64 tensor ``a`` in [0, 2**32) and a
    constant ``c`` < 2**32, in halves of 16 bits so that no int64 product
    overflows."""
    return (a * (c & 0xFFFF) + ((a * (c >> 16)) & 0xFFFF) * 65536) & _U32


def dropout_constants(rate):
    """The keep threshold and the multiplier of kept entries, computed as
    the JAX package computes them (``_mult_from_hash``): ``min(int((1 -
    rate) * 2**32), 2**32 - 1)`` in Python double, and ``1 / (1 - rate)``
    rounded to float32."""
    thresh = min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)
    return thresh, float(np.float32(1.0 / (1.0 - rate)))


def _as_i64(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.int64)


def dropout_keep_reference(b, sq, sk, seed, rate, row_off=0, col_off=0,
                           device=None):
    """The plain version of the kernels' mask: (B*H, Sq, Sk) fp32
    multipliers, ``1 / (1 - rate)`` where the hash of (seed, batch*head,
    ``row_off`` + row, ``col_off`` + column) falls below the keep threshold
    and 0 elsewhere.  The hash runs in int64 with every sum and product
    taken mod 2**32, which is the kernels' (and the JAX package's) uint32
    arithmetic.  ``seed`` and the offsets are ints or int tensors."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    thresh, keep_scale = dropout_constants(rate)
    rows = (_as_i64(row_off, dev) + torch.arange(sq, device=dev)) & _U32
    cols = (_as_i64(col_off, dev) + torch.arange(sk, device=dev)) & _U32
    heads = torch.arange(b, device=dev, dtype=torch.int64)
    per_head = (_mul32(heads, 0x27D4EB2F)
                + _mul32(_as_i64(seed, dev) & _U32, 0xC2B2AE35)) & _U32
    h = (per_head[:, None, None] + _mul32(rows, 0x9E3779B9)[None, :, None]
         + _mul32(cols, 0x85EBCA6B)[None, None, :]) & _U32
    h ^= h >> 16
    h = _mul32(h, 0x7FEB352D)
    h ^= h >> 15
    h = _mul32(h, 0x846CA68B)
    h ^= h >> 16
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(h < thresh, torch.full_like(zero, keep_scale), zero)


def _keep_mult(q3, k3, dropout_p, seed, row_off, col_off):
    """The mask for q3 x k3, or None without dropout."""
    if not dropout_p:
        return None
    return dropout_keep_reference(q3.shape[0], q3.shape[1], k3.shape[1],
                                  seed, dropout_p, row_off, col_off,
                                  device=q3.device)


def _operand(x, dtype):
    """``x`` rounded to ``dtype`` as a product's operand, back in fp32; as
    it is without a dtype."""
    return x if dtype is None else x.to(dtype).float()


def _fwd(q3, k3, v3, bias, scale, causal, window, dropout, rounded):
    s = _scores(q3, k3, bias, scale, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    mult = _keep_mult(q3, k3, *dropout)
    if mult is not None:
        p = p * mult
    out = torch.matmul(_operand(p, rounded), v3.float())
    return out.to(q3.dtype), lse


def flash_attention_reference(q3, k3, v3, bias, scale, causal, window=None,
                              dropout_p=0.0, dropout_seed=None,
                              dropout_row_off=0, dropout_col_off=0):
    """The plain version: materialised fp32 scores, softmax, the dropout
    mask on the probabilities, product; ``lse`` of the undropped scores."""
    return _fwd(q3, k3, v3, bias, scale, causal, window,
                (dropout_p, dropout_seed, dropout_row_off, dropout_col_off),
                None)


def flash_attention_tc_reference(q3, k3, v3, bias, scale, causal,
                                 window=None, dropout_p=0.0,
                                 dropout_seed=None, dropout_row_off=0,
                                 dropout_col_off=0):
    """A model of the ``tc`` route's forward: the plain version with the
    (dropped) probabilities rounded to q3's dtype as the operand of p.v.
    The kernel rounds the probabilities of its running max, so the two
    differ by that rounding; at fp32 input this is the plain version."""
    return _fwd(q3, k3, v3, bias, scale, causal, window,
                (dropout_p, dropout_seed, dropout_row_off, dropout_col_off),
                q3.dtype)


def _delta(g, out):
    """rowsum(g * out) in fp32, (BH, Sq)."""
    return (g.float() * out.float()).sum(dim=-1)


def _bwd(q3, k3, v3, bias, out, lse, g, scale, causal, window, dropout,
         rounded):
    p = torch.exp(_scores(q3, k3, bias, scale, causal, window)
                  - lse[..., None])
    mult = _keep_mult(q3, k3, *dropout)
    gf = g.float()
    dp = torch.matmul(gf, v3.float().transpose(1, 2))
    pd = p
    if mult is not None:
        dp = dp * mult
        pd = p * mult
    ds = _operand(p * (dp - _delta(g, out)[..., None]), rounded)
    dq = torch.matmul(ds, k3.float()) * scale
    dk = torch.matmul(ds.transpose(1, 2), q3.float()) * scale
    dv = torch.matmul(_operand(pd, rounded).transpose(1, 2), gf)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


def flash_attention_bwd_reference(q3, k3, v3, bias, out, lse, g, scale,
                                  causal, window=None, dropout_p=0.0,
                                  dropout_seed=None, dropout_row_off=0,
                                  dropout_col_off=0):
    """The plain version of the backward: the fp32 probabilities recomputed
    from ``lse``, the mask replayed from the seed, then the five products,
    materialised."""
    return _bwd(q3, k3, v3, bias, out, lse, g, scale, causal, window,
                (dropout_p, dropout_seed, dropout_row_off, dropout_col_off),
                None)


def flash_attention_bwd_tc_reference(q3, k3, v3, bias, out, lse, g, scale,
                                     causal, window=None, dropout_p=0.0,
                                     dropout_seed=None, dropout_row_off=0,
                                     dropout_col_off=0):
    """A model of the ``tc`` route's backward: the plain version with
    ``p * mult`` rounded to q3's dtype as the operand of dv and ``ds`` as
    the operand of dq and dk; at fp32 input, the plain version."""
    return _bwd(q3, k3, v3, bias, out, lse, g, scale, causal, window,
                (dropout_p, dropout_seed, dropout_row_off, dropout_col_off),
                q3.dtype)


def check_dropout(dropout_p, dropout_seed):
    """The JAX package's checks of the dropout arguments."""
    if dropout_p and not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")


def _validate(q3, k3, v3, bias, window, dropout_p, dropout_seed,
              what="flash_attention_fwd"):
    check_dropout(dropout_p, dropout_seed)
    for name, t in (("q3", q3), ("k3", k3), ("v3", v3)):
        if t.dim() != 3:
            raise ValueError(f"{what}: {name} must be (BH, S, D), got "
                             f"shape {tuple(t.shape)}")
        check_dtype(t, f"{what} {name}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if not q3.dtype == k3.dtype == v3.dtype:
        raise TypeError(f"{what}: q/k/v dtypes differ ({q3.dtype}, "
                        f"{k3.dtype}, {v3.dtype})")
    bh, sq, d = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(f"{what}: q {tuple(q3.shape)}, k "
                         f"{tuple(k3.shape)}, v {tuple(v3.shape)} do not "
                         f"match")
    sk = k3.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} > {MAX_HEAD_DIM}, which "
                         f"the kernel does not take")
    if min(bh, sq, sk, d) == 0:
        raise ValueError(f"{what}: empty input {tuple(q3.shape)} x "
                         f"{tuple(k3.shape)}")
    if bias is not None:
        if bias.dim() != 3 or bias.shape[0] not in (1, bh) \
                or bias.shape[1] not in (1, sq) or bias.shape[2] != sk:
            raise ValueError(f"{what}: bias shape {tuple(bias.shape)} is "
                             f"not ({bh}|1, {sq}|1, {sk})")
        if not bias.is_floating_point():
            raise TypeError(f"{what}: bias dtype {bias.dtype} is not a "
                            f"float type")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")


def _validate_bwd(q3, k3, v3, bias, out, lse, g, window, dropout_p,
                  dropout_seed):
    _validate(q3, k3, v3, bias, window, dropout_p, dropout_seed,
              "flash_attention_bwd")
    for name, t in (("out", out), ("g", g)):
        if tuple(t.shape) != tuple(q3.shape):
            raise ValueError(f"flash_attention_bwd: {name} shape "
                             f"{tuple(t.shape)} != q shape "
                             f"{tuple(q3.shape)}")
        check_dtype(t, f"flash_attention_bwd {name}")
    if tuple(lse.shape) != tuple(q3.shape[:2]) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be fp32 of shape "
                         f"{tuple(q3.shape[:2])}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")


_P, _I, _LL, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float, ctypes.c_uint
# the C entry points' arguments, alike on both routes: q, k, v, bias and its
# strides, then the kernel's own tensors, then the sizes, the scale, the
# mask, the dropout, the dtype code and the stream
_HEAD = [_P, _P, _P, _P, _LL, _LL]
_TAIL = [_I, _I, _I, _I, _F, _I, _I, _P, _U, _F, _I, _P]
_ARGTYPES = {"fwd": _HEAD + [_P, _P] + _TAIL,
             "bwd_dq": _HEAD + [_P, _P, _P, _P] + _TAIL,
             "bwd_dkv": _HEAD + [_P, _P, _P, _P, _P] + _TAIL}
_SOURCES = {("fwd", "simt"): ("flash_attention", "apex_flash_fwd"),
            ("bwd_dq", "simt"): ("flash_attention_bwd", "apex_flash_bwd_dq"),
            ("bwd_dkv", "simt"): ("flash_attention_bwd",
                                  "apex_flash_bwd_dkv"),
            ("fwd", "tc"): ("flash_attention_tc", "apex_flash_tc_fwd"),
            ("bwd_dq", "tc"): ("flash_attention_tc", "apex_flash_tc_bwd_dq"),
            ("bwd_dkv", "tc"): ("flash_attention_tc",
                                "apex_flash_tc_bwd_dkv")}


@functools.lru_cache(maxsize=None)
def _lib(name):
    """The loaded library of ``csrc/<name>.cu`` with its entry points'
    argument types set."""
    lib = _build.load(name)
    for (kernel, _), (src, fn) in _SOURCES.items():
        if src == name:
            getattr(lib, fn).argtypes = _ARGTYPES[kernel]
            getattr(lib, fn).restype = _I
    if name == "flash_attention_tc":
        lib.apex_flash_tc_smem.argtypes = [_I]
        lib.apex_flash_tc_smem.restype = _I
    return lib


def _entry(kernel, route):
    """``(library, C entry point)`` of one kernel on one route."""
    src, fn = _SOURCES[(kernel, route)]
    lib = _lib(src)
    return lib, getattr(lib, fn)


def _bias_layout(bias, sk):
    """The bias as a contiguous fp32 tensor and its (batch, row) strides in
    elements, 0 where it broadcasts."""
    if bias is None:
        return None, 0, 0
    bias = bias.to(torch.float32).contiguous()
    bstride = bias.shape[1] * sk if bias.shape[0] > 1 else 0
    qstride = sk if bias.shape[1] > 1 else 0
    return bias, bstride, qstride


def _to_i32(x, device):
    """An int or int tensor as an int32 scalar on ``device``, wrapped to
    32 bits as the JAX package's int32 seed and offsets are.  An int is
    written by a fill on the device: a copy from the host would wait for
    the card's queue."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31,
                      dtype=torch.int32, device=device)


def seed_vector(dropout_p, seed, row_off=0, col_off=0, device=None):
    """The dropout arguments packed as the kernels read them: None without
    dropout, else the int32 vector ``[seed, row_off, col_off]`` on
    ``device`` (the JAX package's ``_seed_vec``), built there, so a seed
    drawn on the card is not read back to the host."""
    check_dropout(dropout_p, seed)
    if not dropout_p:
        return None
    return torch.stack([_to_i32(x, device) for x in (seed, row_off,
                                                     col_off)])


def _unpack(seed_vec):
    """``seed_vector``'s vector as the plain versions' seed and offsets."""
    return (None, 0, 0) if seed_vec is None else seed_vec.unbind()


def _dropout_args(dropout_p, seed_vec):
    """The three trailing arguments of the C entry points."""
    if not dropout_p:
        return None, 0, 0.0
    thresh, keep_scale = dropout_constants(dropout_p)
    return seed_vec.data_ptr(), thresh, keep_scale


def _launch(q3, k3, v3, bias, scale, causal, window, dropout_p, seed_vec):
    decide("flash_attention", flash_fp(q3, k3, causal), q3.device)
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    out = torch.empty_like(q3)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q3.device)
    bias, bstride, qstride = _bias_layout(bias, sk)
    route = flash_route(q3.dtype, d, q3.data_ptr(), k3.data_ptr(),
                        v3.data_ptr())
    lib, fn = _entry("fwd", route)
    with torch.cuda.device(q3.device):
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                 None if bias is None else bias.data_ptr(), bstride, qstride,
                 out.data_ptr(), lse.data_ptr(), bh, sq, sk, d, float(scale),
                 int(bool(causal)), int(window or 0),
                 *_dropout_args(dropout_p, seed_vec), dtype_code(q3.dtype),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"flash_attention_fwd ({route})")
    _count("fwd", route)
    return out, lse


def flash_fwd(q3, k3, v3, bias, scale, causal, window, dropout_p,
              seed_vec):
    """:func:`flash_attention_fwd` with its dropout arguments packed by
    :func:`seed_vector`, so that a caller that runs the backward too builds
    the vector once."""
    _validate(q3, k3, v3, bias, window, dropout_p, seed_vec)
    if not causal:
        window = None    # the band is defined against the causal direction
    if use_kernel(q3, k3, v3, bias):
        return _launch(q3, k3, v3, bias, scale, causal, window, dropout_p,
                       seed_vec)
    return flash_attention_reference(q3, k3, v3, bias, scale, causal, window,
                                     dropout_p, *_unpack(seed_vec))


def flash_attention_fwd(q3, k3, v3, bias, scale, causal, window=None,
                        dropout_p=0.0, dropout_seed=None, dropout_row_off=0,
                        dropout_col_off=0):
    """q3 (BH, Sq, D), k3/v3 (BH, Sk, D), bias (BH|1, Sq|1, Sk) or None.
    ``window`` (with ``causal``) keeps keys in (t - window, t].
    ``dropout_p`` > 0 drops attention probabilities by the hash mask of
    ``dropout_seed`` (an int or an int32 tensor, on the card best a device
    scalar) at the global offsets ``dropout_row_off``/``dropout_col_off``.
    Returns (out (BH, Sq, D) in q's dtype, lse (BH, Sq) fp32)."""
    return flash_fwd(q3, k3, v3, bias, scale, causal, window, dropout_p,
                     seed_vector(dropout_p, dropout_seed, dropout_row_off,
                                 dropout_col_off, q3.device))


def _launch_bwd(q3, k3, v3, bias, out, lse, g, scale, causal, window,
                dropout_p, seed_vec):
    decide("flash_attention_bwd", flash_fp(q3, k3, causal), q3.device)
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    g = g.to(q3.dtype).contiguous()
    delta = _delta(g, out).contiguous()
    lse = lse.contiguous()
    bias, bstride, qstride = _bias_layout(bias, sk)
    dq = torch.empty_like(q3)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    route = flash_route(q3.dtype, d, q3.data_ptr(), k3.data_ptr(),
                        v3.data_ptr(), g.data_ptr())
    common = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
              None if bias is None else bias.data_ptr(), bstride, qstride,
              g.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (bh, sq, sk, d, float(scale), int(bool(causal)), int(window or 0),
            *_dropout_args(dropout_p, seed_vec), dtype_code(q3.dtype))
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib, fn = _entry("bwd_dq", route)
        err = fn(*common, dq.data_ptr(), *tail, stream)
        _build.check(lib, err, f"flash_attention_bwd (dq, {route})")
        _count("bwd_dq", route)
        lib, fn = _entry("bwd_dkv", route)
        err = fn(*common, dk.data_ptr(), dv.data_ptr(), *tail, stream)
        _build.check(lib, err, f"flash_attention_bwd (dk, dv, {route})")
        _count("bwd_dkv", route)
    return dq, dk, dv


def flash_bwd(q3, k3, v3, bias, out, lse, g, scale, causal, window,
              dropout_p, seed_vec):
    """:func:`flash_attention_bwd` with its dropout arguments packed by
    :func:`seed_vector` (the forward's vector)."""
    _validate_bwd(q3, k3, v3, bias, out, lse, g, window, dropout_p, seed_vec)
    if not causal:
        window = None
    if use_kernel(q3, k3, v3, bias, out, lse, g):
        return _launch_bwd(q3, k3, v3, bias, out, lse, g, scale, causal,
                           window, dropout_p, seed_vec)
    return flash_attention_bwd_reference(q3, k3, v3, bias, out, lse, g,
                                         scale, causal, window, dropout_p,
                                         *_unpack(seed_vec))


def flash_attention_bwd(q3, k3, v3, bias, out, lse, g, scale, causal,
                        window=None, dropout_p=0.0, dropout_seed=None,
                        dropout_row_off=0, dropout_col_off=0):
    """The backward of :func:`flash_attention_fwd` from its inputs, its
    ``out`` and ``lse``, the gradient ``g`` of ``out`` and the forward's
    dropout arguments.  Returns ``(dq, dk, dv)`` with the shapes and dtypes
    of q3, k3, v3."""
    return flash_bwd(q3, k3, v3, bias, out, lse, g, scale, causal, window,
                     dropout_p, seed_vector(dropout_p, dropout_seed,
                                            dropout_row_off, dropout_col_off,
                                            q3.device))
