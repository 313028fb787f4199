"""Fused LM head + cross-entropy: the CUDA kernels ``csrc/lm_head_xent.cu``
and their plain PyTorch versions.

Port of ``apex_tpu/kernels/lm_head_xent.py``: per row ``i`` of ``x (N,
E)``, the logits ``s_i = x_i @ emb.T`` over the table ``emb (V, E)``, the
row's ``lse`` and ``loss_i = lse_i - s_{i, labels_i}`` (fp32), without the
``(N, V)`` logits ever reaching device memory (the forward, ``_fwd_impl``);
and the backward (``_bwd``), which recomputes the logits block by block
into ``dl = g_i (softmax(s_i) - onehot(labels_i))`` and launches one kernel
for ``dx = dl @ emb`` and one for ``demb = dl.T @ x``.

Two routes of hand-written kernels, chosen by :func:`lmx_route` before the
launch from the dtype, the width E and the base addresses: ``"tc"`` (bf16,
E a multiple of 8 and at most 768, 16-byte-aligned bases) runs every
product on the tensor cores (``wgmma``, bf16 x bf16 -> fp32: the logits are
exact products summed in fp32, and ``dl`` is rounded to bf16 only as the
second product's operand); ``"simt"`` takes everything else with fp32 FMAs
over the inputs widened to fp32 (fp32, where tensor cores would compute
TF32; fp16, whose range would flush ``dl`` ~ 1e-9 to 0).  Each route and
kernel has its own launch counter.

A label outside ``[0, V)`` matches no column, so its target term is 0 and
its row's loss is ``lse``: the kernel's arm.  The JAX package's substrate
fallback (``_jnp_chain``) would wrap a label of -1 to the last column
instead; the port follows the kernel, as it does for the xentropy kernels.

A CUDA tensor launches the kernels; a CPU tensor takes the plain versions
(:func:`lm_head_xent_forward_reference`,
:func:`lm_head_xent_backward_reference`), which materialise the logits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .dispatch import LAUNCHES, check_dtype, dtype_code, use_kernel

ROUTES = ("simt", "tc")
for _route in ROUTES:
    for _kernel in ("fwd", "dx", "demb"):
        LAUNCHES.setdefault(f"lm_head_xent_{_kernel}_{_route}", 0)

# the widest E whose 128 own rows stay in an SM's shared memory (tc route)
TC_E_MAX = 768


def lmx_route(dtype, e, *addresses):
    """The kernels' route for x and emb of ``dtype`` and width ``e`` at the
    given base addresses: ``"tc"`` or ``"simt"`` (see the module note)."""
    if (dtype != torch.bfloat16 or e % 8 or e > TC_E_MAX
            or any(a % 16 for a in addresses)):
        return "simt"
    return "tc"


def _logits(x, emb):
    return torch.matmul(x.float(), emb.float().t())


def _onehot(labels, v):
    """(N, V) fp32 one-hot of the labels; a label outside [0, V) gives a
    zero row."""
    cols = torch.arange(v, device=labels.device)
    return (cols[None, :] == labels[:, None].long()).float()


def lm_head_xent_forward_reference(x, emb, labels):
    """The plain version: ``(loss (N,), lse (N,))`` in fp32 from the
    materialised fp32 logits."""
    s = _logits(x, emb)
    lse = torch.logsumexp(s, dim=1)
    tgt = (s * _onehot(labels, emb.shape[0])).sum(dim=1)
    return lse - tgt, lse


def lm_head_xent_backward_reference(x, emb, labels, lse, g):
    """The plain version of the backward: ``(dx, demb)`` in x's and emb's
    dtypes, from the recomputed fp32 logits."""
    s = _logits(x, emb)
    p = torch.exp(s - lse.float()[:, None])
    dl = g.float()[:, None] * (p - _onehot(labels, emb.shape[0]))
    dx = torch.matmul(dl, emb.float())
    demb = torch.matmul(dl.t(), x.float())
    return dx.to(x.dtype), demb.to(emb.dtype)


def _validate(x, emb, labels, what):
    if x.dim() != 2 or emb.dim() != 2 or x.shape[1] != emb.shape[1]:
        raise ValueError(f"{what} takes x (N, E) and emb (V, E), got "
                         f"{tuple(x.shape)} and {tuple(emb.shape)}")
    check_dtype(x, f"{what} x")
    check_dtype(emb, f"{what} emb")
    if tuple(labels.shape) != (x.shape[0],):
        raise ValueError(f"{what}: labels shape {tuple(labels.shape)} != "
                         f"({x.shape[0]},)")
    if labels.is_floating_point() or labels.is_complex():
        raise TypeError(f"{what}: labels must be integers, got "
                        f"{labels.dtype}")


def _kernel_args(x, emb, labels, what):
    """The checks the kernels add to the plain version's: one dtype for x
    and emb, contiguous rows; the labels as int32."""
    if x.dtype != emb.dtype:
        raise TypeError(f"{what}: the kernel takes x and emb in one dtype, "
                        f"got {x.dtype} and {emb.dtype}")
    if not (x.is_contiguous() and emb.is_contiguous()):
        raise ValueError(f"{what}: x and emb must be contiguous")
    return labels.to(torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("lm_head_xent")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apex_lmx_fwd.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.apex_lmx_fwd.restype = i
    for fn in (lib.apex_lmx_bwd_dx, lib.apex_lmx_bwd_dw):
        fn.argtypes = [p] * 6 + [i] * 5 + [p]
        fn.restype = i
    lib.apex_lmx_tc_smem.argtypes = [i, i]
    lib.apex_lmx_tc_smem.restype = i
    return lib


def lm_head_xent_forward(x, emb, labels):
    """x (N, E), emb (V, E), labels (N,) int.  -> ``(loss, lse)``, both fp32
    of shape (N,)."""
    _validate(x, emb, labels, "lm_head_xent_forward")
    if not use_kernel(x, emb, labels):
        return lm_head_xent_forward_reference(x, emb, labels)
    lab = _kernel_args(x, emb, labels, "lm_head_xent_forward")
    (n, e), v = x.shape, emb.shape[0]
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if n == 0:
        return loss, lse
    route = lmx_route(x.dtype, e, x.data_ptr(), emb.data_ptr())
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.apex_lmx_fwd(
            x.data_ptr(), emb.data_ptr(), lab.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), n, v, e, dtype_code(x.dtype), ROUTES.index(route),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"lm_head_xent_forward ({route})")
    LAUNCHES[f"lm_head_xent_fwd_{route}"] += 1
    return loss, lse


def lm_head_xent_backward(x, emb, labels, lse, g):
    """x, emb, labels as for the forward; lse (N,) fp32 from it; g (N,) the
    incoming gradient of the per-row losses.  -> ``(dx, demb)`` in x's and
    emb's dtypes: two launches, dx over the rows, demb over the
    vocabulary."""
    _validate(x, emb, labels, "lm_head_xent_backward")
    n = x.shape[0]
    for name, t in (("lse", lse), ("g", g)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"lm_head_xent_backward: {name} shape "
                             f"{tuple(t.shape)} != ({n},)")
    if not use_kernel(x, emb, labels, lse, g):
        return lm_head_xent_backward_reference(x, emb, labels, lse, g)
    lab = _kernel_args(x, emb, labels, "lm_head_xent_backward")
    lse = lse.to(torch.float32).contiguous()
    gm = g.to(torch.float32).contiguous()
    e, v = x.shape[1], emb.shape[0]
    dx = torch.empty_like(x)
    demb = torch.empty_like(emb)
    if n == 0:
        return dx, demb.zero_()
    route = lmx_route(x.dtype, e, x.data_ptr(), emb.data_ptr())
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), emb.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                gm.data_ptr())
        tail = (n, v, e, dtype_code(x.dtype), ROUTES.index(route), stream)
        err = lib.apex_lmx_bwd_dx(*args, dx.data_ptr(), *tail)
        _build.check(lib, err, f"lm_head_xent_backward (dx, {route})")
        LAUNCHES[f"lm_head_xent_dx_{route}"] += 1
        err = lib.apex_lmx_bwd_dw(*args, demb.data_ptr(), *tail)
        _build.check(lib, err, f"lm_head_xent_backward (demb, {route})")
        LAUNCHES[f"lm_head_xent_demb_{route}"] += 1
    return dx, demb


class _FusedLMHeadXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, emb, labels):
        loss, lse = lm_head_xent_forward(x, emb, labels)
        ctx.save_for_backward(x, emb, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, emb, labels, lse = ctx.saved_tensors
        dx, demb = lm_head_xent_backward(x, emb, labels, lse, g)
        return dx, demb, None


def fused_lm_head_xent(x, emb, labels):
    """x (N, E) activations, emb (V, E) head weight, labels (N,) int ->
    per-row cross-entropy losses (N,) fp32, differentiable in x and emb.
    On the card neither pass materialises the (N, V) logits."""
    return _FusedLMHeadXent.apply(x.contiguous(), emb.contiguous(), labels)
