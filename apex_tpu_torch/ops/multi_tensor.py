"""Multi-tensor ops, the PyTorch counterpart of
``apex_tpu/ops/multi_tensor.py`` (cut to what the GPT training slice runs).

The ``noop_flag`` is an int32 device scalar, as in the JAX package.
``multi_tensor_scale`` sets it on a non-finite input and is plain PyTorch,
as it is plain jnp there.  ``multi_tensor_adam`` is the hand-written Adam
kernel (:mod:`apex_tpu_torch.kernels.multi_tensor`) on CUDA tensors and its
plain version on CPU tensors; unlike the JAX op it updates params and
moments in place and reads the flag as a skip flag (the JAX train step
selects the old values on a set flag, to the same effect).
``adam_unfused`` is the JAX package's per-tensor loop: functional, and
blind to the flag.  ``multi_tensor_sgd`` is the hand-written SGD kernel
(depth 3, or depth 4 with the half model copy) in the same way, skipping
itself on a set flag; ``sgd_unfused`` is the JAX package's per-tensor SGD
loop: functional, returning the old tensors on a set flag.
``multi_tensor_axpby``, ``multi_tensor_l2norm``, ``multi_tensor_maxnorm``,
``multi_tensor_lamb`` and ``multi_tensor_novograd`` are jnp in the JAX
package and plain PyTorch here.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from ..kernels import multi_tensor as _k
from ..kernels.dispatch import resolve_device

ADAM_MODE_L2 = 0          # L2 regularisation (classic Adam)
ADAM_MODE_DECOUPLED = 1   # AdamW decoupled weight decay

_static_nonzero = _k._static_nonzero


def zero_flag(device=None) -> torch.Tensor:
    """A fresh overflow flag, an int32 zero on the card unless ``device``
    says otherwise."""
    return torch.zeros((), dtype=torch.int32, device=resolve_device(device))


def _device_scalar(x, device):
    """``x`` (a number or a device scalar) as an fp32 scalar on ``device``:
    a number is written by a fill there, which a CUDA graph can capture (a
    copy from the host it cannot)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def nonfinite_flag(noop_flag, xs):
    """``noop_flag`` raised to 1 where any of ``xs`` holds an inf or nan,
    all on the device."""
    if not xs:
        return noop_flag
    bad = torch.stack([(~torch.isfinite(x)).any() for x in xs]).any()
    return torch.maximum(noop_flag, bad.to(torch.int32))


def multi_tensor_scale(noop_flag, tensor_lists: Sequence[Sequence[torch.Tensor]],
                       scale):
    """``out[i] = in[i] * scale`` in fp32, cast to ``outs[i]``'s dtype, with
    the flag raised on a non-finite input.  ``tensor_lists = [ins, outs]``
    (``outs`` gives the dtypes).  Returns ``(noop_flag, new_outs)``."""
    ins, outs = tensor_lists
    if not ins:
        return noop_flag, []
    s = torch.as_tensor(scale, dtype=torch.float32, device=ins[0].device)
    new_outs = [(x.float() * s).to(o.dtype) for x, o in zip(ins, outs)]
    return nonfinite_flag(noop_flag, ins), new_outs


def multi_tensor_axpby(noop_flag, tensor_lists, a, b, arg_to_check: int = -1):
    """``out[i] = a * x[i] + b * y[i]`` in fp32, cast to ``outs[i]``'s
    dtype, with the flag raised on a non-finite ``x`` (``arg_to_check``
    0), ``y`` (1) or either (-1).  ``tensor_lists = [xs, ys, outs]``;
    ``a`` and ``b`` are numbers or fp32 device scalars.  Returns
    ``(noop_flag, new_outs)``."""
    xs, ys, outs = tensor_lists
    if not xs:
        return noop_flag, []
    dev = xs[0].device
    at = torch.as_tensor(a, dtype=torch.float32, device=dev)
    bt = torch.as_tensor(b, dtype=torch.float32, device=dev)
    new_outs = [(at * x.float() + bt * y.float()).to(o.dtype)
                for x, y, o in zip(xs, ys, outs)]
    checked = {0: list(xs), 1: list(ys)}.get(arg_to_check,
                                             list(xs) + list(ys))
    return nonfinite_flag(noop_flag, checked), new_outs


def multi_tensor_l2norm(noop_flag, tensor_lists, per_tensor: bool = False):
    """``(noop_flag, total L2 norm, per-tensor norms or None)``, fp32,
    the squares summed in fp32."""
    (xs,) = tensor_lists
    if not xs:
        z = torch.zeros((), dtype=torch.float32)
        return noop_flag, z, (torch.zeros(0) if per_tensor else None)
    sqs = torch.stack([x.float().square().sum() for x in xs])
    total = torch.sqrt(functools.reduce(torch.add, sqs.unbind()))
    return noop_flag, total, (torch.sqrt(sqs) if per_tensor else None)


def multi_tensor_maxnorm(noop_flag, tensor_lists, per_tensor: bool = False):
    """``(noop_flag, max |x| over all tensors, per-tensor max or None)``,
    fp32."""
    (xs,) = tensor_lists
    if not xs:
        z = torch.zeros((), dtype=torch.float32)
        return noop_flag, z, (torch.zeros(0) if per_tensor else None)
    ms = torch.stack([x.float().abs().max() for x in xs])
    return noop_flag, ms.max(), (ms if per_tensor else None)


def multi_tensor_adam(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
                      mode: int, bias_correction: bool, weight_decay, *,
                      bias_corrections=None):
    """Adam / AdamW over ``[grads, params, exp_avgs, exp_avg_sqs]`` in one
    kernel launch per list, in place; nothing changes when the flag is
    set.  ``bias_corrections``, two fp32 device scalars, replace ``1 -
    beta ** step`` (amp's deferred mode).  Returns ``(noop_flag, params,
    exp_avgs, exp_avg_sqs)``."""
    return _k.fused_adam(noop_flag, tensor_lists, lr, beta1, beta2, eps,
                         step, mode, bias_correction, weight_decay,
                         bias_corrections=bias_corrections)


def adam_unfused(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
                 mode: int, bias_correction: bool, weight_decay):
    """The JAX package's per-tensor Adam / AdamW: new tensors in the
    params' and moments' dtypes, the flag neither read nor written.  Bias
    correction on the host for a Python ``step``, on the device for a
    tensor one."""
    gs, ps, ms, vs = tensor_lists
    if not gs:
        return noop_flag, [], [], []
    scal = _k.adam_scalars(lr, beta1, beta2, eps, step, bias_correction,
                           weight_decay, ps[0].device)
    s = list(scal.unbind())
    use_wd = _static_nonzero(weight_decay)
    new_ps, new_ms, new_vs = [], [], []
    for g, p, m, v in zip(gs, ps, ms, vs):
        pf, mf, vf = _k._adam_math(g.float(), p.float(), m.float(),
                                   v.float(), s, mode == ADAM_MODE_DECOUPLED,
                                   use_wd)
        new_ps.append(pf.to(p.dtype))
        new_ms.append(mf.to(m.dtype))
        new_vs.append(vf.to(v.dtype))
    return noop_flag, new_ps, new_ms, new_vs


def multi_tensor_sgd(noop_flag, tensor_lists, wd, momentum, dampening, lr,
                     nesterov: bool, first_run: bool, wd_after_momentum: bool,
                     scale=1.0):
    """Momentum SGD over ``[grads, params, momenta]`` (depth 3) or
    ``[grads, master_params, momenta, model_params]`` (depth 4) in one
    kernel launch per list, in place; nothing changes when the flag is set.
    ``scale`` multiplies the gradients first.  Returns ``(noop_flag,
    params, momenta[, model_params])``."""
    return _k.fused_sgd(noop_flag, tensor_lists, wd, momentum, dampening, lr,
                        nesterov, first_run, wd_after_momentum, scale)


def sgd_unfused(noop_flag, tensor_lists, wd, momentum, dampening, lr,
                nesterov: bool, first_run: bool, wd_after_momentum: bool,
                scale=1.0):
    """The JAX package's per-tensor SGD: new tensors in the params',
    momenta's and model copies' dtypes, the old ones where the flag is set
    (the reference kernel's early exit).  Depth 3 returns ``(flag, params,
    momenta)``, depth 4 also the model copies."""
    depth = len(tensor_lists)
    if depth not in (3, 4):
        raise ValueError(f"multi_tensor_sgd supports depth 3 or 4, got "
                         f"{depth}")
    gs, ps, ms = tensor_lists[:3]
    outs = ([], [], []) if depth == 4 else ([], [])
    if not gs:
        return (noop_flag,) + outs
    s = list(_k.sgd_scalars(lr, wd, scale, momentum, dampening,
                            ps[0].device).unbind())
    skip = noop_flag.reshape(()) > 0
    copies = tensor_lists[3] if depth == 4 else [None] * len(gs)
    for g, p, m, c in zip(gs, ps, ms, copies):
        pf, mf = _k._sgd_math(g.float(), p.float(), m.float(), s,
                              momentum != 0.0, nesterov, first_run,
                              wd_after_momentum, _static_nonzero(wd))
        for out, old, new in zip(outs, (p, m, c), (pf, mf, pf)):
            out.append(torch.where(skip, old, new.to(old.dtype)))
    return (noop_flag,) + outs


def _device_corrections(bc1, bc2, device):
    """The bias corrections as fp32 device scalars: a host number would
    divide on the card as a product with its reciprocal (PyTorch's CUDA
    division by a host scalar), which the deferred scale update's device
    corrections do not; on the CPU both divide."""
    return tuple(_device_scalar(b, device) for b in (bc1, bc2))


def _bias_correction(beta, step):
    """``1 - beta**step``: in double on the host for a Python ``step``, in
    fp32 on the device for a tensor one, as the JAX package computes it."""
    if isinstance(step, (int, float)):
        return 1.0 - beta ** step
    stepf = step.to(torch.float32)
    return 1.0 - torch.full_like(stepf, beta) ** stepf


def multi_tensor_lamb(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
                      bias_correction: bool, weight_decay, grad_averaging: int,
                      mode: int, global_grad_norm, max_grad_norm, *,
                      bias_corrections=None):
    """LAMB over ``[grads, params, exp_avgs, exp_avg_sqs]``, plain PyTorch
    per tensor, as the JAX package's op is jnp (no hand kernel).

    Stage 1: the gradient divided by ``global_grad_norm / max_grad_norm``
    where the norm exceeds ``max_grad_norm`` (> 0), weight decay added to
    it (``mode`` 0, L2) or to the update (``mode`` 1, decoupled), Adam
    moments and ``u = (m / bc1) / (sqrt(v / bc2) + eps)``.  Stage 2: the
    trust ratio ``lr * |p| / |u|`` per tensor, plain ``lr`` where either
    norm is 0, and ``p -= ratio * u``.  Functional: returns ``(noop_flag,
    new_params, new_exp_avgs, new_exp_avg_sqs)`` in the inputs' dtypes; the
    flag is neither read nor written (non-finite values propagate)."""
    gs, ps, ms, vs = tensor_lists
    if not gs:
        return noop_flag, [], [], []
    dev = ps[0].device
    if bias_correction and bias_corrections is not None:
        bc1, bc2 = bias_corrections
    elif bias_correction:
        bc1, bc2 = _device_corrections(_bias_correction(beta1, step),
                                       _bias_correction(beta2, step), dev)
    else:
        bc1 = bc2 = 1.0
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    lr = _device_scalar(lr, dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    if max_grad_norm is not None and max_grad_norm > 0:
        gnorm = torch.as_tensor(global_grad_norm, dtype=torch.float32,
                                device=dev)
        clip = torch.where(gnorm > max_grad_norm, gnorm / max_grad_norm, one)
    else:
        clip = one
    use_wd = _static_nonzero(weight_decay)
    new_ps, new_ms, new_vs = [], [], []
    for g, p, m, v in zip(gs, ps, ms, vs):
        gf = g.float() / clip
        pf, mf, vf = p.float(), m.float(), v.float()
        if mode == ADAM_MODE_L2 and use_wd:
            gf = gf + weight_decay * pf
        mf = beta1 * mf + beta3 * gf
        vf = beta2 * vf + (1.0 - beta2) * gf * gf
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        if mode == ADAM_MODE_DECOUPLED and use_wd:
            u = u + weight_decay * pf
        p_norm = torch.sqrt(torch.sum(pf * pf))
        u_norm = torch.sqrt(torch.sum(u * u))
        use_ratio = (p_norm != 0) & (u_norm != 0)
        ratio = torch.where(use_ratio,
                            lr * p_norm / torch.where(use_ratio, u_norm, one),
                            lr)
        new_ps.append((pf - ratio * u).to(p.dtype))
        new_ms.append(mf.to(m.dtype))
        new_vs.append(vf.to(v.dtype))
    return noop_flag, new_ps, new_ms, new_vs


NOVOGRAD_MOMENT_MODE_0 = 0   # L2: g' = g / denom + wd * p into the momentum
NOVOGRAD_MOMENT_MODE_1 = 1   # decoupled: wd * p added to the update


def _novograd_local(gs, norm_type: int):
    """What NovoGrad blends of each gradient, in fp32 as the JAX package
    takes it: ``max|g|`` for ``norm_type`` 0, ``sum(g^2)`` for 2.  (The
    sum of squares, not ``torch.linalg.vector_norm``: the CPU's fp32 norm
    of a large tensor can be 2.6e-4 off on some hosts.)"""
    if norm_type not in (0, 2):
        raise RuntimeError("FusedNovoGrad only support l2/inf norm now.")
    gfs = [g.float() for g in gs]
    if norm_type == 0:
        return [gf.abs().max() for gf in gfs]
    return [sq.sum() for sq in torch._foreach_mul(gfs, gfs)]


def novograd_norms(gs, norm_type: int):
    """Each gradient's fp32 norm as NovoGrad blends it: ``max|g|`` for
    ``norm_type`` 0, ``|g|_2`` for 2."""
    local = _novograd_local(gs, norm_type)
    return local if norm_type == 0 else list(torch._foreach_sqrt(local))


def multi_tensor_novograd(noop_flag, tensor_lists, lr, beta1, beta2, eps,
                          step, bias_correction: bool, weight_decay,
                          grad_averaging: int, moment_mode: int,
                          norm_type: int, *, bias_corrections=None):
    """NovoGrad over ``[grads, params, exp_avgs, grad_norms]``, where
    ``grad_norms`` holds one fp32 running norm scalar per tensor; plain
    PyTorch, as the JAX package's op is jnp (no hand kernel).

    The norm blend: L2 (``norm_type`` 2) ``n = sqrt(beta2 n^2 + (1 - beta2)
    |g|^2)``; L-inf (0) ``n = beta2 n + (1 - beta2) max|g|``, a linear
    blend, not a running max.  With
    ``denom = n / bc2 + eps``, ``bc2 =
    sqrt(1 - beta2^step)`` and ``beta3 = 1 - beta1`` under
    ``grad_averaging`` (else 1): moment mode 0 takes ``m = beta1 m + beta3
    (g / denom + wd p)``, ``p -= lr m / bc1``; mode 1 ``m = beta1 m +
    beta3 g``, ``p -= lr ((m / bc1) / denom + wd p)``, per tensor in
    fp32.  Functional: returns ``(noop_flag, new_params, new_exp_avgs,
    new_grad_norms)`` in the inputs' dtypes; the flag is neither read nor
    written (non-finite values propagate).  ``bias_corrections``, fp32
    device scalars ``(bc1, bc2)`` with ``bc2`` the square root, replace
    the ones of ``step`` (amp's deferred mode)."""
    gs, ps, ms, norms = tensor_lists
    if not gs:
        return noop_flag, [], [], []
    dev = ps[0].device
    if bias_correction and bias_corrections is not None:
        bc1, bc2 = bias_corrections         # bc2 already the square root
    elif bias_correction:
        bc1 = _bias_correction(beta1, step)
        bc2 = _bias_correction(beta2, step)
        bc2 = bc2 ** 0.5 if isinstance(bc2, float) else torch.sqrt(bc2)
        bc1, bc2 = _device_corrections(bc1, bc2, dev)
    else:
        bc1 = bc2 = 1.0
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    lr = _device_scalar(lr, dev)
    local = _novograd_local(gs, norm_type)
    new_ps, new_ms, new_norms = [], [], []
    for g, p, m, vn, loc in zip(gs, ps, ms, norms, local):
        gf, pf, mf, vf = g.float(), p.float(), m.float(), vn.float()
        if norm_type == 0:
            gn = beta2 * vf + (1.0 - beta2) * loc
        else:
            gn = torch.sqrt(beta2 * vf * vf + (1.0 - beta2) * loc)
        denom = gn / bc2 + eps
        if moment_mode == NOVOGRAD_MOMENT_MODE_0:
            mf = beta1 * mf + beta3 * (gf / denom + weight_decay * pf)
            pf = pf - lr * (mf / bc1)
        else:
            mf = beta1 * mf + beta3 * gf
            pf = pf - lr * ((mf / bc1) / denom + weight_decay * pf)
        new_ps.append(pf.to(p.dtype))
        new_ms.append(mf.to(m.dtype))
        new_norms.append(gn.to(vn.dtype))
    return noop_flag, new_ps, new_ms, new_norms
