"""``to_channels_last`` and ``checkpoint_forward``, the PyTorch
counterparts of ``apex_tpu/nn/modules.py::to_channels_last`` and
``::checkpoint_forward``.

The port's layers are ``torch.nn``'s own, whose 2-d convolutions, batch
norms and pools take (B, C, H, W) tensors.  Flipped, each takes and returns
(B, H, W, C) tensors, the JAX package's NHWC contract: a forward pre-hook
hands the layer the permuted view of its input, which has
``torch.channels_last`` strides (cuDNN's NHWC kernels and torch's
channels-last batch norm and pools run on it directly), and a forward hook
permutes its output back, so no layer boundary copies.  The port's
``SyncBatchNorm`` has its own NHWC path (``channel_last``) and is switched
through that flag.  Parameters, buffers and the state dict keep their
names and shapes; a conv weight stays OIHW, in ``CONV_WEIGHT_FORMAT``.

``checkpoint_forward`` runs a module with its activations recomputed in
the backward (``torch.utils.checkpoint``, non-reentrant), the models'
``remat``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call
from torch.nn.modules.batchnorm import _BatchNorm
from torch.nn.modules.conv import _ConvTransposeNd
from torch.nn.modules.instancenorm import _InstanceNorm

# what a flipped tree's 2-d conv weights are stored in: the OIHW shape in
# torch.channels_last memory, so their gradients come back channels-last
# and the optimizer slots, amp masters and half copies follow them with no
# copy; OIHW-contiguous weights cost the fused step one layout copy of
# each 3x3 and 7x7 weight gradient and timed no faster on the H100
# (PERF.md)
CONV_WEIGHT_FORMAT = torch.channels_last

# layers whose channel axis stays at 1: a tree holding one refuses
_REFUSE = (nn.Conv1d, nn.Conv3d, _ConvTransposeNd, nn.BatchNorm1d,
           nn.BatchNorm3d, nn.GroupNorm, _InstanceNorm)
_FLIP = (nn.Conv2d, _BatchNorm, nn.MaxPool2d, nn.AvgPool2d,
         nn.AdaptiveAvgPool2d)


def _to_nchw(module, args):
    return (args[0].permute(0, 3, 1, 2),) + tuple(args[1:])


def _to_nhwc(module, args, out):
    return out.permute(0, 2, 3, 1)


def conv_weights_to(module, memory_format):
    """Store every 2-d conv weight of ``module`` in ``memory_format`` (the
    same Parameter objects, so do it before an optimizer or amp is built
    over them); returns ``module``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(
                memory_format=memory_format)
    return module


def to_channels_last(module, enabled=True):
    """Flip a module tree to channels-last (NHWC) execution, in place: its
    2-d convolutions, batch norms (``SyncBatchNorm`` included) and 2-d pools
    take and return (B, H, W, C) tensors, and its conv weights are stored
    in ``CONV_WEIGHT_FORMAT``; ``enabled=False`` flips it back (weights
    contiguous OIHW).  Returns ``module``.

    A tree holding a layer with no channels-last path (1-d or 3-d
    convolutions, transposed convolutions, 1-d or 3-d batch norms,
    GroupNorm, InstanceNorm) raises ``ValueError`` and is left as it was,
    as the JAX package's refuses rather than mix layouts."""
    mods = list(module.modules())
    for m in mods:
        if isinstance(m, _REFUSE):
            raise ValueError(
                f"to_channels_last: {type(m).__name__} has no "
                f"channels-last path (2-d convs/norms/pools only)")
    from ..parallel.sync_batchnorm import SyncBatchNorm
    for m in mods:
        if not isinstance(m, _FLIP):
            continue
        m.channels_last = bool(enabled)
        if isinstance(m, SyncBatchNorm):
            continue        # its own NHWC path reads the flag
        hooks = m.__dict__.pop("_channels_last_hooks", ())
        for h in hooks:
            h.remove()
        if enabled:
            m._channels_last_hooks = (
                m.register_forward_pre_hook(_to_nchw),
                m.register_forward_hook(_to_nhwc))
    return conv_weights_to(module, CONV_WEIGHT_FORMAT if enabled
                           else torch.contiguous_format)


def checkpoint_forward(module, *inputs, **kwargs):
    """``module(*inputs, **kwargs)`` with the activations inside it
    recomputed in the backward instead of saved
    (``torch.utils.checkpoint``, non-reentrant), trading operations for
    device memory.

    The recomputation runs when autograd reaches the module, which may be
    after the caller's parameter substitution has ended (the fused train
    step differentiates its half-precision leaves after
    ``torch.func.functional_call`` returns).  So the parameters and buffers
    the module holds at the call are captured and substituted again, by
    ``functional_call``, in the recomputation, as the JAX function passes
    their values as arguments.  A ``torch.Generator`` among the arguments
    (the dropout masks' and the flash kernels' seeds) is rewound to its
    state at the call for the recomputation, so it draws the same masks,
    and put back after it, as the JAX function replays its key counter;
    amp O1's active cast policy is restored for it too.  Inside a train
    step's CUDA graph capture the recomputation draws instead from twins of
    the generators that the runtime executor seeds, before every replay, to
    the generators' states at the call (and torch's default generators are
    not rewound).  A module that
    would write running statistics (a batch norm in training) is refused,
    as in the JAX package."""
    from torch.utils.checkpoint import checkpoint

    from ..amp.policy import autocast, current_policy
    if any(m.training and getattr(m, "running_mean", None) is not None
           for m in module.modules()):
        raise ValueError(
            "checkpoint_forward: module writes running statistics "
            "(BatchNorm?) — stat updates cannot cross the remat boundary; "
            "exclude such modules from checkpointing")
    from ..runtime.executor import rewind_twins
    held = dict(module.named_parameters())
    held.update(module.named_buffers())
    gens = [a for a in (*inputs, *kwargs.values())
            if isinstance(a, torch.Generator)]
    # inside a step's CUDA graph capture a generator's state cannot be
    # read or set: the recomputation draws from twins of the generators
    # that the executor keeps at the call's offsets
    twins = rewind_twins(gens) if gens else None
    at_call = None if twins is not None else [g.get_state() for g in gens]
    policy = current_policy()
    ran = []

    def run(*xs):
        if not ran:             # the forward: the module as it stands
            ran.append(True)
            return module(*xs, **kwargs)
        if twins is not None:
            swap = {id(g): t for g, t in zip(gens, twins)}
            xs = tuple(swap.get(id(a), a) for a in xs)
            kw = {k: swap.get(id(v), v) for k, v in kwargs.items()}
            with autocast(policy):
                return functional_call(module, held, xs, kw)
        after = [g.get_state() for g in gens]
        for g, state in zip(gens, at_call):
            g.set_state(state)
        try:
            with autocast(policy):
                return functional_call(module, held, xs, kwargs)
        finally:
            for g, state in zip(gens, after):
                g.set_state(state)

    # the default generators' states (torch's own rewind) cannot be taken
    # inside a capture either; the port's models draw only from the
    # generator they are given
    return checkpoint(run, *inputs, use_reentrant=False,
                      preserve_rng_state=not _capturing())


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
