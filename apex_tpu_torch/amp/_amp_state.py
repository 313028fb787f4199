"""Shared amp session state, the PyTorch counterpart of
``apex_tpu/amp/_amp_state.py``: the object through which ``initialize``,
``scale_loss`` and the patched optimizers talk."""
from __future__ import annotations


class AmpState:
    def __init__(self):
        self.hard_override = False
        self.allow_incoming_model_not_fp32 = False
        self.verbosity = 1
        # set by amp.initialize
        self.opt_properties = None
        self.loss_scalers = []
        self.min_loss_scale = None
        self.max_loss_scale = 2.0 ** 24
        # O1: the session's policy (amp.initialize) or the legacy handle
        # (amp.init), and the policy every module call without one of its
        # own runs under (the reference patches torch globally)
        self.handle = None
        self.ambient_policy = None


_amp_state = AmpState()


def reset():
    """Clear what ``amp.initialize`` or ``amp.init`` set, so a fresh
    session can run in the same process (tests, notebooks): the scalers,
    the O1 policy and the module hooks that apply it."""
    from .policy import remove_module_hooks
    _amp_state.opt_properties = None
    _amp_state.loss_scalers = []
    _amp_state.handle = None
    _amp_state.ambient_policy = None
    remove_module_hooks()


def warn_or_err(msg):
    if _amp_state.hard_override:
        print("Warning:  " + msg)
    else:
        raise RuntimeError(msg)


def maybe_print(msg, rank0=False):
    """Print ``msg`` when the verbosity is above 0.  ``rank0`` limits it to
    rank 0 of an initialised ``torch.distributed`` group."""
    if _amp_state.verbosity > 0:
        if rank0:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized() \
                    and dist.get_rank() != 0:
                return
        print(msg)


def master_params(optimizer):
    """The (master) parameters ``optimizer`` updates, e.g. for gradient
    clipping: ``clip_grad_norm_(amp.master_params(optimizer), max_norm)``."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            yield p
