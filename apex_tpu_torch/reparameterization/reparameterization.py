"""Generalised weight reparameterization, the PyTorch counterpart of
``apex_tpu/reparameterization/reparameterization.py`` (the reference's
``apex/reparameterization/reparameterization.py``).

The reference computes the weight in a forward pre-hook of the module that
owns it.  The port's models read many weights without calling their
module (``models/llama.py`` reads ``q_proj.weight`` straight into a
matmul), so a hook would not fire.  As the JAX package computes the
attribute on every read (``Parameter._derived``), so does the port: the
owning module is given a class of its own (once; the original class is
its base, as ``torch.nn.utils.parametrize`` does it) on which the
replaced name is a property that computes the weight from the source
parameters, registered under the JAX package's names (``<name>_g`` and
``<name>_v``, ``<name>_w0``, ``<name>_lora_b`` and ``<name>_lora_a``).  So
the state dict holds the sources and no ``<name>`` entry, every reader
of the attribute sees the computed weight, gradients reach the sources,
and under ``torch.func.functional_call`` (the fused train step) the
property reads the swapped-in sources.  ``remove`` bakes the current
value into a plain parameter and gives the module its class back once
nothing of it is reparameterized.
"""
from __future__ import annotations

import torch
from torch import nn


def _reparameterized_class(module):
    """The module's own subclass, made on first use."""
    cls = type(module)
    if not getattr(cls, "_reparameterized_base", None):
        cls = type(cls.__name__, (cls,), {"_reparameterized_base": cls})
        module.__class__ = cls
    return cls


def _computed(name):
    def get(module):
        return module._reparameterizations[name].compute_weight(module, name)
    return property(get)


class Reparameterization:
    """The interface of a weight reparameterization.

    ``reparameterization_names`` holds the names of the source parameters;
    ``backward_hook_key`` stays None (there is no hook to manage), as in
    the JAX package."""

    def __init__(self, name, dim, module, retain_forward=True):
        self.name = name
        self.dim = dim
        self.evaluated = False
        self.retain_forward = retain_forward
        self.reparameterization_names = []
        self.backward_hook_key = None
        self.module = module

    def compute_weight(self, module=None, name=None):
        """The reparameterized weight, computed from the source parameters
        of ``module`` (see WeightNorm for an example)."""
        raise NotImplementedError

    def reparameterize(self, name, weight, dim):
        """``(names, params)``: the source parameters that replace
        ``name`` (see WeightNorm for an example)."""
        raise NotImplementedError

    @staticmethod
    def apply(module, name, dim, reparameterization=None, hook_child=True,
              strict=True):
        """Reparameterize ``module``'s parameter ``name`` (dotted paths
        reach into children).  With ``hook_child`` the instance belongs to
        the parameter's own module, else to ``module`` under the full
        name.  With ``strict`` (an explicit name) a missing or ineligible
        parameter raises; the bulk ``''`` sweep passes ``strict=False``
        and skips it."""
        if reparameterization is None:
            reparameterization = Reparameterization
        module2use, name2use = Reparameterization.get_module_and_name(
            module, name)
        if name2use is None or isinstance(module2use, nn.Embedding):
            if strict:
                if name2use is None:
                    raise AttributeError(
                        f"parameter '{name}' not found in "
                        f"{type(module).__name__}")
                raise ValueError(
                    "reparameterization does not support Embedding "
                    f"parameters ('{name}')")
            return None

        from ..inference.quant import quantized_names
        if name2use in quantized_names(module2use):
            if strict:
                raise ValueError(
                    f"cannot reparameterize int8-quantized weight '{name}' "
                    f"— quantized models are inference-only; reparameterize "
                    f"first, quantize after")
            return None
        reparams = getattr(module2use, "_reparameterizations", {})
        weight = module2use._parameters.get(name2use)
        if weight is None or name2use in reparams \
                or not weight.is_floating_point() or weight.dim() <= 1:
            if strict:
                if name2use in reparams:
                    raise ValueError(f"'{name}' is already reparameterized")
                if weight is None:
                    raise AttributeError(
                        f"'{name}' of {type(module2use).__name__} is not a "
                        "Parameter")
                if not weight.is_floating_point():
                    raise ValueError(
                        f"cannot reparameterize the {weight.dtype} weight "
                        f"'{name}' (needs a floating point weight)")
                raise ValueError(
                    f"cannot reparameterize {weight.dim()}-d parameter "
                    f"'{name}' (needs ndim > 1)")
            return None

        if hook_child:
            fn = reparameterization(name2use, dim, module2use)
        else:
            fn = reparameterization(name, dim, module)

        # the sources are made before the module changes: a weight that
        # reparameterize rejects (LoRA's rank bound) leaves it intact, and
        # the bulk sweep skips it
        try:
            names, params = fn.reparameterize(name2use, weight, dim)
        except ValueError:
            if strict:
                raise
            return None
        del module2use._parameters[name2use]
        for n, p in zip(names, params):
            module2use.register_parameter(n, p)
        fn.reparameterization_names = names
        if "_reparameterizations" not in module2use.__dict__:
            module2use._reparameterizations = {}
        module2use._reparameterizations[name2use] = fn
        setattr(_reparameterized_class(module2use), name2use,
                _computed(name2use))
        return fn

    @staticmethod
    def get_module_and_name(module, name):
        """The owning (child) module and local name of a possibly dotted
        parameter path."""
        name2use = None
        module2use = None
        names = name.split(".")
        if len(names) == 1 and names[0] != "":
            name2use = names[0]
            module2use = module
        elif len(names) > 1:
            module2use = module
            name2use = names[0]
            for i in range(len(names) - 1):
                module2use = getattr(module2use, name2use)
                name2use = names[i + 1]
        return module2use, name2use

    def get_params(self, module):
        return [getattr(module, n) for n in self.reparameterization_names]

    def remove(self, module=None):
        """Bake the current value into a plain parameter in place of the
        sources.  ``self.name`` is relative to ``self.module`` (the owning
        child, or the root without ``hook_child``)."""
        module2use, name2use = Reparameterization.get_module_and_name(
            self.module, self.name)
        from ..inference.quant import quantized_names
        with torch.no_grad():
            weight = self.compute_weight(module2use, name2use).clone()
        for n in self.reparameterization_names:
            del module2use._parameters[n]
        reparams = module2use._reparameterizations
        reparams.pop(name2use, None)
        cls = type(module2use)
        delattr(cls, name2use)
        if not reparams and not quantized_names(module2use):
            # the class's own properties are gone: give the module its own
            # class back (an int8 weight keeps the subclass's property)
            module2use.__class__ = cls._reparameterized_base
        module2use.register_parameter(name2use, nn.Parameter(weight))
