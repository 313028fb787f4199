"""Weight reparameterizations, the PyTorch counterpart of
``apex_tpu/reparameterization`` (the reference's
``apex/reparameterization``): ``apply_weight_norm`` /
``remove_weight_norm`` / ``apply_reparameterization`` /
``remove_reparameterization`` with the reference's dotted names and
apply-to-everything (``''`` name) sweep, and LoRA."""
from .lora import LoRA, apply_lora, lora_parameters
from .reparameterization import Reparameterization
from .weight_norm import WeightNorm


def apply_weight_norm(module, name="", dim=0, hook_child=True):
    """Weight normalization (``w = g * v / |v|``) of ``name``, or with no
    name of every >1-d parameter of the model."""
    return apply_reparameterization(
        module, reparameterization=WeightNorm, hook_child=hook_child,
        name=name, dim=dim)


def remove_weight_norm(module, name="", remove_all=False):
    return remove_reparameterization(
        module, reparameterization=WeightNorm, name=name,
        remove_all=remove_all)


def apply_reparameterization(module, reparameterization=None, name="",
                             dim=0, hook_child=True):
    assert reparameterization is not None
    if name != "":
        Reparameterization.apply(module, name, dim, reparameterization,
                                 hook_child, strict=True)
    else:
        names = [n for n, _ in module.named_parameters()]
        for name in names:
            Reparameterization.apply(module, name, dim, reparameterization,
                                     hook_child, strict=False)
    return module


def remove_reparameterization(module, reparameterization=Reparameterization,
                              name="", remove_all=False):
    if name != "" or remove_all:
        owner, local = Reparameterization.get_module_and_name(module, name) \
            if name != "" else (None, None)
        removed = False
        for m in list(module.modules()):
            reparams = m.__dict__.get("_reparameterizations")
            if not reparams:
                continue
            for n, fn in list(reparams.items()):
                if isinstance(fn, reparameterization) and (
                        remove_all or (m is owner and n == local)):
                    fn.remove()
                    removed = True
        if not removed and not remove_all:
            raise ValueError(
                f"reparameterization of '{name}' not found in {module}")
        return module
    for m in list(module.modules()):
        remove_reparameterization(m, reparameterization=reparameterization,
                                  remove_all=True)
    return module


__all__ = ["LoRA", "Reparameterization", "WeightNorm", "apply_lora",
           "apply_reparameterization", "apply_weight_norm",
           "lora_parameters", "remove_reparameterization",
           "remove_weight_norm"]
