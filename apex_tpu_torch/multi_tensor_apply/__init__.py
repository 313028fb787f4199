from .multi_tensor_apply import MultiTensorApply, multi_tensor_applier

__all__ = ["MultiTensorApply", "multi_tensor_applier"]
