"""The fused MLP, the PyTorch counterpart of ``apex_tpu/mlp``."""
from .mlp import MLP, mlp_function

__all__ = ["MLP", "mlp_function"]
