"""Counterparts of the JAX package's ``contrib`` modules:

    from apex_tpu_torch.contrib import groupbn, multihead_attn, optimizers, \
        xentropy
"""
from . import groupbn, optimizers  # noqa: F401
