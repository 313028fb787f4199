"""Counterparts of the JAX package's ``contrib`` modules:

    from apex_tpu_torch.contrib import groupbn, multihead_attn, xentropy
"""
from . import groupbn  # noqa: F401
