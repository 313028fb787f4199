from .attn_funcs import attention_reference, flash_attention, self_attn_func
from .self_multihead_attn import SelfMultiheadAttn

__all__ = ["SelfMultiheadAttn", "attention_reference", "flash_attention",
           "self_attn_func"]
