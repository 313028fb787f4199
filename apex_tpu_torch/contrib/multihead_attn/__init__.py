from .attn_funcs import (attention_reference, encdec_attn_func,
                         flash_attention, self_attn_func)
from .encdec_multihead_attn import EncdecMultiheadAttn
from .self_multihead_attn import SelfMultiheadAttn

__all__ = ["EncdecMultiheadAttn", "SelfMultiheadAttn", "attention_reference",
           "encdec_attn_func", "flash_attention", "self_attn_func"]
