from . import op_categories
from .op_categories import (BANNED_FUNCS, CASTS, FP16_FUNCS, FP32_FUNCS,
                            SEQUENCE_CASTS)

__all__ = ["BANNED_FUNCS", "CASTS", "FP16_FUNCS", "FP32_FUNCS",
           "SEQUENCE_CASTS", "op_categories"]
