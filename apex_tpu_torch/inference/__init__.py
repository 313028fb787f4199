from .quant import kv_value, kv_write, make_kv_cache

__all__ = ["kv_value", "kv_write", "make_kv_cache"]
