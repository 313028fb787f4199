from .jit_cache import compiled_run_cache

__all__ = ["compiled_run_cache"]
