from .convert import from_jax_state_dict, to_numpy_state_dict
from .gpt import (GptBlock, GptModel, generate, gpt2_large, gpt2_medium,
                  gpt2_small, gpt2_xl, make_sampler, nucleus_filter)

__all__ = ["GptBlock", "GptModel", "from_jax_state_dict", "generate",
           "to_numpy_state_dict",
           "gpt2_large", "gpt2_medium", "gpt2_small", "gpt2_xl",
           "make_sampler", "nucleus_filter"]
