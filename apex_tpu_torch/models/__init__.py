from .convert import from_jax_state_dict, to_numpy_state_dict
from .gpt import (GptBlock, GptModel, generate, gpt2_large, gpt2_medium,
                  gpt2_small, gpt2_xl, make_sampler, nucleus_filter)
from .resnet import (BasicBlock, Bottleneck, ResNet, resnet18, resnet34,
                     resnet50, resnet101)

__all__ = ["BasicBlock", "Bottleneck", "GptBlock", "GptModel", "ResNet",
           "from_jax_state_dict", "generate", "gpt2_large", "gpt2_medium",
           "gpt2_small", "gpt2_xl", "make_sampler", "nucleus_filter",
           "resnet18", "resnet34", "resnet50", "resnet101",
           "to_numpy_state_dict"]
