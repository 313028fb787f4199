from .bert import (BertForMaskedLM, BertLayer, BertModel, bert_base,
                   bert_large)
from . import dcgan
from .convert import from_jax_state_dict, to_numpy_state_dict
from .gpt import (GptBlock, GptModel, generate, gpt2_large, gpt2_medium,
                  gpt2_small, gpt2_xl, make_sampler, nucleus_filter)
from .llama import (LlamaBlock, LlamaModel, apply_rope, llama_1b, llama_7b,
                    llama_tiny, rope_tables)
from .resnet import (BasicBlock, Bottleneck, ResNet, resnet18, resnet34,
                     resnet50, resnet101)
from .seq2seq import (Seq2SeqDecoderLayer, TransformerSeq2Seq,
                      seq2seq_generate, transformer_seq2seq)
from .vit import VitBlock, VitModel, vit_base, vit_small

__all__ = ["BasicBlock", "BertForMaskedLM", "BertLayer", "BertModel",
           "Bottleneck", "GptBlock", "GptModel", "LlamaBlock", "LlamaModel",
           "ResNet", "apply_rope", "bert_base", "bert_large",
           "from_jax_state_dict", "generate", "gpt2_large", "gpt2_medium",
           "gpt2_small", "gpt2_xl", "llama_1b", "llama_7b", "llama_tiny",
           "make_sampler", "nucleus_filter", "resnet18", "resnet34",
           "resnet50", "resnet101", "rope_tables", "Seq2SeqDecoderLayer",
           "TransformerSeq2Seq", "seq2seq_generate", "to_numpy_state_dict",
           "transformer_seq2seq", "VitBlock", "VitModel", "vit_base",
           "vit_small"]
