"""Inference: weight-only int8 quantization and the int8 KV cache
(quant.py), decode as CUDA graphs per bucket (decode.py), the rolling
sliding-window KV cache (rolling.py), greedy and sampled speculative
decoding (speculative.py) with draft construction and distillation
(draft.py), beam search (beam.py) and stateful decode sessions
(session.py): the JAX package's ``apex_tpu/inference`` surface."""
from .quant import (QuantKV, QuantTensor, absmax_int8, gather_rows,
                    kv_value, kv_write, make_kv_cache, quantize_int8,
                    quantize_tensor_int8)
from .rolling import (ROLLING_SLACK, rolling_kv_write,
                      rolling_slot_positions, window_retired_blocks)
from .beam import beam_generate
from .draft import make_self_draft, train_draft
from .session import DecodeSession, PagedSession
from .speculative import speculative_generate

__all__ = ["DecodeSession", "PagedSession", "QuantKV", "QuantTensor",
           "ROLLING_SLACK", "absmax_int8", "beam_generate", "gather_rows",
           "kv_value", "kv_write", "make_kv_cache", "make_self_draft",
           "quantize_int8", "quantize_tensor_int8", "rolling_kv_write",
           "rolling_slot_positions", "speculative_generate", "train_draft",
           "window_retired_blocks"]
