"""Shared fixtures of the port's decode tests: tiny GPT and Llama models
of the JAX package and their copies in the port (weights carried by
``from_jax_state_dict``) and seeded ids."""
import numpy as np

import apex_tpu.nn as jnn
from apex_tpu.models import GptModel as JaxGpt
from apex_tpu.models import LlamaModel as JaxLlama

from apex_tpu_torch.models import GptModel, LlamaModel, from_jax_state_dict

V = 96
GPT_CFG = dict(vocab_size=V, hidden=32, layers=2, heads=4,
               max_positions=64, dropout=0.0, attn_dropout=0.0)
LLAMA_CFG = dict(vocab_size=V, hidden=32, layers=2, heads=4, kv_heads=2,
                 intermediate=64, max_positions=64)


def sd(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


def gpt_pair(seed=3, **kw):
    cfg = {**GPT_CFG, **kw}
    jnn.manual_seed(seed)
    jm = JaxGpt(**cfg)
    jm.eval()
    tm = GptModel(**cfg, device="cpu").eval()
    return jm, from_jax_state_dict(tm, sd(jm))


def llama_pair(seed=4, **kw):
    cfg = {**LLAMA_CFG, **kw}
    jnn.manual_seed(seed)
    jm = JaxLlama(**cfg)
    jm.eval()
    tm = LlamaModel(**cfg, device="cpu").eval()
    return jm, from_jax_state_dict(tm, sd(jm))


def pair(family, seed=3, **kw):
    return (gpt_pair if family == "gpt" else llama_pair)(seed, **kw)


def ids(seed, b, s, v=V):
    return np.random.default_rng(seed).integers(0, v, (b, s))
