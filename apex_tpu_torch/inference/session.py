"""Stateful multi-turn decode sessions over the LM cache protocol, the
PyTorch counterpart of ``apex_tpu/inference/session.py``.

:class:`DecodeSession` keeps the KV caches and the write cursor alive
across calls: ``append`` ingests tokens at the cursor through
``decode_chunk``, ``generate`` continues from the kept last logits through
the session's decode graphs (:mod:`.decode`, one a sampler configuration,
each over the session's own caches, so they key on its capacity), and
``reset`` drops the decode state.  :class:`PagedSession` needs the serve
engine (ROADMAP A6) and refuses.
"""
from __future__ import annotations

import torch

from .._unported import refuse
from ..utils.jit_cache import compiled_run_cache, model_tensors
from .decode import DecodeGraph, cache_name, compute_dtype, model_device
from .quant import QuantKV, raw


class DecodeSession:
    """Incremental decoding with persistent KV caches.

    ``DecodeSession(model, batch=1, capacity=None, cache_dtype=None)``
    allocates caches for ``capacity`` positions (default
    ``model.max_positions``).  Then any interleaving of ``append(tokens)``
    (teacher-force ``tokens (B, S)``; returns their logits), ``generate(n,
    temperature=0.0, top_k=None, top_p=None, generator=None)`` (continue
    from the cursor; returns the ``(B, n)`` new tokens, also ingested) and
    ``reset()``.  ``session.position`` is the write cursor.  The output
    equals one-shot ``generate`` on the concatenated history up to the
    ingest's arithmetic (``decode_chunk`` instead of the flash prefill)."""

    def __init__(self, model, batch=1, capacity=None, cache_dtype=None):
        for a in ("init_caches", "decode_chunk", "decode_step"):
            if not hasattr(model, a):
                raise ValueError(
                    f"DecodeSession needs model.{a} (the GPT/Llama "
                    f"cache protocol)")
        self.model = model
        self.batch = batch
        self.capacity = capacity if capacity is not None \
            else model.max_positions
        if not 1 <= self.capacity <= model.max_positions:
            raise ValueError(
                f"capacity must be in [1, max_positions="
                f"{model.max_positions}], got {self.capacity}")
        self._cache_dtype = cache_dtype if cache_dtype is not None \
            else compute_dtype(model)
        self._vocab = getattr(model, "vocab_size", None) \
            or raw(model.tok_emb).shape[0]
        with torch.inference_mode(False):
            self.caches = model.init_caches(batch, self.capacity,
                                            dtype=self._cache_dtype)
        #: run the decode graphs' steps un-captured (a reference arm)
        self._eager = False
        self.reset()

    def reset(self):
        """Drop the decode state; the caches (which the session's graphs
        hold) are zeroed in place."""
        with torch.no_grad():
            for kv in self.caches:
                for c in kv:
                    for t in (c if isinstance(c, QuantKV) else (c,)):
                        t.zero_()
        self.position = 0
        self._last_logits = None

    def _check_room(self, n, what):
        if self.position + n > self.capacity:
            raise ValueError(
                f"{what}: cursor {self.position} + {n} tokens exceeds "
                f"the session capacity {self.capacity} — reset() or "
                f"allocate a larger session")

    def append(self, tokens):
        """Ingest ``tokens (B, S)`` at the cursor; returns their logits
        ``(B, S, V)`` (the last row is the next-token distribution)."""
        if tokens.dim() != 2 or tokens.shape[0] != self.batch:
            raise ValueError(
                f"append expects (batch={self.batch}, S) token ids, "
                f"got {tuple(tokens.shape)}")
        s = int(tokens.shape[1])
        self._check_room(s, "append")
        toks = tokens.to(device=model_device(self.model), dtype=torch.long)
        with torch.no_grad():
            logits, _ = self.model.decode_chunk(toks, self.caches,
                                                self.position)
        self.position += s
        self._last_logits = logits[:, -1]
        return logits

    def _graph(self, temperature, top_k, top_p, sample):
        return compiled_run_cache(
            self, "_session_jit_cache",
            (self.batch, self.capacity, cache_name(self._cache_dtype),
             float(temperature), top_k,
             None if top_p is None else float(top_p)),
            model_tensors(self.model),
            lambda: DecodeGraph(self.model, self.batch, self.capacity,
                                self._cache_dtype, sample, temperature > 0.0,
                                caches=self.caches))

    def generate(self, max_new_tokens, temperature=0.0, top_k=None,
                 top_p=None, generator=None):
        """Continue the session by ``max_new_tokens`` (greedy, or sampled
        with ``generate``'s knobs from ``generator``); the emitted tokens
        are ingested like any turn.  Needs a prior ``append``."""
        from ..models.gpt import make_sampler
        if self.position == 0:
            raise ValueError(
                "generate on an empty session — append a prompt first")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self._check_room(max_new_tokens, "generate")
        sample = make_sampler(temperature, top_k, top_p, self._vocab)
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a "
                             "torch.Generator")
        graph = self._graph(temperature, top_k, top_p, sample)
        pos = self.position
        with torch.no_grad():
            # the token at the cursor comes from the kept logits
            graph.set_start(sample(self._last_logits, generator), pos)
        graph.steps(pos, max_new_tokens, generator, eager=self._eager)
        toks = graph.out[:, pos:pos + max_new_tokens].clone()
        self._last_logits = graph.logits.clone()
        self.position += max_new_tokens
        return toks


class PagedSession:
    """A decode session over a serve engine's block pool; the engine is
    ROADMAP A6 and not ported, so this refuses."""

    def __init__(self, engine):
        refuse("PagedSession (a session over the serve engine's block pool)",
               "ROADMAP A6, serve/")
