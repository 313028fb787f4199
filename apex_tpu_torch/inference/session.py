"""Stateful multi-turn decode sessions over the LM cache protocol, the
PyTorch counterpart of ``apex_tpu/inference/session.py``.

:class:`DecodeSession` keeps the KV caches and the write cursor alive
across calls: ``append`` ingests tokens at the cursor through
``decode_chunk``, ``generate`` continues from the kept last logits through
the session's decode graphs (:mod:`.decode`, one a sampler configuration,
each over the session's own caches, so they key on its capacity), and
``reset`` drops the decode state.  :class:`PagedSession` is a batch-1
session whose KV state is a block table into a
:class:`~apex_tpu_torch.serve.ServeEngine`'s pool, run through the
engine's own prefill and decode programs (their CUDA graphs on the card).
"""
from __future__ import annotations

import numpy as np
import torch

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
    """A decode session whose KV state is a BLOCK TABLE into a shared
    :class:`~apex_tpu_torch.serve.ServeEngine` pool: no private cache
    buffer.

    Where :class:`DecodeSession` allocates ``(B, H, capacity, D)`` caches
    per layer up front, a PagedSession holds only the ids of the pool
    blocks its history fills, growing block by block.  Its programs are
    the ENGINE's prefill and decode programs (on the card the same CUDA
    graphs its continuous-batching loop replays), so an interactive session
    and the batch-serving path cannot drift, and opening a session
    captures nothing new once the engine's buckets are warm.

    Same surface as DecodeSession (``append`` / ``generate`` / ``reset`` /
    ``position``), batch 1, greedy ``generate``.  ``append`` returns only
    the LAST position's logits ``(1, V)``.  Use as a context manager (or
    call ``close()``) so the blocks return to the pool.  The first
    ``append`` of an empty session walks the engine's prefix cache: a
    conversation replay adopts the committed blocks it matches.
    """

    def __init__(self, engine):
        self.engine = engine
        self._table = []
        self.position = 0
        self._last_logits = None
        # prefix-cache state: every ingested token in order (the chain
        # source), the rolling chain keys of committed full blocks, and the
        # tag the chain was built under (a weight republish mid-session
        # changes the engine's tag and stops this session from publishing
        # further, mixed-epoch, blocks)
        self._tokens = []
        self._chain = []
        self._committed = 0
        self._cache_tag = None
        self._cacheable = True

    # -- block-table state -------------------------------------------------

    @property
    def block_table(self):
        """The session's logical -> physical block ids."""
        return tuple(self._table)

    def _ensure(self, n_positions, what):
        from ..serve.pool import blocks_for
        eng = self.engine
        if n_positions > eng.model.max_positions:
            raise ValueError(
                f"{what}: {n_positions} positions exceed max_positions "
                f"{eng.model.max_positions}")
        need = blocks_for(n_positions, eng.block_size) - len(self._table)
        if need > 0:
            ids = eng.block_pool.alloc(need)
            if ids is None:
                raise RuntimeError(
                    f"{what}: block pool exhausted "
                    f"({eng.block_pool.in_use}/{eng.block_pool.capacity}"
                    f" in use) — close idle sessions or build the "
                    f"engine with more num_blocks")
            self._table.extend(ids)

    def _commit_full(self):
        """Publish every newly full block into the engine pool's hash
        index (the PagedSession half of the scheduler's note_commit)."""
        from ..serve.pool import chain_key
        eng = self.engine
        sched = eng.scheduler
        if not sched.prefix_cache or not self._cacheable:
            return
        if self._cache_tag is None:
            self._cache_tag = sched.cache_tag
        elif sched.cache_tag != self._cache_tag:
            # publish_weights re-tagged the engine mid-session
            self._cacheable = False
            return
        bs = eng.block_size
        full = min(self.position // bs, len(self._table),
                   len(self._tokens) // bs)
        while self._committed < full:
            i = self._committed
            prev = self._chain[i - 1] if i else ""
            key = chain_key(prev, self._tokens[i * bs:(i + 1) * bs],
                            self._cache_tag)
            self._chain.append(key)
            eng.block_pool.commit(self._table[i], key)
            self._committed = i + 1

    def _adopt_prefix(self, toks) -> int:
        """First-append prefix walk: adopt every cached full block of
        ``toks`` shared and return the number of already-ingested
        positions.  A FULL-chain hit forks the last shared block
        copy-on-write (the final token must re-ingest for its logits, and
        that row lands inside the shared block)."""
        from ..observe import registry as _obs
        from ..serve.pool import chain_keys
        eng = self.engine
        sched = eng.scheduler
        if not sched.prefix_cache:
            return 0
        tag = sched.cache_tag
        keys = chain_keys(toks, eng.block_size, tag)
        shared = eng.block_pool.acquire_prefix(keys)
        if not shared:
            return 0
        self._cache_tag = tag
        if len(shared) * eng.block_size >= len(toks):
            fdst_l = eng.block_pool.alloc(1)
            if fdst_l is None:
                # no room for the fork: a partial hit instead (the last
                # shared block retires cached)
                eng.block_pool.free([shared[-1]])
                shared = shared[:-1]
            else:
                fsrc, fdst = shared[-1], fdst_l[0]
                eng._fork(fsrc, fdst)
                eng.block_pool.free([fsrc])   # the copy is in the stream
                eng._cow_forks += 1
                _obs.counter("serve.prefix.cow_forks").inc()
                self._table = shared[:-1] + [fdst]
                self._chain = keys[:len(shared) - 1]
                self._committed = len(shared) - 1
                self.position = len(toks) - 1
                return self.position
        self._table = list(shared)
        self._chain = keys[:len(shared)]
        self._committed = len(shared)
        self.position = len(shared) * eng.block_size
        return self.position

    # -- public ------------------------------------------------------------

    def append(self, tokens):
        """Ingest ``tokens`` (a 1-D sequence, or ``(1, S)``) at the cursor
        through the engine's chunked prefill program; returns the final
        ingested position's logits ``(1, V)``."""
        eng = self.engine
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.tolist()
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if not toks:
            raise ValueError("append of zero tokens")
        prefill_prog, _ = eng._programs()
        chunk = eng.scheduler.prefill_chunk
        done = 0
        if self.position == 0:
            # empty session: a conversation replay (or a shared system
            # prompt another session committed) is a natural prefix hit
            done = self._adopt_prefix(toks)
        self._tokens.extend(toks)
        while done < len(toks):
            n = min(chunk, len(toks) - done)
            self._ensure(self.position + n, "append")
            padded = toks[done:done + n] + [0] * (chunk - n)
            last = eng._submit(prefill_prog, (
                eng.pool, *eng._ints([padded],
                                     eng._padded_table(self._table),
                                     self.position, n)))
            self.position += n
            done += n
            self._commit_full()
        self._last_logits = last
        return last

    def generate(self, max_new_tokens):
        """Greedily continue by ``max_new_tokens`` (emitted tokens are
        ingested, like a model turn); returns ``(1, n)`` token ids."""
        eng = self.engine
        if self.position == 0:
            raise ValueError(
                "generate on an empty session — append a prompt first")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        _, decode_prog = eng._programs()
        out = [int(torch.argmax(self._last_logits[0]))]
        for i in range(max_new_tokens):
            # ingest the token at the cursor; the final iteration only
            # refreshes _last_logits (its successor is the NEXT
            # generate's first token)
            self._ensure(self.position + 1, "generate")
            nxt, logits = eng._submit(decode_prog, (
                eng.pool, *eng._ints([out[-1]], [self.position],
                                     eng._padded_table(self._table))))
            self.position += 1
            self._tokens.append(out[-1])
            self._commit_full()
            self._last_logits = logits
            if i < max_new_tokens - 1:
                out.append(int(nxt[0]))
        return torch.tensor([out], dtype=torch.long, device=eng.device)

    def reset(self):
        """Drop the decode state and return the blocks to the pool; the
        session object stays usable."""
        if self._table:
            self.engine.block_pool.free(self._table)
        self._table = []
        self.position = 0
        self._last_logits = None
        self._tokens = []
        self._chain = []
        self._committed = 0
        self._cache_tag = None
        self._cacheable = True

    close = reset

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.reset()
