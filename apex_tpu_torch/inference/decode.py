"""Decode as CUDA graphs per bucket: the port's counterpart of the JAX
package's one compiled program per decode configuration
(``apex_tpu/models/gpt.py::generate``'s ``lax.scan`` under
``utils/jit_cache.py``).

A decode loop is a host loop of steps, each an executor
:class:`~apex_tpu_torch.runtime.executor.Program` over held state: the KV
caches, the current token, the position as a 0-d int64 tensor, a token
buffer and the last logits.  The step reads the position where it lies
(``decode_step`` at a device position), samples, writes the token into
the buffer and increments the position itself, so a replay needs no
host-to-device copy.  On the card the executor runs a program's first call
eagerly, captures its second as a CUDA graph and replays it from then on;
on the CPU every call runs eagerly.  A failed capture raises.

A run is cached per model (:func:`~apex_tpu_torch.utils.jit_cache.
compiled_run_cache`) on its bucket: the batch, the cache capacity (``P +
max_new_tokens`` rounded up to a multiple of :data:`BUCKET`, at most
``max_positions``), the cache dtype, the sampler's configuration and the
parameters' ids.  Its held state lives with the entry, so prompts of
nearby lengths replay one graph.  The buckets of one (batch, capacity,
cache dtype) share one set of KV caches whatever their sampler: a run
reads its caches only between its prefill and its last step, and the runs
of a model do not interleave.  The cache keeps at most 16 entries a model
and at most ``utils.jit_cache.HELD_BYTES`` of their state (caches,
buffers and graph pools), the newest entry aside.

Sampling inside a graph: the draw is ``argmax(probs / E)`` with ``E``
exponential from a generator the program owns and registers with its
graph (what ``torch.multinomial`` computes for one sample, without its
host checks).  Before every step the host seeds that generator with the
caller's seed at the offset the caller's generator would have reached,
so the graph draws what an eager loop on the caller's generator draws,
and the caller's generator is advanced past the run at its end.
"""
from __future__ import annotations

import itertools

import torch

from ..runtime import executor as _executor
from ..utils.jit_cache import compiled_run_cache, model_tensors
from .quant import QuantTensor, raw

#: cache capacities are multiples of this (at most max_positions)
BUCKET = 128

_TOKENS = itertools.count()


def bucket_capacity(s_total, max_positions):
    """The cache capacity of a bucket that holds ``s_total`` positions."""
    return min(-(-s_total // BUCKET) * BUCKET, max_positions)


def model_device(model):
    t = raw(model.tok_emb)
    return t.q.device if isinstance(t, QuantTensor) else t.device


def compute_dtype(model):
    """The dtype of a model's activations and logits: its token table's
    (dequantized) dtype."""
    return raw(model.tok_emb).dtype


def cache_name(cache_dtype):
    return cache_dtype if isinstance(cache_dtype, str) else str(cache_dtype)


def sample_probs(probs, generator):
    """One draw a row from ``probs (..., V)``: ``argmax(probs / E)``, ``E``
    exponential from ``generator`` (``torch.multinomial``'s draw for one
    sample, with no host check, so a CUDA graph can capture it)."""
    e = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / e, dim=-1)


class GraphRun:
    """One executor Program over held state, stepped from a host loop.

    ``fn(state, generator) -> out`` updates ``state`` in place.  With
    ``sampled`` the program draws from a generator of its own on the card
    (registered with its graph) and from the caller's on the CPU; call
    :meth:`start` with the caller's generator before the first step of a
    run and :meth:`finish` after the last."""

    def __init__(self, kind, fn, state, device, sampled):
        self.state = state
        self._fn = fn
        cuda = torch.device(device).type == "cuda"
        self.gen = torch.Generator(device=device) if sampled and cuda \
            else None
        self.program = _executor.Program(
            kind, (next(_TOKENS),), self._body, donate_argnums=(0,),
            generators=(self.gen,) if self.gen is not None else ())
        self._user = None
        self._inc = None
        self._seed = self._off = None

    def _body(self, state):
        with torch.no_grad():
            return self._fn(state, self.gen if self.gen is not None
                            else self._user)

    def start(self, generator):
        self._user = generator
        if self.gen is not None:
            self._seed = generator.initial_seed()
            self._off = generator.get_offset()

    def step(self, eager=False):
        """One step: through the executor (captured and replayed on the
        card), or with ``eager`` the program's function itself on the
        caller's generator (the un-captured step)."""
        if eager:
            with torch.no_grad():
                return self._fn(self.state, self._user)
        if self.gen is None:
            return _executor.executor.submit(self.program, (self.state,))
        self.gen.manual_seed(self._seed)
        self.gen.set_offset(self._off)
        out = _executor.executor.submit(self.program, (self.state,))
        if self._inc is None:
            # the warm-up (the first call, eager) shows what a step draws
            self._inc = self.gen.get_offset() - self._off
        self._off += self._inc
        return out

    def finish(self, eager=False):
        if self.gen is not None and not eager:
            self._user.set_offset(self._off)

    def stats(self):
        return _executor.graph_stats(self.program)

    def held(self):
        """``{storage or pool: bytes}`` of the device state the run holds:
        the storages of its state's tensors and its graph's pool."""
        out = {("pool", id(self.program)): self.stats()["pool_bytes"]}
        todo = [self.state]
        while todo:
            x = todo.pop()
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                out[(x.device, st.data_ptr())] = st.nbytes()
            elif isinstance(x, (list, tuple)):
                todo.extend(x)
        return out


class DecodeGraph:
    """One bucket of ``generate``: the decode step as a :class:`GraphRun`
    over ``(caches, tok (B,), pos (), out (B, capacity + 1), logits (B,
    V))``.
    ``caches`` may be given (a session's own, or another bucket's)."""

    def __init__(self, model, batch, capacity, cache_dtype, sample, sampled,
                 caches=None):
        dev = model_device(model)
        self.model = model
        self.capacity = capacity
        self.sample = sample
        self.cache_key = (batch, capacity, cache_name(cache_dtype))
        if caches is None:
            caches = model.init_caches(batch, capacity, dtype=cache_dtype)
        vocab = raw(model.tok_emb).shape[0]
        long = dict(dtype=torch.long, device=dev)
        self.caches = caches
        self.tok = torch.zeros(batch, **long)
        self.pos = torch.zeros((), **long)
        # one column past the capacity: the last step's sample lands there
        self.out = torch.zeros(batch, capacity + 1, **long)
        self.logits = torch.zeros(batch, vocab, dtype=compute_dtype(model),
                                  device=dev)
        self.run = GraphRun("decode_step", self._step,
                            (caches, self.tok, self.pos, self.out,
                             self.logits), dev, sampled)

    def _step(self, state, generator):
        caches, tok, pos, out, logits_buf = state
        logits, _ = self.model.decode_step(tok, caches, pos)
        nxt = self.sample(logits, generator)
        out.index_copy_(1, pos.reshape(1) + 1, nxt[:, None])
        tok.copy_(nxt)
        logits_buf.copy_(logits)
        pos.add_(1)

    def set_start(self, tok, pos):
        """The token at position ``pos`` (a host int) is the next input."""
        self.tok.copy_(tok)
        self.pos.fill_(pos)
        self.out[:, pos].copy_(tok)

    def steps(self, first, n, generator=None, eager=False, logits=None):
        """``n`` decode steps from host position ``first``; each step's
        logits are appended to the list ``logits`` when one is given."""
        run = self.run
        run.start(generator)
        for t in range(first, first + n):
            if t >= self.capacity:
                raise ValueError(
                    f"decode position {t} is past the capacity "
                    f"{self.capacity}")
            run.step(eager)
            if logits is not None:
                logits.append(self.logits.clone())
        run.finish(eager)

    def prefill(self, prompt, generator=None, logits=None):
        """``generate``'s start: the prompt into the token buffer, one
        eager prefill (``P > 1``) whose last logits give the first new
        token, the start token and position set; returns the position of
        the first decode step."""
        b, p = prompt.shape
        with torch.no_grad():
            self.out[:, :p].copy_(prompt)
            if p == 1:
                self.set_start(prompt[:, 0], 0)
                return 0
            pl, _ = self.model.prefill(prompt, self.caches)
            if logits is not None:
                logits.append(pl[:, -1].clone())
            self.set_start(self.sample(pl[:, -1], generator), p)
        return p

    def generate(self, prompt, max_new_tokens, generator=None, eager=False,
                 logits=None):
        """``generate``'s decode: :meth:`prefill`, then the steps (with
        ``eager`` the un-captured step); returns ``(B, P +
        max_new_tokens)``."""
        s_total = prompt.shape[1] + max_new_tokens
        first = self.prefill(prompt, generator, logits)
        self.steps(first, s_total - 1 - first, generator, eager, logits)
        return self.out[:, :s_total].clone()


def decode_graph(model, batch, s_total, cache_dtype, temperature, top_k,
                 top_p, sample):
    """The cached :class:`DecodeGraph` of ``generate``'s bucket; a new
    bucket takes the caches of a cached one of the same batch, capacity
    and cache dtype."""
    cap = bucket_capacity(s_total, model.max_positions)
    shared = (batch, cap, cache_name(cache_dtype))

    def build():
        caches = next((run.caches for _, _, run in model.__dict__.get(
            "_generate_jit_cache", {}).values() if run.cache_key == shared),
            None)
        return DecodeGraph(model, batch, cap, cache_dtype, sample,
                           temperature > 0.0, caches=caches)
    return compiled_run_cache(
        model, "_generate_jit_cache",
        (batch, cap, cache_name(cache_dtype), float(temperature), top_k,
         None if top_p is None else float(top_p)),
        model_tensors(model), build)
