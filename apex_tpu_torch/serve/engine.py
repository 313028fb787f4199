"""ServeEngine: the continuous-batching serving loop, the PyTorch
counterpart of ``apex_tpu/serve/engine.py``.

One engine owns one model, one paged KV pool, one scheduler and a small
fixed family of programs (``prefill_step``, ``decode_step``, and with a
draft ``draft_prefill_step`` / ``spec_verify_step``, plus the
copy-on-write ``block_copy``) dispatched through the executor
(:mod:`apex_tpu_torch.runtime.executor`).  On the card each program keeps
one CUDA graph a bucket signature: a signature's first call runs eagerly,
its second is captured, later calls replay, so a serving trace captures
at most one graph a bucket and nothing once its buckets are warm.  The
step cache counts compiles, hits and dispatches per kind
(``metrics()``).  On the CPU every call runs eagerly.

The pools are the programs' held arguments, updated in place: a replay
reads and writes them where they lie and the executor raises if they
move.  The programs read the models' parameters where they lie too, so
:meth:`ServeEngine.publish_weights` copies new values into them.  Request
state reaches a program as device integer tensors (tokens, positions,
block tables, a chunk's first position and live length, a fork's source
and destination), copied from the host once a dispatch; the host reads
back one small integer tensor a decode tick, and the argmax when a
prefill completes.

The tick loop (:meth:`ServeEngine.step`):

1. **admit**: the scheduler moves queue-head requests into the live set
   while batch slots / blocks / prefill backlog allow;
2. **one prefill chunk**: the oldest prefilling session ingests up to
   ``prefill_chunk`` prompt tokens (one chunk a tick, so a long prompt
   interleaves with everyone else's decode instead of stalling it);
   completing prefill emits the first token from the chunk's last logits;
3. **one decode tick**: every decoding session advances one token in a
   single bucketed dispatch; sessions that hit ``max_new_tokens`` or their
   ``eos`` free their blocks this same tick.

Per-request lifecycle telemetry (``serve.request`` events with phases
queued -> prefill -> first_token -> done, TTFT / e2e / tick-latency
histograms, queue-depth and pool-occupancy gauges) flows through
:mod:`apex_tpu_torch.observe.registry`.  Every dispatch heartbeats the
stall watchdog (the executor's serve kinds), and ``run(watchdog_deadline_s=
...)`` arms one over the loop.

Greedy decoding only, as in the JAX package: serving parity is pinned
against ``inference.DecodeSession``.
"""
from __future__ import annotations

import inspect
import itertools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..inference.decode import compute_dtype, model_device
from ..kernels.spec_verify import spec_verify_fp, spec_verify_pays
from ..observe import registry as _obs
from ..observe import watchdog as _watchdog
from ..runtime import executor as _executor
from . import kernels as _kernels
from .pool import BlockPool, blocks_for, init_pool_buffer
from .scheduler import DECODE, Request, Scheduler, Session, bucket

#: per-engine token in the serve programs' static keys: two engines over
#: identically shaped models never share a cache entry (their programs
#: close over different models and pools)
_SERVE_TOKENS = itertools.count()

#: engine roles in a disaggregated deployment (serve/disagg.py)
PHASES = ("unified", "prefill", "decode")


def _dtype_name(dtype) -> str:
    """``"float32"``, ``"bfloat16"``, ``"int8"``: the JAX package's dtype
    names, which the prefix-cache tag carries."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).replace("torch.", "")


class ServeEngine:
    """Continuous-batching paged-KV serving over a GPT-protocol model.

    ``num_blocks`` sizes the shared pool (one block = ``block_size x
    layers x 2 x heads x head_dim`` KV rows; block 0 is the reserved null
    block), allocated on the model's device.  ``cache_dtype`` follows the
    session convention: default the token embedding's dtype, ``"int8"``
    for the quantized pool.  ``window`` enables sliding-window attention
    with block-table retirement.  With a ``draft`` model the engine
    speculates (``spec_k`` proposals a tick, the draft's KV in a pool of
    its own, ``draft_cache_dtype``); ``spec_policy="auto"`` decides per
    bucket shape and, with no measured ledger in the port, always runs
    plain decode ticks (:mod:`apex_tpu_torch.kernels.spec_verify`).
    """

    def __init__(self, model, *, num_blocks, block_size=16, max_batch=8,
                 prefill_chunk=32, cache_dtype=None,
                 max_prefill_backlog=None, window=None, phase="unified",
                 draft=None, spec_k=4, draft_cache_dtype="int8",
                 spec_policy="on", prefix_cache=True):
        self._validate_model(model)
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got "
                             f"{phase!r}")
        self.model = model
        self.device = model_device(model)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.window = window
        self._phase = phase
        blk0 = model.blocks[0]
        self._params = list(model.parameters()) + list(model.buffers())
        dtype = cache_dtype if cache_dtype is not None \
            else compute_dtype(model)
        self._dtype_name = _dtype_name(dtype)
        self.pool = init_pool_buffer(
            len(model.blocks), blk0.attn.num_heads, blk0.attn.head_dim,
            self.num_blocks, self.block_size, dtype, device=self.device)
        self.block_pool = BlockPool(self.num_blocks, self.block_size)
        # -- speculative mode: a draft model served from its OWN pool
        # buffer (int8 by default) whose block ids come from the SAME
        # BlockPool free-list
        self.spec = draft is not None
        self.draft = draft
        self.spec_k = int(spec_k)
        self._spec_policy = spec_policy
        self._d_params: List = []
        self._d_dtype_name = None
        self.dpool = None
        if self.spec:
            self._validate_spec(model, draft, window, self.spec_k,
                                spec_policy)
            dblk0 = draft.blocks[0]
            self._d_params = list(draft.parameters()) \
                + list(draft.buffers())
            d_dtype = draft_cache_dtype if draft_cache_dtype is not None \
                else compute_dtype(draft)
            self._d_dtype_name = _dtype_name(d_dtype)
            self.dpool = init_pool_buffer(
                len(draft.blocks), dblk0.attn.num_heads,
                dblk0.attn.head_dim, self.num_blocks, self.block_size,
                d_dtype, device=self.device)
        if max_prefill_backlog is None:
            max_prefill_backlog = 4 * prefill_chunk
        self.scheduler = Scheduler(
            self.block_pool, max_batch=max_batch,
            prefill_chunk=prefill_chunk,
            max_prefill_backlog=max_prefill_backlog,
            max_positions=model.max_positions,
            spec_tables=self.spec,
            pos_slack=self.spec_k if self.spec else 0,
            prefix_cache=prefix_cache,
            cache_tag=self._cache_tag(epoch=0))
        self._token = next(_SERVE_TOKENS)
        self._decode_prog = None
        self._prefill_prog = None
        self._copy_prog = None
        self._draft_prefill_prog = None
        self._spec_prog = None
        self._dispatch_no = itertools.count(1)
        self._tick = 0
        # prefix-cache telemetry (admission-weighted; the pool keeps its
        # own eviction counter)
        self._prefill_tokens_saved = 0
        self._prefix_prompt_tokens = 0
        self._cow_forks = 0
        self._spec_ticks = 0
        self._spec_committed = 0
        self._spec_offered = 0
        self._spec_accepted = 0
        self.results: Dict[str, List[int]] = {}
        # weight hot-swap bookkeeping: a growing epoch per weight set;
        # every finished request is attributed to the target epoch it was
        # ADMITTED under (the oldest weights any of its tokens saw)
        self.weight_epochs: Dict[str, int] = {"target": 0, "draft": 0}
        self.result_meta: Dict[str, dict] = {}

    @staticmethod
    def _validate_model(model):
        for a in ("blocks", "tok_emb", "pos_emb", "ln_f",
                  "_mask_pad_logits", "max_positions"):
            if not hasattr(model, a):
                raise ValueError(
                    f"ServeEngine needs model.{a} (the GPT decode "
                    f"protocol)")
        blk = model.blocks[0]
        for a in ("_chunk_qkv", "_attn_mlp_tail"):
            if not hasattr(blk, a):
                raise ValueError(
                    f"ServeEngine needs block.{a} — paged attention "
                    f"reuses the model's own decode projections")
        # Llama's _chunk_qkv(x, pos) applies RoPE inside the projection —
        # the paged bodies would silently skip it
        if len(inspect.signature(blk._chunk_qkv).parameters) != 1:
            raise NotImplementedError(
                "ServeEngine supports the GPT-family cache protocol "
                "(_chunk_qkv(x)); rotary-position families need "
                "position-aware paged projections — use the "
                "single-request decode paths for now")

    def _validate_spec(self, model, draft, window, spec_k, spec_policy):
        self._validate_model(draft)
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if window is not None:
            raise NotImplementedError(
                "speculative mode + sliding window: the verify chunk "
                "would need a per-row band mask over retired blocks — "
                "serve one mode or the other")
        if spec_policy not in ("on", "auto"):
            raise ValueError(
                f"spec_policy must be 'on' (always speculate) or "
                f"'auto' (decided per bucket shape), got "
                f"{spec_policy!r}")
        if draft.tok_emb.weight.shape[0] < model.tok_emb.weight.shape[0]:
            raise ValueError(
                "draft vocabulary is smaller than the target's — "
                "verified tokens could not be re-fed to the draft")
        if draft.max_positions < model.max_positions:
            raise ValueError(
                f"draft.max_positions {draft.max_positions} < target's "
                f"{model.max_positions}: the draft cache must cover "
                f"every position the target can reach")
        if model_device(draft) != self.device:
            raise ValueError(
                f"the draft lies on {model_device(draft)}, the target on "
                f"{self.device}")

    # -- programs ----------------------------------------------------------
    # One Program a kind: operand shapes (bucketed batch / blocks / chunk)
    # complete the step-cache key through the argument signature, so each
    # bucket is captured once and session churn replays it.

    def _programs(self):
        if self._decode_prog is None:
            key = (self._token, self._phase, self.block_size,
                   self._dtype_name, self.window)
            self._decode_prog = _executor.Program(
                "decode_step", key,
                _kernels.build_decode_fn(
                    self.model, self._params, self.block_size,
                    self.num_blocks, self.window),
                donate_argnums=(0,))
            self._prefill_prog = _executor.Program(
                "prefill_step", key,
                _kernels.build_prefill_fn(
                    self.model, self._params, self.block_size,
                    self.num_blocks, self.window),
                donate_argnums=(0,))
        return self._prefill_prog, self._decode_prog

    def _spec_programs(self):
        if self._spec_prog is None:
            key = (self._token, self._phase, self.block_size,
                   self._dtype_name, self._d_dtype_name, self.spec_k)
            self._draft_prefill_prog = _executor.Program(
                "draft_prefill_step", key,
                _kernels.build_prefill_fn(
                    self.draft, self._d_params, self.block_size,
                    self.num_blocks, None),
                donate_argnums=(0,))
            self._spec_prog = _executor.Program(
                "spec_verify_step", key,
                _kernels.build_spec_verify_fn(
                    self.model, self._params, self.draft,
                    self._d_params, self.block_size, self.num_blocks,
                    self.spec_k),
                donate_argnums=(0, 1))
        return self._draft_prefill_prog, self._spec_prog

    def _copy_program(self):
        if self._copy_prog is None:
            key = (self._token, self._phase, self.block_size,
                   self._dtype_name)
            self._copy_prog = _executor.Program(
                "block_copy", key, _kernels.build_block_copy_fn(),
                donate_argnums=(0,))
        return self._copy_prog

    def _submit(self, program, args):
        return _executor.executor.submit(program, args,
                                         step=next(self._dispatch_no))

    def _ints(self, *arrays):
        """Host integer arrays as int64 tensors on the engine's device,
        through one host-to-device copy (from pinned memory on the card,
        queued behind the work already in the stream)."""
        parts = [np.asarray(a, np.int64) for a in arrays]
        flat = torch.from_numpy(
            np.concatenate([p.reshape(-1) for p in parts]))
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        out, i = [], 0
        for p in parts:
            out.append(flat[i:i + p.size].view(p.shape))
            i += p.size
        return out

    def _padded_table(self, table):
        nb = bucket(len(table))
        return [table + [0] * (nb - len(table))]

    # -- prefix cache ------------------------------------------------------

    def _cache_tag(self, epoch=None) -> str:
        """The chain-key compatibility stamp: everything a committed
        block's bytes depend on besides its token chain.  dtype and block
        size fix the stored layout, the window changes every KV row's
        upstream hidden states, and the target weight epoch makes
        ``publish_weights`` an automatic whole-cache invalidation."""
        if epoch is None:
            epoch = self.weight_epochs["target"]
        return (f"{self._dtype_name}:b{self.block_size}:"
                f"w{self.window}:e{int(epoch)}")

    def _fork(self, src, dst) -> None:
        """One block-copy dispatch: block ``src``'s bytes into ``dst``."""
        self._submit(self._copy_program(), (self.pool, *self._ints(src,
                                                                   dst)))

    def _dispatch_cow(self, s: Session) -> None:
        """Materialize admission's copy-on-write forks: one block-copy
        dispatch per fork, then release the shared source's reference
        (scheduler.complete_cow); the source stayed referenced so the
        stream copies its bytes before any eviction could recycle it."""
        if not s.cow_pending:
            return
        for _idx, fsrc, fdst in s.cow_pending:
            self._fork(fsrc, fdst)
        n = self.scheduler.complete_cow(s)
        self._cow_forks += n
        _obs.counter("serve.prefix.cow_forks").inc(n)

    def _note_commit(self, s: Session) -> None:
        """Chain-commit the session's newly full blocks, unless its KV
        was written under an older target epoch (hashing mixed-weight
        blocks would poison the index)."""
        if s.weight_epoch == self.weight_epochs["target"]:
            self.scheduler.note_commit(s)

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        self.scheduler.submit(request)
        sess = self.scheduler.queue[-1]
        sess.t_queued = time.monotonic()
        _obs.event("serve.request", rid=request.rid, phase="queued",
                   tick=self._tick, prompt_len=len(request.prompt),
                   max_new=request.max_new_tokens)

    def submit_recompute(self, request: Request, out) -> None:
        """Queue a request that already generated ``out`` tokens on
        another engine: admission re-prefills ``prompt + out[:-1]`` in
        recompute mode, so the continuation is the uninterrupted one."""
        self.scheduler.submit_recompute(request, out)
        sess = self.scheduler.queue[-1]
        sess.t_queued = time.monotonic()
        _obs.event("serve.request", rid=request.rid, phase="requeued",
                   tick=self._tick, generated=len(sess.out))

    def evict_session(self, s: Session) -> Session:
        """Shed a live session: free its blocks (both tables) and hand it
        back in recompute mode for the caller to re-home on another
        engine.  Local preemption stays ``preempt_for``."""
        self.scheduler.evict(s)
        _obs.event("serve.request", rid=s.rid, phase="shed",
                   tick=self._tick, generated=len(s.out))
        return s

    # -- weight hot-swap ---------------------------------------------------

    def publish_weights(self, leaves, *, which: str = "target",
                        epoch: Optional[int] = None) -> int:
        """Swap the ``which`` model's parameter values between ticks.

        The values are copied INTO the existing parameter tensors: the
        programs (and the CUDA graphs captured from them) read the
        parameters where they lie, so the next dispatch computes with the
        new weights and nothing is captured again.  Shapes and dtypes must
        match the current values exactly.  A leaf that is its parameter's
        own memory is in place already (the rollout publisher's: its
        ``weight_publish`` dispatch copied the masters into the
        parameters), so then only the epoch is stamped and the prefix
        cache flushed.  Buffers are not swapped.

        Live sessions keep their KV cache: rows written under the old
        weights stay, so a mid-generation swap continues under mixed
        weights; each request is attributed to the epoch it was ADMITTED
        under.  ``epoch`` pins the recorded epoch; default bumps the
        counter by one.  Returns the epoch now being served."""
        if which not in ("target", "draft"):
            raise ValueError(f"which must be 'target' or 'draft', "
                             f"got {which!r}")
        if which == "draft":
            if not self.spec:
                raise RuntimeError(
                    "publish_weights(which='draft') on a non-speculative "
                    "engine — no draft to publish into")
            params = list(self.draft.parameters())
        else:
            params = list(self.model.parameters())
        leaves = [torch.as_tensor(v) for v in leaves]
        if len(leaves) != len(params):
            raise ValueError(
                f"publish_weights({which!r}): {len(leaves)} leaves for "
                f"{len(params)} parameters — different model config")
        for i, (p, v) in enumerate(zip(params, leaves)):
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(
                    f"publish_weights({which!r}): leaf {i} shape "
                    f"{tuple(v.shape)} != serving shape {tuple(p.shape)}")
            if v.dtype != p.dtype:
                raise ValueError(
                    f"publish_weights({which!r}): leaf {i} dtype "
                    f"{v.dtype} != serving dtype {p.dtype} — cast on the "
                    f"publish side")
        with torch.no_grad():
            for p, v in zip(params, leaves):
                if v.device != p.device or v.data_ptr() != p.data_ptr():
                    p.copy_(v)
        ep = self.weight_epochs[which] + 1 if epoch is None else int(epoch)
        self.weight_epochs[which] = ep
        if which == "target":
            # invalidate the prefix cache: the new epoch lands in the
            # chain tag and cached-tier blocks holding stale KV go back to
            # the free list
            self.scheduler.cache_tag = self._cache_tag()
            self.block_pool.flush_cache()
        _obs.event("serve.weight_swap", which=which, epoch=ep,
                   tick=self._tick, leaves=len(leaves))
        return ep

    # -- the tick ----------------------------------------------------------

    def step(self) -> bool:
        """One engine tick: admit, one prefill (or draft catch-up) chunk,
        one decode/speculative tick.  Returns True while any request is
        live or queued.

        A ``phase="prefill"`` engine stops after the prefill stage:
        sessions that complete prefill wait in DECODE state for the
        disaggregation coordinator to stream their KV blocks out.  A
        ``phase="decode"`` engine runs the full tick (its prefill stage
        serves recompute-mode re-admissions after local preemption)."""
        self._tick += 1
        t0 = time.monotonic()
        for s in self.scheduler.admit():
            s.weight_epoch = self.weight_epochs["target"]
            self._dispatch_cow(s)
            self._prefill_tokens_saved += s.prefix_hit_tokens
            self._prefix_prompt_tokens += len(s.prefill_src)
            if s.prefix_hit_tokens:
                _obs.counter("serve.prefix.tokens_saved").inc(
                    s.prefix_hit_tokens)
            if self._prefix_prompt_tokens:
                _obs.gauge("serve.prefix.hit_rate").set(
                    self._prefill_tokens_saved
                    / self._prefix_prompt_tokens)
            _obs.event("serve.request", rid=s.rid, phase="prefill",
                       tick=self._tick, blocks=len(s.table),
                       prefix_hit=s.prefix_hit_tokens,
                       weight_epoch=s.weight_epoch)
        ps = self.scheduler.next_prefill()
        if ps is not None:
            self._prefill_chunk(ps)
        elif self.spec:
            cs = self._next_draft_catchup()
            if cs is not None:
                self._draft_catchup_chunk(cs)
        if self._phase == "prefill":
            _obs.gauge("serve.queue_depth").set(
                len(self.scheduler.queue))
            _obs.gauge("serve.active_sessions").set(
                len(self.scheduler.sessions))
            return self.scheduler.has_work()
        self._ensure_decode_blocks()
        ds = self._decode_ready()
        if ds:
            if self.spec and self._spec_pays(ds):
                self._spec_tick(ds)
            else:
                self._decode_tick(ds)
            _obs.histogram("serve.decode_tick_ms").observe(
                (time.monotonic() - t0) * 1e3)
        _obs.gauge("serve.queue_depth").set(len(self.scheduler.queue))
        _obs.gauge("serve.active_sessions").set(
            len(self.scheduler.sessions))
        return self.scheduler.has_work()

    def run(self, requests: Sequence[Request], arrivals=None,
            watchdog_deadline_s=None, max_ticks=None):
        """Serve ``requests`` to completion; returns ``{rid: tokens}``.

        ``arrivals``: optional per-request tick indices (an open-loop
        trace: request i becomes visible at tick ``arrivals[i]``); None
        submits everything up front.  ``watchdog_deadline_s`` arms a stall
        watchdog over the loop: every dispatch heartbeats, so a card that
        stops fires ``watchdog.stall`` instead of hanging unseen."""
        return run_trace(self, requests, arrivals, max_ticks,
                         watchdog_deadline_s)

    # -- internals ---------------------------------------------------------

    def _prefill_chunk(self, s: Session) -> None:
        prefill_prog, _ = self._programs()
        chunk = self.scheduler.prefill_chunk
        n = min(chunk, s.prefill_remaining)
        t0 = s.position
        toks = list(s.prefill_src[t0:t0 + n]) + [0] * (chunk - n)
        last = self._submit(prefill_prog, (
            self.pool, *self._ints([toks], self._padded_table(s.table),
                                   t0, n)))
        if self.spec and s.draft_position == t0:
            # lockstep draft ingest: the draft's cache tracks the target's
            # row for row through prefill (and recompute re-prefill), so a
            # fresh session is spec-ready the tick its prefill completes.
            # A prefix-hit session starts its target cursor PAST rows the
            # draft never saw: it repairs through the catch-up path.
            draft_prog, _ = self._spec_programs()
            self._submit(draft_prog, (
                self.dpool, *self._ints(
                    [toks], self._padded_table(s.draft_table), t0, n)))
            s.draft_position = t0 + n
        s.position = t0 + n
        if self.window is not None:
            self.scheduler.retire_window_blocks(s, self.window)
        self._note_commit(s)
        if s.prefill_remaining > 0:
            return
        s.state = DECODE
        if s.emit_on_prefill:
            tok = int(torch.argmax(last[0]))
            s.out.append(tok)
            s.pending_tok = tok
            s.t_first = time.monotonic()
            _obs.histogram("serve.ttft_ms").observe(
                (s.t_first - s.t_queued) * 1e3)
            _obs.event("serve.request", rid=s.rid, phase="first_token",
                       tick=self._tick)
            if s.finished():
                self._finish(s)

    def _next_draft_catchup(self) -> Optional[Session]:
        """Oldest decoding session whose draft cache lags its target
        cache: only handed-off sessions (or plain-decode fallback ticks)
        create the lag; one catch-up chunk per tick repairs it in the
        prefill slot."""
        for s in self.scheduler.sessions:
            if s.state == DECODE and s.draft_position < s.position:
                return s
        return None

    def _draft_catchup_chunk(self, s: Session) -> None:
        draft_prog, _ = self._spec_programs()
        chunk = self.scheduler.prefill_chunk
        fed = s.fed_tokens
        d0 = s.draft_position
        n = min(chunk, s.position - d0)
        toks = list(fed[d0:d0 + n]) + [0] * (chunk - n)
        self._submit(draft_prog, (
            self.dpool, *self._ints([toks],
                                    self._padded_table(s.draft_table),
                                    d0, n)))
        s.draft_position = d0 + n

    def _decode_ready(self) -> List[Session]:
        """Sessions eligible for this tick's decode dispatch: every DECODE
        session, minus (spec mode) those whose draft cache is still
        catching up."""
        ds = self.scheduler.decode_sessions()
        if not self.spec:
            return ds
        return [s for s in ds if s.draft_position == s.position]

    def _spec_pays(self, sessions: List[Session]) -> bool:
        """``spec_policy="on"`` always speculates; ``"auto"`` asks the
        dispatch ledger (:func:`~apex_tpu_torch.kernels.spec_verify.
        spec_verify_pays`, ``decide()`` cached per bucket shape) whether
        this card's measured verify win covers this shape; below it the
        engine runs plain decode ticks and the catch-up path keeps the
        draft cache consistent."""
        if self._spec_policy == "on":
            return True
        b = bucket(len(sessions), self.scheduler.max_batch)
        nbt = bucket(max(len(s.table) for s in sessions))
        nbd = bucket(max(len(s.draft_table) for s in sessions))
        return spec_verify_pays(spec_verify_fp(
            b=b, k=self.spec_k, s_t=nbt * self.block_size,
            s_d=nbd * self.block_size, dtype=self._dtype_name), self.device)

    def _ensure_decode_blocks(self) -> None:
        """Every decoding session needs its table to cover the rows this
        tick writes (one row for plain decode, ``spec_k + 1`` rows across
        BOTH tables for a speculative tick); a dry pool preempts the
        newest session (recompute mode) until the survivors fit."""
        slack = self.spec_k if self.spec else 0
        for s in list(self.scheduler.decode_sessions()):
            if s.state != DECODE:
                continue                     # preempted below us
            if self.spec and s.draft_position < s.position:
                continue                     # catch-up session: no tick
            need = s.position + 1 + slack
            while not (self.scheduler.grow(s, need)
                       and (not self.spec
                            or self.scheduler.grow(s, need,
                                                   draft=True))):
                victim = self.scheduler.preempt_for(s)
                _obs.counter("serve.preemptions").inc()
                _obs.event("serve.request", rid=victim.rid,
                           phase="preempted", tick=self._tick,
                           generated=len(victim.out))
                if victim is s:
                    break

    def _decode_tick(self, sessions: List[Session]) -> None:
        _, decode_prog = self._programs()
        _b, _nb, tokens, positions, tables = \
            self.scheduler.pack_decode(sessions)
        nxt, _logits = self._submit(decode_prog, (
            self.pool, *self._ints(tokens, positions, tables)))
        nxt = nxt.tolist()
        for i, s in enumerate(sessions):
            s.position += 1
            tok = nxt[i]
            s.out.append(tok)
            s.pending_tok = tok
            if self.window is not None:
                self.scheduler.retire_window_blocks(s, self.window)
            self._note_commit(s)
            if s.finished():
                self._finish(s)

    def _spec_tick(self, sessions: List[Session]) -> None:
        """One batched speculative tick: a single ``spec_verify_step``
        dispatch drafts ``spec_k`` proposals and verifies them with one
        (k+1)-wide target pass; the host commits the accepted prefix per
        row.  Row i's emitted tokens are the TARGET's argmax at positions
        p..p+k on its own committed prefix, and ``n_acc`` only truncates
        that stream where the draft diverged, so the committed tokens are
        the plain-decode tokens whatever the acceptance pattern."""
        _, spec_prog = self._spec_programs()
        _b, _nbt, _nbd, tokens, positions, t_tables, d_tables = \
            self.scheduler.pack_spec(sessions)
        emitted, n_acc = self._submit(spec_prog, (
            self.pool, self.dpool,
            *self._ints(tokens, positions, t_tables, d_tables)))
        emitted = emitted.tolist()
        n_acc = n_acc.tolist()
        committed_total = 0
        for i, s in enumerate(sessions):
            m = 0
            for j in range(n_acc[i]):
                tok = emitted[i][j]
                s.out.append(tok)
                s.pending_tok = tok
                s.position += 1
                m += 1
                if s.finished():
                    break
            # rows p..p+m-1 of the draft cache hold exactly the committed
            # tokens (the rejected tail past them is rewritten by the next
            # tick's chunk before any mask can read it)
            s.draft_position = s.position
            # chain-commit only blocks the committed position has fully
            # crossed
            self._note_commit(s)
            committed_total += m
            self._spec_offered += self.spec_k
            self._spec_accepted += max(0, m - 1)
            if s.finished():
                self._finish(s)
        self._spec_ticks += 1
        self._spec_committed += committed_total
        _obs.histogram("serve.spec.accepted_tokens").observe(
            committed_total)
        if self._spec_offered:
            _obs.gauge("serve.spec.accept_rate").set(
                self._spec_accepted / self._spec_offered)

    # -- disaggregation handoff --------------------------------------------

    def harvest_ready(self) -> List[Session]:
        """Prefill-phase engines: sessions whose prefill completed (DECODE
        state, first token emitted) and now wait for the coordinator to
        stream their KV blocks to a decode engine."""
        return [s for s in self.scheduler.decode_sessions()
                if not s.finished()]

    def release_handoff(self, s: Session) -> None:
        """Drop a session whose KV blocks were streamed out: frees its
        blocks and batch slot without recording a result; the decode
        engine owns the request from here."""
        self.scheduler.finish(s)

    def ingest_handoff(self, request: Request, *, out, pending_tok,
                       position, handoff_dir, t_queued=0.0,
                       t_first=None, n_blocks=None, hash_chain=None,
                       weight_epoch=None) -> Optional[Session]:
        """Decode-phase engines: adopt a prefilled session whose KV blocks
        were streamed into ``handoff_dir`` (schema-3 block files,
        :func:`apex_tpu_torch.runtime.resilience.stream_kv_handoff`, or
        the JAX package's).  Allocates a fresh target table and copies the
        streamed blocks into this engine's pool verbatim (no recompute); in
        spec mode a draft table of the same size is allocated but the
        draft cache starts EMPTY and catches up through the prefill slot.
        ``n_blocks`` is the streamed block count when the source table had
        grown past the admission grant; None means the disaggregation
        default, ``blocks_for(prompt + 1)``.  Returns the new session, or
        None when a batch slot / blocks are not available right now (the
        coordinator retries next tick)."""
        from ..runtime.resilience import load_kv_handoff
        need_pos = len(request.prompt) + request.max_new_tokens \
            + self.scheduler.pos_slack
        if need_pos > self.scheduler.max_positions:
            raise ValueError(
                f"request {request.rid}: {need_pos} positions exceed "
                f"decode engine max_positions "
                f"{self.scheduler.max_positions}")
        if len(self.scheduler.sessions) >= self.scheduler.max_batch:
            return None
        if n_blocks is None:
            # a prefill-phase engine never decodes, so its table is
            # exactly its admission grant
            n_blocks = blocks_for(len(request.prompt) + 1,
                                  self.block_size)
        have = int(n_blocks)
        ids = self.block_pool.alloc(have)
        if ids is None:
            return None
        draft_ids: List[int] = []
        if self.spec:
            draft_ids = self.block_pool.alloc(have)
            if draft_ids is None:
                self.block_pool.free(ids)
                return None
        try:
            load_kv_handoff(handoff_dir, self.pool, ids)
        except Exception:
            self.block_pool.free(ids)
            if draft_ids:
                self.block_pool.free(draft_ids)
            raise
        s = Session(request, self.scheduler._seq)
        self.scheduler._seq += 1
        s.table = ids
        s.draft_table = draft_ids
        s.position = int(position)
        s.draft_position = 0
        s.state = DECODE
        s.prefill_src = ()
        s.emit_on_prefill = False
        s.pending_tok = int(pending_tok)
        s.out = list(out)
        s.t_queued = t_queued
        s.t_first = t_first
        s.weight_epoch = self.weight_epochs["target"]
        if hash_chain and self.scheduler.prefix_cache \
                and weight_epoch == self.weight_epochs["target"]:
            # re-link the migrated chain into THIS pool's index: the
            # streamed blocks are copies of committed-prefix blocks
            s.hash_chain = list(hash_chain)
            s.committed_blocks = len(s.hash_chain)
            for bid, key in zip(ids, s.hash_chain):
                self.block_pool.commit(bid, key)
        elif hash_chain:
            # a chain built under another weight epoch: the KV stays valid
            # for THIS session but is never published for reuse
            s.cacheable = False
        self.scheduler.sessions.append(s)
        _obs.event("serve.request", rid=s.rid, phase="ingested",
                   tick=self._tick, blocks=have,
                   generated=len(s.out))
        return s

    def _finish(self, s: Session) -> None:
        self.results[s.rid] = list(s.out)
        self.result_meta[s.rid] = {"weight_epoch": s.weight_epoch,
                                   "prompt_len": len(s.request.prompt)}
        s.t_done = time.monotonic()
        _obs.histogram("serve.e2e_ms").observe(
            (s.t_done - s.t_queued) * 1e3)
        _obs.event("serve.request", rid=s.rid, phase="done",
                   tick=self._tick, generated=len(s.out),
                   weight_epoch=s.weight_epoch)
        self.scheduler.finish(s)

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        """Tear the engine down: return every live session's blocks
        (target AND draft tables) to the :class:`BlockPool`, drop the
        queue, and assert the pool is leak-free.  Idempotent; no result
        is recorded for the sessions it drops."""
        for s in list(self.scheduler.sessions):
            self.scheduler.finish(s)
        self.scheduler.queue.clear()
        self.block_pool.check_no_leaks()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- introspection -----------------------------------------------------

    @property
    def tick(self) -> int:
        """Ticks executed so far: the loop's logical clock (open-loop
        arrival traces index into it)."""
        return self._tick

    def programs(self) -> dict:
        """The programs built so far, by kind (their entries hold the
        captured graphs: ``runtime.executor.graph_stats``)."""
        progs = {"decode_step": self._decode_prog,
                 "prefill_step": self._prefill_prog,
                 "block_copy": self._copy_prog,
                 "draft_prefill_step": self._draft_prefill_prog,
                 "spec_verify_step": self._spec_prog}
        return {k: p for k, p in progs.items() if p is not None}

    def metrics(self) -> dict:
        """SLO snapshot: compile/dispatch counters per serve kind plus the
        engine's own gauges/histograms."""
        from ..runtime import step_cache as _sc
        snap = _obs.get_registry().snapshot()
        out = {
            "decode": _sc.kind_stats("decode_step"),
            "prefill": _sc.kind_stats("prefill_step"),
            "pool_occupancy": self.block_pool.occupancy,
            "queue_depth": len(self.scheduler.queue),
            "prefix_cache": {
                "hit_rate": (self._prefill_tokens_saved
                             / self._prefix_prompt_tokens
                             if self._prefix_prompt_tokens else 0.0),
                "prefill_tokens_saved": self._prefill_tokens_saved,
                "cached_blocks": self.block_pool.cached_count,
                "cow_forks": self._cow_forks,
                "cache_evictions": self.block_pool.cache_evictions,
            },
            "histograms": {k: v for k, v in snap["histograms"].items()
                           if k.startswith("serve.")},
        }
        if self.spec:
            out["spec_verify"] = _sc.kind_stats("spec_verify_step")
            out["draft_prefill"] = _sc.kind_stats("draft_prefill_step")
            out["spec"] = {
                "ticks": self._spec_ticks,
                "committed_tokens": self._spec_committed,
                "offered": self._spec_offered,
                "accepted": self._spec_accepted,
                "accept_rate": (self._spec_accepted / self._spec_offered
                                if self._spec_offered else 0.0),
                "tokens_per_tick": (self._spec_committed
                                    / self._spec_ticks
                                    if self._spec_ticks else 0.0),
            }
        return out


def run_trace(engine, requests, arrivals=None, max_ticks=None,
              watchdog_deadline_s=None):
    """The open-loop serve loop of :meth:`ServeEngine.run` and
    ``DisaggregatedEngine.run``: request i is submitted once the engine's
    tick reaches ``arrivals[i]`` (all at tick 0 when None), and the engine
    steps until it is drained (or ``max_ticks``), under a
    :class:`~apex_tpu_torch.observe.watchdog.StallWatchdog` of
    ``watchdog_deadline_s`` when one is given.  Returns
    ``{rid: tokens}``."""
    pending = sorted(
        zip(arrivals if arrivals is not None else [0] * len(requests),
            range(len(requests))),
        key=lambda p: (p[0], p[1]))
    wd = _watchdog.StallWatchdog(watchdog_deadline_s) \
        if watchdog_deadline_s else None
    if wd is not None:
        wd.start()
    try:
        i = 0
        while True:
            while i < len(pending) and pending[i][0] <= engine.tick:
                engine.submit(requests[pending[i][1]])
                i += 1
            more = engine.step()
            if not more and i >= len(pending):
                break
            if max_ticks is not None and engine.tick >= max_ticks:
                break
    finally:
        if wd is not None:
            wd.stop()
    return dict(engine.results)
