"""Continuous-batching scheduler: requests -> per-tick packed batches,
the PyTorch port's copy of ``apex_tpu/serve/scheduler.py`` (host code
over integers, the same decisions).

Static-batch serving admits N requests, runs them in lockstep, and
returns when the LAST one finishes — short requests pay the longest
request's latency and the batch slots they vacate idle.  Continuous
batching (Orca's iteration-level scheduling, vLLM's default) re-packs
the live set every tick: a session that finishes frees its batch slot
and its KV blocks *this* tick, and a queued request can take them the
next.  This module is the host-side half of that loop — pure Python
over integers, deterministic for a given request/arrival stream (the
packing-determinism test replays a seeded Poisson trace twice and
diffs the decisions).

Three policies live here, and only here (the device programs in
serve/kernels.py are policy-free):

* **admission** — FIFO, gated on three budgets: batch slots
  (``max_batch``), KV blocks (the prompt plus one decode block of
  headroom must fit the pool *whole* — half-admitted sessions would
  deadlock), and prefill backlog (``max_prefill_backlog`` tokens not
  yet ingested across admitted sessions — the queue-depth/token-budget
  backpressure that keeps time-to-first-token bounded under load:
  admitting a 30th long prompt helps nobody's SLO).
* **packing** — every decode tick takes ALL decoding sessions (in
  admission order), padded to the next batch bucket; block tables pad
  to the next block bucket.  Buckets are powers of two, so the set of
  decode program shapes is ``O(log(max_batch) · log(max_blocks))``:
  on the card one CUDA graph a shape, none captured after warm-up.
* **preemption** — when a decode tick needs a block and the pool is
  dry, the LAST-admitted session is evicted (LIFO victim: it has the
  least sunk prefill work and FIFO fairness protects the oldest),
  its blocks freed, and it re-queues at the queue's FRONT in recompute
  mode: on re-admission it re-prefills prompt + tokens generated so
  far, then continues decoding — greedy decode makes the recomputed
  continuation identical to the one the eviction interrupted.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .pool import BlockPool, NULL_BLOCK, blocks_for, chain_key, chain_keys

QUEUED, PREFILL, DECODE, DONE = "queued", "prefill", "decode", "done"


def bucket(n: int, cap: Optional[int] = None) -> int:
    """Next power of two >= n (>= 1); ``cap`` bounds it (a request that
    legitimately needs more than cap is the caller's validation bug)."""
    b = 1
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


#: admission classes the elastic fleet routes/sheds by — "latency"
#: sessions migrate on capacity loss, "batch" sessions are re-queued
SLO_CLASSES = ("latency", "batch")


@dataclass
class Request:
    """One serving request: ``prompt`` token ids, up to
    ``max_new_tokens`` generated (greedy), optional ``eos`` stop id
    (emitted, then the session finishes).  ``slo`` is the request's
    service class (:data:`SLO_CLASSES`) — a single engine ignores it;
    the elastic fleet (``serve.elastic``) migrates latency-tier sessions
    on a shrink and sheds batch-tier ones first (re-queued, not
    dropped)."""
    rid: str
    prompt: Tuple[int, ...]
    max_new_tokens: int
    eos: Optional[int] = None
    slo: str = "latency"

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}")
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"request {self.rid}: slo must be one of {SLO_CLASSES}, "
                f"got {self.slo!r}")


@dataclass
class Session:
    """Scheduler-side state of one admitted request.  The KV state a
    session owns is exactly ``table`` (physical block ids) plus
    ``position`` (KV rows written) — no private cache buffer; the pool
    holds the bytes."""
    request: Request
    seq: int                               # admission order (preemption)
    table: List[int] = field(default_factory=list)
    position: int = 0                      # KV rows written so far
    state: str = PREFILL
    prefill_src: Tuple[int, ...] = ()      # tokens still to ingest
    emit_on_prefill: bool = True           # fresh: 1st token from logits
    pending_tok: Optional[int] = None      # next token to ingest
    out: List[int] = field(default_factory=list)
    # speculative mode only: the draft model's own block table over the
    # SAME BlockPool free-list, and how many draft KV rows are written
    # (lags `position` when a handed-off session's draft cache is still
    # catching up on the prompt; equal once spec ticks may include it)
    draft_table: List[int] = field(default_factory=list)
    draft_position: int = 0
    # target weight epoch the session was admitted under (engine-stamped
    # at admission; epochs only grow, so this is the OLDEST weights any
    # of its tokens saw — the conservative age a staleness bound wants).
    # -1 until admission on an engine that publishes weights.
    weight_epoch: int = -1
    # lifecycle timestamps (engine-stamped, telemetry only — no
    # scheduling decision reads them, so packing stays deterministic)
    t_queued: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    # -- prefix cache state (tentpole: content-addressed block reuse) --
    # rolling chain keys of the session's committed full blocks, one
    # per table entry < committed_blocks (adopted keys included)
    hash_chain: List[str] = field(default_factory=list)
    committed_blocks: int = 0
    # False when the session's KV provenance is mixed (e.g. adopted
    # under a different weight epoch) — its blocks must never enter
    # the hash index
    cacheable: bool = True
    # copy-on-write forks decided at admission: (table index, shared
    # source id, exclusive destination id).  The engine dispatches the
    # paged block-copy for each, then complete_cow() releases the
    # source reference — the source stays referenced until the copy is
    # in the dispatch stream, so eviction cannot recycle it first.
    cow_pending: List[Tuple[int, int, int]] = field(default_factory=list)
    # tokens of this request's prompt that admission found cached (the
    # rows prefill will NOT recompute) — telemetry for hit-rate
    prefix_hit_tokens: int = 0

    @property
    def rid(self) -> str:
        return self.request.rid

    @property
    def prefill_remaining(self) -> int:
        return len(self.prefill_src) - self.position

    @property
    def fed_tokens(self) -> Tuple[int, ...]:
        """Every token whose target KV row is committed: the prompt
        plus all output except the last (still pending ingest) —
        exactly the recompute-mode prefill source, and the draft
        catch-up source for handed-off speculative sessions."""
        if self.out:
            return self.request.prompt + tuple(self.out[:-1])
        return self.request.prompt

    def finished(self) -> bool:
        r = self.request
        return len(self.out) >= r.max_new_tokens or \
            (r.eos is not None and self.out and self.out[-1] == r.eos)


class Scheduler:
    """The per-tick policy engine.  Owns the request queue and the live
    session set; the serve engine calls, in tick order: ``admit()``,
    ``next_prefill()``, ``decode_sessions()`` (+ ``grow()`` /
    ``preempt_for()`` when blocks run out), and ``finish()``."""

    def __init__(self, pool: BlockPool, *, max_batch: int,
                 prefill_chunk: int, max_prefill_backlog: int,
                 max_positions: int, spec_tables: bool = False,
                 pos_slack: int = 0, prefix_cache: bool = True,
                 cache_tag: str = "kv"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.pool = pool
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.max_prefill_backlog = max_prefill_backlog
        self.max_positions = max_positions
        # prefix cache: admission walks each request's token chain
        # through the pool's hash index and prefills only the cold
        # suffix.  cache_tag stamps the chain keys with everything KV
        # bytes depend on besides tokens (dtype/block size/window/
        # weight epoch) — the engine owns it and re-tags on publish.
        self.prefix_cache = bool(prefix_cache)
        self.cache_tag = cache_tag
        # speculative mode: every session also owns a draft block table
        # (admission doubles its block ask, finish/preempt free both),
        # and each tick may write up to `pos_slack` rows PAST the last
        # committed position (the verify chunk's rejected tail), so
        # admission budgets that headroom out of max_positions up front
        self.spec_tables = spec_tables
        self.pos_slack = int(pos_slack)
        self.queue: deque = deque()
        self.sessions: List[Session] = []      # admission order
        self._seq = 0
        self.rejected: List[str] = []

    # -- intake ------------------------------------------------------------

    def _reject_never_fit(self, request: Request) -> None:
        need = len(request.prompt) + request.max_new_tokens \
            + self.pos_slack
        blocks_need = blocks_for(need, self.pool.block_size)
        if self.spec_tables:
            blocks_need *= 2               # target + draft tables
        cap_blocks = self.pool.capacity
        if need > self.max_positions or blocks_need > cap_blocks:
            self.rejected.append(request.rid)
            raise ValueError(
                f"request {request.rid}: {need} positions exceed "
                f"max_positions {self.max_positions} / pool capacity "
                f"{cap_blocks * self.pool.block_size}")

    def submit(self, request: Request) -> None:
        """Queue a request (FIFO).  Requests that can NEVER fit — more
        positions than the model or the whole pool can hold — are
        rejected now, loudly, instead of deadlocking the queue head."""
        self._reject_never_fit(request)
        self.queue.append(Session(request, -1))

    def submit_recompute(self, request: Request, out) -> None:
        """Queue a request whose first ``len(out)`` tokens were already
        generated on ANOTHER engine (a session shed or lost during a
        fleet shrink, re-homed here).  Admission treats it exactly like
        a locally preempted session: re-prefill ``prompt + out[:-1]``
        with ``out[-1]`` pending — greedy decode makes the continuation
        bitwise the one the shrink interrupted (the preemption pin)."""
        self._reject_never_fit(request)
        s = Session(request, -1)
        s.state = QUEUED
        out = [int(t) for t in out]
        if out:
            s.out = out
            s.prefill_src = request.prompt + tuple(out[:-1])
            s.emit_on_prefill = False
            s.pending_tok = out[-1]
        else:
            s.prefill_src = request.prompt
        self.queue.append(s)

    def _backlog_tokens(self) -> int:
        return sum(s.prefill_remaining for s in self.sessions
                   if s.state == PREFILL)

    def admit(self) -> List[Session]:
        """Move queue-head sessions into the live set while every budget
        (batch slots, cold-suffix blocks + headroom, prefill backlog)
        holds.  All-or-nothing per session; FIFO order preserved.

        Prefix cache: each request's token chain is walked through the
        pool's hash index first (:meth:`BlockPool.acquire_prefix`) —
        matched full blocks are adopted shared (refcounted, immutable)
        and the session's ``position`` starts past them, so the engine
        prefills only the uncached suffix and the backlog budget counts
        only suffix tokens.  A FULL-chain hit still re-ingests the last
        prompt token (first-token logits must come from somewhere), and
        that write lands inside the last shared block — so admission
        forks it copy-on-write: a fresh block joins the table, the
        shared original stays referenced in ``cow_pending`` until the
        engine dispatches the paged block-copy.  Recompute re-admission
        (preempted or shed sessions) takes the same path and typically
        re-acquires its own just-retired blocks from the cached tier —
        preemption recovery without re-prefill."""
        admitted = []
        while self.queue:
            s = self.queue[0]
            if len(self.sessions) >= self.max_batch:
                break
            # fresh sessions ingest the prompt; preempted ones carry
            # their recompute source from preempt_for
            src = s.prefill_src if s.pending_tok is not None \
                else s.request.prompt
            bs = self.pool.block_size
            need_total = blocks_for(len(src) + 1, bs)
            shared: List[int] = []
            keys: List[str] = []
            if self.prefix_cache:
                keys = chain_keys(src, bs, self.cache_tag)
                shared = self.pool.acquire_prefix(keys)
            hit = len(shared) * bs
            fork = False
            if hit >= len(src):
                # full-chain hit (len(src) is block-aligned and every
                # block matched)
                if s.pending_tok is not None:
                    pos0 = len(src)      # recompute source fully cached
                else:
                    pos0 = len(src) - 1  # re-ingest one token -> logits
                    fork = True
            else:
                pos0 = hit
            if self._backlog_tokens() + (len(src) - pos0) \
                    > self.max_prefill_backlog and self.sessions:
                self.pool.free(shared)
                break
            cold = need_total - len(shared) + (1 if fork else 0)
            ids = self.pool.alloc(cold)
            if ids is None:
                self.pool.free(shared)
                break
            draft_ids: List[int] = []
            if self.spec_tables:
                # all-or-nothing across BOTH tables: a session holding
                # a target table but no draft table would deadlock the
                # spec tick exactly like a half-admitted prompt.  The
                # draft cache is never content-addressed (draft-model
                # KV lives under different weights) — always cold.
                draft_ids = self.pool.alloc(need_total)
                if draft_ids is None:
                    self.pool.free(ids)
                    self.pool.free(shared)
                    break
            self.queue.popleft()
            s.seq = self._seq
            self._seq += 1
            if fork:
                fsrc, fdst = shared[-1], ids[0]
                s.table = shared[:-1] + [fdst] + ids[1:]
                s.cow_pending = [(len(shared) - 1, fsrc, fdst)]
            else:
                s.table = shared + ids
                s.cow_pending = []
            s.draft_table = draft_ids
            s.position = pos0
            s.draft_position = 0
            s.prefill_src = src
            s.hash_chain = keys[:len(shared)]
            s.committed_blocks = len(shared)
            s.prefix_hit_tokens = pos0
            s.cacheable = True
            # a fully cached recompute source needs no prefill at all —
            # the pending token ingests through the next decode tick
            s.state = DECODE if pos0 >= len(src) else PREFILL
            self.sessions.append(s)
            admitted.append(s)
        return admitted

    def complete_cow(self, s: Session) -> int:
        """Release the shared source of every pending copy-on-write
        fork — the engine calls this AFTER dispatching the block-copy
        program(s), so the source's bytes cannot be recycled before the
        copy is in the dispatch stream.  Host-only harnesses (the churn
        sim) call it right after admit.  Returns the fork count."""
        n = len(s.cow_pending)
        for _idx, fsrc, _fdst in s.cow_pending:
            self.pool.free([fsrc])
        s.cow_pending = []
        return n

    def note_commit(self, s: Session) -> int:
        """Commit every newly FULL block of ``s`` into the pool's hash
        index: extend the session's rolling chain over its fed tokens
        and register each block (first writer wins — a chain another
        session committed already just leaves ours unhashed).  Called
        by the engine after every position advance; returns the number
        of blocks newly chained."""
        if not self.prefix_cache or not s.cacheable:
            return 0
        bs = self.pool.block_size
        toks = s.fed_tokens
        full = min(s.position // bs, len(s.table), len(toks) // bs)
        n = 0
        while s.committed_blocks < full:
            i = s.committed_blocks
            prev = s.hash_chain[i - 1] if i else ""
            key = chain_key(prev, toks[i * bs:(i + 1) * bs],
                            self.cache_tag)
            s.hash_chain.append(key)
            b = s.table[i]
            if b != NULL_BLOCK and not any(
                    idx == i for idx, _src, _dst in s.cow_pending):
                self.pool.commit(b, key)
            s.committed_blocks = i + 1
            n += 1
        return n

    # -- per-tick views ----------------------------------------------------

    def next_prefill(self) -> Optional[Session]:
        for s in self.sessions:
            if s.state == PREFILL:
                return s
        return None

    def decode_sessions(self) -> List[Session]:
        return [s for s in self.sessions if s.state == DECODE]

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.sessions)

    # -- block growth / preemption ----------------------------------------

    def grow(self, s: Session, n_positions: int,
             draft: bool = False) -> bool:
        """Extend ``s.table`` (or ``s.draft_table``) to cover
        ``n_positions`` KV rows; False if the pool is dry (caller
        preempts and retries)."""
        table = s.draft_table if draft else s.table
        need = blocks_for(n_positions, self.pool.block_size) \
            - len(table)
        if need <= 0:
            return True
        ids = self.pool.alloc(need)
        if ids is None:
            return False
        table.extend(ids)
        return True

    def evict(self, victim: Session) -> Session:
        """Free a live session's blocks (BOTH tables) and detach it
        from the live set in recompute mode, WITHOUT re-queueing it
        locally — local preemption (:meth:`preempt_for`) re-queues at
        the queue front; the elastic fleet instead re-homes the evicted
        session to another engine (its shed path).  Either way the
        recompute re-prefill of ``prompt + out[:-1]`` continues
        bitwise.

        Shared blocks just lose this session's reference; committed
        ones retire to the cached tier, so the re-admission (here or on
        another engine with the same chain) usually re-adopts them —
        eviction stops costing the prefix its prefill."""
        self.complete_cow(victim)
        self.pool.free(b for b in victim.table if b != NULL_BLOCK)
        self.pool.free(b for b in victim.draft_table
                       if b != NULL_BLOCK)
        self.sessions.remove(victim)
        victim.table = []
        victim.draft_table = []
        victim.position = 0
        victim.draft_position = 0
        victim.hash_chain = []
        victim.committed_blocks = 0
        victim.prefix_hit_tokens = 0
        victim.state = QUEUED
        if victim.out:
            # recompute mode: re-prefill prompt + generated-so-far
            # except the last token, which is still waiting to be
            # ingested — it becomes pending again after re-prefill
            victim.prefill_src = victim.request.prompt \
                + tuple(victim.out[:-1])
            victim.emit_on_prefill = False
            victim.pending_tok = victim.out[-1]
        else:
            victim.prefill_src = victim.request.prompt
            victim.emit_on_prefill = True
            victim.pending_tok = None
        return victim

    def preempt_for(self, needy: Session) -> Optional[Session]:
        """Evict the last-admitted live session other than ``needy``
        (or ``needy`` itself if it is alone — it re-queues with its
        progress and re-admits when blocks exist).  Freed state:
        ALL the victim's blocks; the victim re-enters the queue FRONT
        in recompute mode."""
        victims = [s for s in self.sessions if s is not needy]
        victim = max(victims, key=lambda s: s.seq) if victims else needy
        self.evict(victim)
        self.queue.appendleft(victim)
        return victim

    def finish(self, s: Session) -> None:
        self.complete_cow(s)
        self.pool.free(b for b in s.table if b != NULL_BLOCK)
        self.pool.free(b for b in s.draft_table if b != NULL_BLOCK)
        s.table = []
        s.draft_table = []
        s.state = DONE
        self.sessions.remove(s)

    def retire_window_blocks(self, s: Session, window: int) -> int:
        """Free the leading blocks of a sliding-window session that no
        future query's band can reach (rolling.py's closed form,
        block-tabled).  Retired table entries become NULL — logical
        indexing is positional, so the prefix stays, pointing at the
        zero block the band mask already excludes.  Returns the number
        of blocks returned to the pool."""
        from ..inference.rolling import window_retired_blocks
        n = window_retired_blocks(s.position, window,
                                  self.pool.block_size)
        freed = [b for b in s.table[:n] if b != NULL_BLOCK]
        if freed:
            self.pool.free(freed)
            for i in range(n):
                s.table[i] = NULL_BLOCK
        return len(freed)

    # -- packing -----------------------------------------------------------

    def pack_decode(self, sessions: List[Session]):
        """Bucketed operand arrays for one decode tick:
        ``(bucket_batch, bucket_blocks, tokens, positions, tables)``
        as host int lists — dead rows carry ``position = -1`` and
        all-null tables (the kernels' drop encoding)."""
        b = bucket(len(sessions), self.max_batch)
        nb = bucket(max(len(s.table) for s in sessions))
        tokens, positions, tables = [], [], []
        for s in sessions:
            tokens.append(s.pending_tok)
            positions.append(s.position)
            tables.append(s.table + [NULL_BLOCK] * (nb - len(s.table)))
        for _ in range(b - len(sessions)):
            tokens.append(0)
            positions.append(-1)
            tables.append([NULL_BLOCK] * nb)
        return b, nb, tokens, positions, tables

    def pack_spec(self, sessions: List[Session]):
        """Bucketed operands for one speculative tick:
        ``(bucket_batch, bucket_t_blocks, bucket_d_blocks, tokens,
        positions, t_tables, d_tables)`` — the decode packing plus the
        draft pool's tables, bucketed independently (the draft cache
        may cover fewer rows than the target's after a handoff)."""
        b = bucket(len(sessions), self.max_batch)
        nbt = bucket(max(len(s.table) for s in sessions))
        nbd = bucket(max(len(s.draft_table) for s in sessions))
        tokens, positions, t_tables, d_tables = [], [], [], []
        for s in sessions:
            tokens.append(s.pending_tok)
            positions.append(s.position)
            t_tables.append(s.table
                            + [NULL_BLOCK] * (nbt - len(s.table)))
            d_tables.append(s.draft_table
                            + [NULL_BLOCK] * (nbd - len(s.draft_table)))
        for _ in range(b - len(sessions)):
            tokens.append(0)
            positions.append(-1)
            t_tables.append([NULL_BLOCK] * nbt)
            d_tables.append([NULL_BLOCK] * nbd)
        return b, nbt, nbd, tokens, positions, t_tables, d_tables
