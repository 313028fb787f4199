"""Paged KV block pool, the PyTorch counterpart of
``apex_tpu/serve/pool.py``: one preallocated device buffer for every
session.

The single-session decode paths (``inference.DecodeSession``,
``models.gpt.generate``) each allocate private ``(B, H, S_max, D)``
caches sized for their own worst case; at serving concurrency a thousand
mostly-short sessions would reserve a thousand full-context caches.
vLLM's paged-attention observation is that KV state is append-only and
block-granular, so sessions can share ONE fixed pool of
``block_size``-position blocks and hold only an integer block table
(logical block i -> physical block id).  The serve programs' operand
shapes then depend only on the pool geometry and the bucket dims, never
on which sessions are resident: on the card each bucket is one CUDA graph
that session churn replays.

Layout: ``(layers, 2, num_blocks, heads, block_size, head_dim)``, the
JAX package's (the KV handoff's block files and their geometry check
depend on it): k/v on axis 1, block id on axis 2.  **Physical block 0 is
the null block**: never allocated, all zeros, and it pads every block
table out to its bucket width; gathers through it read zeros that the
position mask excludes, and the programs send dead rows' writes there as
zeros (``serve.kernels.scatter_pool``), so it stays all zeros.
``dtype="int8"`` builds the quantized pool as a
:class:`~apex_tpu_torch.inference.quant.QuantKV` (int8 payload + one fp32
scale per cached position, the contiguous int8 cache's per-position
absmax).

**Reference counting + content addressing** (the prefix cache): every
held block carries a refcount, so N sessions whose token chains share a
committed prefix hold the SAME physical blocks.  Full blocks are
*committed* under a rolling content hash of their token chain
(:func:`chain_key`: the parent block's hash, the block's tokens, and a
tag carrying cache dtype / block size / attention window / weight epoch;
the same blake2b bytes as the JAX package's).  The ``hash -> block``
index (:meth:`BlockPool.acquire_prefix`) turns admission into a chain
walk: matched blocks are adopted by refcount and only the cold suffix is
granted from the free list.

Shared blocks are immutable: a session that must write into one forks it
copy-on-write (the scheduler's policy and the block-copy program of
``serve.kernels``; the pool only keeps the ids).  A freed block whose
hash entry is live retires into an LRU **cached tier** (refcount zero,
bytes intact, adoptable) and is evicted only under allocation pressure.
Cached blocks are headroom, not leaks: ``check_no_leaks`` and
``free_count`` count them as reclaimable.

The host side (:class:`BlockPool`) is integer bookkeeping with leak
accounting; policy lives in the scheduler, device index arithmetic in
``serve/kernels.py``.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Sequence

import torch

from ..inference.quant import QuantKV, _is_int8
from ..kernels.dispatch import resolve_device
from ..observe import registry as _obs

#: physical id of the all-zeros block every table pads with
NULL_BLOCK = 0


def blocks_for(n_positions: int, block_size: int) -> int:
    """Blocks needed to hold ``n_positions`` KV rows."""
    return -(-max(int(n_positions), 0) // block_size)


def init_pool_buffer(layers, heads, head_dim, num_blocks, block_size,
                     dtype=torch.float32, device=None):
    """The device-side pool ``(layers, 2, num_blocks, heads, block_size,
    head_dim)``: zeros, so the null block is born valid.
    ``dtype="int8"``/``torch.int8`` builds the :class:`QuantKV` pair
    (scales fp32, one per position).  ``device`` defaults to the card."""
    shape = (layers, 2, num_blocks, heads, block_size, head_dim)
    device = resolve_device(device)
    if _is_int8(dtype):
        return QuantKV(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                        device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Content hashing: the rolling token-chain key
# ---------------------------------------------------------------------------


def chain_key(parent: str, tokens: Sequence[int], tag: str) -> str:
    """The content hash of ONE full block: rolling over ``parent`` (the
    previous block's key, ``""`` for the chain head), the block's token
    ids, and ``tag`` — the engine's cache-compatibility stamp (dtype,
    block size, window, weight epoch).  Two blocks share a key iff they
    hold the KV of the same token prefix computed under the same cache
    geometry and weights — which is exactly when their bytes are
    interchangeable."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent.encode("ascii"))
    h.update(b"\x00")
    h.update(tag.encode("utf-8"))
    h.update(b"\x00")
    h.update(",".join(str(int(t)) for t in tokens).encode("ascii"))
    return h.hexdigest()


def chain_keys(tokens: Sequence[int], block_size: int,
               tag: str) -> List[str]:
    """The hash chain over every FULL block of ``tokens`` (partial tail
    blocks are never content-addressed — their rows are still being
    written)."""
    keys: List[str] = []
    prev = ""
    for i in range(len(tokens) // block_size):
        prev = chain_key(prev, tokens[i * block_size:(i + 1) * block_size],
                         tag)
        keys.append(prev)
    return keys


class BlockPool:
    """Host-side refcounted allocator over physical block ids
    ``1 .. num_blocks-1`` (id 0 is :data:`NULL_BLOCK`, never handed
    out).

    ``alloc(n)`` returns ``n`` exclusive ids (refcount 1) or None
    (all-or-nothing — a partial grant would deadlock two half-admitted
    sessions against each other), evicting LRU cached-tier blocks under
    pressure; ``free(ids)`` drops one reference per id — a block
    reaching refcount zero retires to the cached tier when its hash
    entry is live, else returns to the free list.  Freeing more times
    than references held raises (the shared-block double-free).
    ``acquire_prefix(keys)`` walks a request's hash chain and adopts
    the longest matched prefix by refcount; ``commit(id, key)``
    registers a full block under its chain hash.  Every transition
    keeps the ``pool.free`` / ``pool.cached`` / ``pool.active`` gauges
    current, and the churn tests pin ``in_use == 0`` +
    ``free + cached == capacity`` after drain.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 metrics_prefix: str = "serve."):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved null "
                f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._prefix = metrics_prefix
        self._lock = threading.Lock()
        # LIFO: recently freed blocks are re-issued first (their pool
        # rows are the likeliest to be warm in a cache)
        self._free = list(range(num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}          # id -> refcount (held)
        # refcount-zero blocks with live hash entries, LRU order
        # (oldest retired first); values are their chain keys
        self._cached: "OrderedDict[int, str]" = OrderedDict()
        self._hash_index: Dict[str, int] = {}    # chain key -> id
        self._block_hash: Dict[int, str] = {}    # id -> chain key
        self.cache_evictions = 0
        self._gauge()

    # -- accounting --------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks (the null block is not one)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        """Allocatable headroom NOW: free-list blocks plus cached-tier
        blocks (evictable on demand) — what admission and the elastic
        fleet's backpressure should budget against."""
        with self._lock:
            return len(self._free) + len(self._cached)

    @property
    def free_exact(self) -> int:
        """Free-list blocks only (no cached-tier eviction needed)."""
        with self._lock:
            return len(self._free)

    @property
    def cached_count(self) -> int:
        """Cached-tier blocks: refcount zero, hash entry live."""
        with self._lock:
            return len(self._cached)

    @property
    def in_use(self) -> int:
        """Blocks held by at least one live table (refcount >= 1)."""
        with self._lock:
            return len(self._refs)

    @property
    def occupancy(self) -> float:
        """Fraction of allocatable blocks currently held (cached-tier
        blocks are reclaimable headroom, not occupancy)."""
        with self._lock:
            return len(self._refs) / (self.num_blocks - 1)

    def refcount(self, block_id: int) -> int:
        """Live references to ``block_id`` (0 = free or cached)."""
        with self._lock:
            return self._refs.get(block_id, 0)

    def _gauge(self):
        cap = self.num_blocks - 1
        _obs.gauge(self._prefix + "pool_occupancy").set(
            len(self._refs) / cap)
        _obs.gauge(self._prefix + "pool_free_blocks").set(
            len(self._free) + len(self._cached))
        # the split gauges: free conflated with soon-to-be-cached was
        # hiding true headroom from the elastic fleet's shed decisions
        _obs.gauge(self._prefix + "pool.free").set(len(self._free))
        _obs.gauge(self._prefix + "pool.cached").set(len(self._cached))
        _obs.gauge(self._prefix + "pool.active").set(len(self._refs))

    # -- alloc / free ------------------------------------------------------

    def _evict_locked(self) -> None:
        """Drop the LRU cached-tier block's hash entry and return its
        id to the free list (caller holds the lock)."""
        bid, key = self._cached.popitem(last=False)
        del self._hash_index[key]
        del self._block_hash[bid]
        self._free.append(bid)
        self.cache_evictions += 1
        _obs.counter(self._prefix + "cache.evictions").inc()

    def alloc(self, n: int):
        """``n`` exclusive physical block ids (refcount 1), or None if
        the pool cannot cover the whole request (nothing is taken on
        refusal).  Cached-tier blocks are evicted LRU-first when the
        free list alone cannot cover ``n`` — allocation pressure is the
        cached tier's only eviction trigger."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        with self._lock:
            if n > len(self._free) + len(self._cached):
                return None
            while len(self._free) < n:
                self._evict_locked()
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._refs[b] = 1
            self._gauge()
        return ids

    def free(self, ids) -> None:
        """Drop ONE reference per id.  A block reaching refcount zero
        retires to the cached tier when its hash entry is live (bytes
        stay adoptable), else returns to the free list.  Freeing an id
        with no live reference raises — that is a double free (of an
        exclusive OR a shared block: sharing never grants extra
        frees)."""
        with self._lock:
            for b in ids:
                r = self._refs.get(b)
                if r is None:
                    raise ValueError(
                        f"free of block {b} not held by this pool "
                        f"(double free, foreign id, or more frees than "
                        f"references) — block tables and the refcounts "
                        f"have diverged")
                if r > 1:
                    self._refs[b] = r - 1
                    continue
                del self._refs[b]
                key = self._block_hash.get(b)
                if key is not None:
                    self._cached[b] = key        # MRU end of the LRU
                else:
                    self._free.append(b)
            self._gauge()

    # -- content addressing ------------------------------------------------

    def acquire_prefix(self, keys: Sequence[str]) -> List[int]:
        """Walk a request's hash chain and adopt the longest matched
        prefix: each matched block gains a reference (cached-tier
        blocks are resurrected to refcount 1; held blocks just
        increment).  Returns the matched physical ids, chain order —
        the caller budgets only the cold suffix.  Adopted blocks are
        shared and immutable; release them with :meth:`free`."""
        out: List[int] = []
        with self._lock:
            for key in keys:
                bid = self._hash_index.get(key)
                if bid is None:
                    break
                if bid in self._refs:
                    self._refs[bid] += 1
                else:
                    del self._cached[bid]
                    self._refs[bid] = 1
                out.append(bid)
            if out:
                self._gauge()
        return out

    def commit(self, block_id: int, key: str) -> bool:
        """Register a held, FULL block under its chain hash — from now
        on :meth:`acquire_prefix` can adopt it and :meth:`free` retires
        it to the cached tier instead of the free list.  First writer
        wins: a key already mapped (another session committed the same
        chain first) or a block already hashed is left untouched
        (returns False)."""
        with self._lock:
            if block_id not in self._refs:
                return False                 # freed/evicted underneath
            if key in self._hash_index or block_id in self._block_hash:
                return False
            self._hash_index[key] = block_id
            self._block_hash[block_id] = key
            return True

    def flush_cache(self) -> int:
        """Drop EVERY hash entry and return all cached-tier blocks to
        the free list — the ``publish_weights`` invalidation path: a
        weight hot-swap changes the chain tag, so no stale entry can
        ever match again; flushing reclaims the memory immediately.
        Held blocks stay held (their sessions continue under mixed
        weights) but lose their hash
        entries, so they free to the free list later.  Returns the
        number of cached blocks reclaimed."""
        with self._lock:
            n = len(self._cached)
            for bid in self._cached:
                self._free.append(bid)
            self._cached.clear()
            self._hash_index.clear()
            self._block_hash.clear()
            self._gauge()
            return n

    def check_no_leaks(self) -> None:
        """Raise unless every allocatable block is reclaimable — on the
        free list or in the cached tier (refcount zero, adoptable).
        Cached blocks are NOT leaks: they are the prefix cache
        surviving session churn, evictable on demand.  The post-drain
        invariant of the churn tests."""
        with self._lock:
            if self._refs or \
                    len(self._free) + len(self._cached) \
                    != self.num_blocks - 1:
                raise AssertionError(
                    f"block pool leak: {len(self._refs)} blocks still "
                    f"held (refcounts {dict(self._refs)}), free list "
                    f"{len(self._free)} + cached {len(self._cached)} != "
                    f"{self.num_blocks - 1}")
