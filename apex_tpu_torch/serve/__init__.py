"""apex_tpu_torch.serve: continuous-batching + paged-KV serving, the
PyTorch counterpart of ``apex_tpu/serve``.

The multi-tenant leg of the decode stack: many sessions share one
preallocated device block pool (:mod:`.pool`), a continuous-batching
scheduler re-packs the live set every tick (:mod:`.scheduler`), and the
engine (:mod:`.engine`) dispatches a small family of programs
(``prefill_step`` / ``decode_step`` / ``draft_prefill_step`` /
``spec_verify_step`` / ``block_copy``, bodies in :mod:`.kernels`) through
the executor, one CUDA graph a bucket signature on the card.
:mod:`.disagg` splits the engine into a prefill phase and a decode phase
(optionally speculative, with a draft model served from its own int8
pool) joined by the schema-3 streamed KV handoff, whose files either
package reads.  :mod:`.elastic`'s ``ServeFleet`` replicates the engine
behind the cluster membership view (``apex_tpu_torch.cluster``): epoch-aware
routing by projected free blocks, periodic session snapshots over the same
handoff, and live migration of a lost replica's sessions (batch tier shed
first, recompute as the fallback).
"""
from .disagg import DisaggregatedEngine
from .elastic import FleetMember, ServeFleet, StaleEpochError
from .engine import ServeEngine
from .pool import BlockPool, NULL_BLOCK, blocks_for, init_pool_buffer
from .scheduler import Request, SLO_CLASSES, Scheduler, Session, bucket

__all__ = [
    "DisaggregatedEngine", "ServeEngine", "ServeFleet", "FleetMember",
    "StaleEpochError", "SLO_CLASSES", "Request", "Scheduler",
    "Session", "bucket", "BlockPool", "NULL_BLOCK", "blocks_for",
    "init_pool_buffer",
]
