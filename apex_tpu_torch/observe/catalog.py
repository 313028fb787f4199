"""Metric catalog: the documented name -> meaning table, the port's copy
of ``apex_tpu/observe/catalog.py`` (the same dict, entry for entry).

The registry (``registry.py``) is schema-free: any string names a
counter.  The catalog is where a consumer (a dashboard, a bench stage, a
test) reads what a name means, its instrument kind and its unit.  Its
entries name subsystems the JAX package has and the port may not run yet
(rollout, the planner): a name is documented before it is emitted.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["CATALOG", "describe", "names"]

#: name -> {kind, unit, description}.  ``kind`` is one of
#: "counter" | "gauge" | "histogram" | "event".
CATALOG: Dict[str, Dict[str, str]] = {
    # -- rollout: weight publish ------------------------------------------
    "rollout.weight_sync": {
        "kind": "event", "unit": "record",
        "description": "One train→serve weight publish: which weight "
                       "set, new epoch, sync wall-ms, zero-copy vs "
                       "copied leaf counts, bytes moved."},
    "rollout.weight_sync_ms": {
        "kind": "histogram", "unit": "ms",
        "description": "Wall time of one weight publish (cast dispatch "
                       "+ reshard + hot-swap)."},
    "rollout.zero_copy_frac": {
        "kind": "gauge", "unit": "fraction",
        "description": "Fraction of leaves in the last publish that "
                       "rode the layout-identical zero-copy fast path."},
    "rollout.publishes": {
        "kind": "counter", "unit": "publishes",
        "description": "Weight publishes since process start (target "
                       "and draft)."},
    # -- rollout: buffer ---------------------------------------------------
    "rollout.samples": {
        "kind": "counter", "unit": "samples",
        "description": "Finished rollouts accepted into the buffer."},
    "rollout.buffer.rejects": {
        "kind": "counter", "unit": "samples",
        "description": "Pushes refused by a full buffer (unreachable "
                       "under the runtime's slot reservation — nonzero "
                       "means a caller skipped backpressure)."},
    "rollout.buffer_fill": {
        "kind": "gauge", "unit": "samples",
        "description": "Live samples in the buffer."},
    "rollout.evicted_stale": {
        "kind": "counter", "unit": "samples",
        "description": "Samples dropped for exceeding the staleness "
                       "bound (drop policy)."},
    "rollout.staleness": {
        "kind": "histogram", "unit": "weight-epochs",
        "description": "Sample age (current epoch - admission epoch) "
                       "at every training draw."},
    "rollout.backpressure": {
        "kind": "counter", "unit": "rounds",
        "description": "Rounds where generation was throttled because "
                       "the buffer lacked free slots (trainer behind)."},
    # -- rollout: loop -----------------------------------------------------
    "rollout.round": {
        "kind": "event", "unit": "record",
        "description": "One generate→train round: submissions, "
                       "evictions, last loss, windowed accept rate, "
                       "epoch, buffer fill, staleness p50."},
    "rollout.train_steps": {
        "kind": "counter", "unit": "steps",
        "description": "Fused train steps consumed from the buffer."},
    "rollout.weight_epoch": {
        "kind": "gauge", "unit": "epoch",
        "description": "Target weight epoch currently being served."},
    "rollout.restore": {
        "kind": "event", "unit": "record",
        "description": "A rollout job resumed from checkpoint: round, "
                       "epoch, buffer fill."},
    # -- rollout: online distillation -------------------------------------
    "rollout.distill_steps": {
        "kind": "counter", "unit": "steps",
        "description": "Draft distillation steps taken."},
    "rollout.distill_publish": {
        "kind": "event", "unit": "record",
        "description": "A draft publish: new draft epoch, acceptance "
                       "rate observed under the OUTGOING draft, last "
                       "distill loss."},
    # -- serve: the hot-swap seam the rollout loop drives ------------------
    "serve.weight_swap": {
        "kind": "event", "unit": "record",
        "description": "ServeEngine.publish_weights applied: weight "
                       "set, epoch now served, tick, leaf count."},
    # -- serve: prefix cache (content-addressed KV block reuse) ------------
    "serve.prefix.hit_rate": {
        "kind": "gauge", "unit": "fraction",
        "description": "Prompt tokens admission found already cached "
                       "over all prompt tokens submitted, engine "
                       "lifetime-cumulative (docs/serving.md, Prefix "
                       "caching)."},
    "serve.prefix.tokens_saved": {
        "kind": "counter", "unit": "tokens",
        "description": "Prompt tokens whose prefill was skipped "
                       "because their KV blocks were adopted from the "
                       "hash index."},
    "serve.prefix.cow_forks": {
        "kind": "counter", "unit": "blocks",
        "description": "Copy-on-write forks of shared blocks (a "
                       "full-chain hit re-ingests its final token into "
                       "an exclusive copy)."},
    "serve.cache.evictions": {
        "kind": "counter", "unit": "blocks",
        "description": "Cached-tier blocks evicted under allocation "
                       "pressure (hash entry dropped, id returned to "
                       "the free list)."},
    "serve.pool.free": {
        "kind": "gauge", "unit": "blocks",
        "description": "Free-list blocks: allocatable without evicting "
                       "any cached-tier entry."},
    "serve.pool.cached": {
        "kind": "gauge", "unit": "blocks",
        "description": "Cached-tier blocks: refcount zero with a live "
                       "hash entry — reclaimable headroom, not "
                       "occupancy."},
    "serve.pool.active": {
        "kind": "gauge", "unit": "blocks",
        "description": "Blocks held by at least one live block table "
                       "(refcount >= 1)."},
    # -- planner: the joint pp×remat×offload×ep search ---------------------
    "plan.search_ms": {
        "kind": "gauge", "unit": "ms",
        "description": "Wall time of the last plan_training joint "
                       "search (enumerate → prune → rank, including "
                       "ledger re-pricing)."},
    "plan.explored": {
        "kind": "gauge", "unit": "plans",
        "description": "Plans enumerated by the last joint search, "
                       "feasible and rejected alike — nothing is "
                       "pruned before it is counted."},
    "plan.pruned_oom": {
        "kind": "gauge", "unit": "plans",
        "description": "Plans the last search rejected as "
                       "memory-infeasible under the per-device HBM "
                       "model (reason strings carry the breakdown)."},
    "plan.bubble_frac": {
        "kind": "gauge", "unit": "fraction",
        "description": "Pipeline bubble fraction (pp-1)/(micro+pp-1) "
                       "of the chosen plan; set only when the winner "
                       "pipelines (pp > 1)."},
}


def names(prefix: str = "") -> list:
    """Cataloged metric names, optionally filtered by prefix."""
    return sorted(n for n in CATALOG if n.startswith(prefix))


def describe(name: str) -> Optional[Dict[str, str]]:
    """The catalog entry for ``name``, or None if uncataloged."""
    return CATALOG.get(name)
