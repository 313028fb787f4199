"""The elastic serve fleet, the PyTorch counterpart of
``apex_tpu/serve/elastic.py``: not ported yet (ROADMAP A10).

The JAX module replicates the serve engine behind a membership-backed
fleet (``cluster.coordinator``, ``cluster.kvstore``,
``cluster.membership``, ``cluster.runtime``) with live session migration
and SLO-aware shedding; the port has no ``cluster/`` yet.  The names are
kept: :class:`StaleEpochError` is the JAX package's exception, and
building a fleet or a member refuses, naming ROADMAP A10.
"""
from __future__ import annotations

from .._unported import refuse

_A10 = "ROADMAP A10, cluster/"


class StaleEpochError(RuntimeError):
    """A submission addressed a membership epoch the fleet has moved
    past; the client must re-resolve the current view and resubmit."""


class FleetMember:
    def __init__(self, member, engine):
        refuse("serve.FleetMember (a fleet replica)", _A10)


class ServeFleet:
    def __init__(self, model, *, n_engines, num_blocks, block_size=16,
                 max_batch=8, prefill_chunk=32, cache_dtype=None,
                 draft=None, spec_k=4, draft_cache_dtype="int8",
                 spec_policy="on", kv=None, clock=None, deadline_s=0.25,
                 miss_threshold=2, snapshot_every=2, snapshot_dir=None,
                 snapshot_max_age_ticks=None, migrate_per_tick=None):
        refuse("serve.ServeFleet (the elastic serve fleet)", _A10)
