"""Elastic training, the PyTorch counterpart of
``apex_tpu/runtime/elastic.py``: not ported yet (ROADMAP A9).

The JAX module re-plans a run for the device set that came back after a
preemption: ``ElasticTrainer.restore`` picks a new layout through
``parallel.auto.plan_training`` and ``current_devices`` resolves devices
through the planner.  The port has no planner yet.  On one card elastic
restore reduces to a restore of the same layout, which
``runtime.resilience.CheckpointManager.restore_resharded`` gives.  Each
name below refuses, naming ROADMAP A9.
"""
from __future__ import annotations

from .._unported import refuse

_A9 = "ROADMAP A9, the planner (parallel/auto.py) that elastic restore " \
      "re-plans through"


def current_devices(devices=None) -> list:
    refuse("runtime.elastic.current_devices", _A9)


class ElasticTrainer:
    def __init__(self, manager, model, optimizer, loss_fn, **kwargs):
        refuse("runtime.elastic.ElasticTrainer", _A9)


def elastic_restore(manager, model, optimizer, loss_fn, **kwargs):
    refuse("runtime.elastic.elastic_restore", _A9)
