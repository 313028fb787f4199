"""apex_tpu_torch.cluster: cluster membership, the PyTorch counterpart of
``apex_tpu/cluster``.

KV-backed membership with heartbeats and epoch-numbered views
(:mod:`.membership`, :mod:`.coordinator`) over pluggable coordination
substrates (:mod:`.kvstore`: in-memory for one-process simulation,
file-backed across real processes, the ``torch.distributed`` process
group's store across ranks), the deterministic clock and the membership
cycle the serve fleet runs (:mod:`.runtime`).  ``ClusterTrainer`` and
``fleet_for_members``, which re-plan training through the planner, are
ROADMAP A9 and refuse.  This package (with ``parallel.distributed``) is
the one home of process-topology assumptions.
"""
from .kvstore import (  # noqa: F401
    FileKV, JaxCoordinatorKV, KVStore, MemoryKV, default_kv)
from .membership import (  # noqa: F401
    PREFIX, Member, MembershipView, current_epoch, current_view)
from .coordinator import Coordinator  # noqa: F401
from .runtime import (  # noqa: F401
    ClusterTrainer, SimClock, SimHost, beat_and_scan, fleet_for_members,
    spawn_member_process)

__all__ = [
    "PREFIX", "KVStore", "MemoryKV", "FileKV", "JaxCoordinatorKV",
    "default_kv",
    "Member", "MembershipView", "current_epoch", "current_view",
    "Coordinator", "ClusterTrainer", "SimClock", "SimHost",
    "beat_and_scan", "fleet_for_members", "spawn_member_process",
]
