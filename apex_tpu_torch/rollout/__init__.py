"""apex_tpu_torch.rollout: the generate-then-train runtime, the PyTorch
counterpart of ``apex_tpu/rollout``.

A :class:`RolloutRuntime` drives a ServeEngine generating continuations
while the fused train step consumes completed rollouts from a
bounded-staleness :class:`RolloutBuffer`, and trainer weights flow back
serve-ward through the measured, versioned :class:`WeightPublisher` (one
``weight_publish`` dispatch copying the masters into the parameters the
engine's captured graphs read).  :class:`OnlineDistiller` trains the
speculative draft continuously against live acceptance telemetry and
publishes improved drafts into the engine's speculative pool.
"""
from .buffer import RolloutBuffer, RolloutSample
from .distill import OnlineDistiller
from .publish import WeightPublisher, master_leaves
from .runtime import RolloutRuntime

__all__ = ["RolloutBuffer", "RolloutSample", "OnlineDistiller",
           "WeightPublisher", "master_leaves", "RolloutRuntime"]
