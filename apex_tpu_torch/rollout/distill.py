"""Online draft distillation, the rollout loop's first concrete scenario;
the PyTorch counterpart of ``apex_tpu/rollout/distill.py``.

A speculative serve engine is only as fast as its draft's acceptance
rate, and acceptance decays as the TARGET trains away from whatever the
draft was distilled on.  The fix is to close the loop: keep a trainable
draft master distilling continuously against the live target (hard
labels, the exact event the acceptance rule tests, see
``inference/draft.py``), watch the engine's own acceptance telemetry,
and publish improved drafts back into the engine's speculative pool
through the same measured weight-publish path the target uses.

:class:`OnlineDistiller` owns the three pieces: the persistent
:func:`~apex_tpu_torch.inference.draft.make_distill_step` (optimizer
moments and, on the card, the captured step survive across publish
windows), a ``which="draft"``
:class:`~apex_tpu_torch.rollout.publish.WeightPublisher`, and the publish
log pairing each draft epoch with the acceptance rate observed in the
window before it.

Labels read the ENGINE's target model at call time, so after every
target publish the distillation objective tracks the weights actually
being served.
"""
from __future__ import annotations

from typing import List, Optional

from ..inference.draft import make_distill_step
from ..observe import registry as _obs
from .publish import WeightPublisher, master_leaves

__all__ = ["OnlineDistiller"]


class OnlineDistiller:
    def __init__(self, engine, draft_master, *, lr: float = 1e-3):
        if not engine.spec:
            raise ValueError("OnlineDistiller needs a speculative engine "
                             "(ServeEngine(draft=...))")
        self.engine = engine
        self.draft_master = draft_master
        self.dstep = make_distill_step(draft_master, engine.model, lr=lr)
        self.publisher = WeightPublisher(engine, which="draft")
        self.losses: List[float] = []
        self.publish_log: List[dict] = []

    def train_on(self, xs) -> float:
        """One fused distillation step on a ``(B,S)`` id batch (rollout
        windows drawn from the buffer: the draft distills on the same
        distribution it will be asked to speculate on)."""
        loss = self.dstep(xs)
        self.losses.append(loss)
        _obs.counter("rollout.distill_steps").inc()
        return loss

    def publish(self, *, accept_rate: Optional[float] = None) -> dict:
        """Publish the draft master into the engine's speculative pool
        (one ``weight_publish`` dispatch) and log the acceptance rate
        observed under the OUTGOING draft: the before/after pairs are the
        improvement evidence."""
        stats = self.publisher.publish(master_leaves(self.dstep.step))
        rec = {"epoch": stats["epoch"], "accept_rate": accept_rate,
               "loss_last": self.losses[-1] if self.losses else None}
        self.publish_log.append(rec)
        _obs.event("rollout.distill_publish", **rec)
        return stats
