"""Bounded-staleness rollout buffer with deterministic seeded replay, the
PyTorch port's copy of ``apex_tpu/rollout/buffer.py`` (numpy only: the
same draws, so a seeded replay gives the JAX package's windows).

The buffer is the seam between the serve side (producing finished
continuations) and the train side (consuming token windows): a FIFO of
:class:`RolloutSample` records, each stamped with the weight epoch its
generation was ADMITTED under (the oldest weights any of its tokens
saw — the engine stamps it, see ``ServeEngine.publish_weights``).

Staleness is measured in weight epochs, not wall time: a sample's age
is ``current_epoch - sample.weight_epoch``.  Two policies bound it:

* ``"drop"`` (default) — :meth:`evict_stale` removes samples older
  than ``max_staleness`` before each round; evictions are counted and
  emitted (``rollout.evicted_stale``).
* ``"downweight"`` — nothing is evicted; :meth:`sample_batch` returns
  per-sample loss weights ``downweight ** (age - max_staleness)``
  (1.0 within the bound) for the caller to fold into its loss.

Backpressure is the CALLER's half of the contract: the runtime reserves
``free_slots`` before submitting prompts, so :meth:`push` never drops a
finished rollout — a full buffer throttles generation instead
(``rollout.backpressure`` counts the throttled rounds).  ``push`` still
refuses when full (counted) so a caller that skips the reservation
fails loudly in its metrics rather than silently growing memory.

Replay is seeded and fully checkpointable: :meth:`sample_batch` draws
through a private ``numpy`` Generator whose bit-generator state rides
in :meth:`state_dict`, so a restored buffer replays the exact batch
sequence the uninterrupted run would have drawn — the loss-trajectory
reproducibility pin of the rollout tests rests on this.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..observe import registry as _obs

__all__ = ["RolloutSample", "RolloutBuffer"]

_POLICIES = ("drop", "downweight")


@dataclass
class RolloutSample:
    """One finished rollout: prompt + generated ids, flat int32."""
    rid: str
    tokens: np.ndarray           # 1-D int32, prompt then continuation
    prompt_len: int
    weight_epoch: int            # target epoch at admission

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        self.prompt_len = int(self.prompt_len)
        self.weight_epoch = int(self.weight_epoch)


class RolloutBuffer:
    def __init__(self, capacity: int, *, max_staleness: int = 2,
                 staleness_policy: str = "drop", downweight: float = 0.5,
                 seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if staleness_policy not in _POLICIES:
            raise ValueError(f"staleness_policy must be one of "
                             f"{_POLICIES}, got {staleness_policy!r}")
        self.capacity = int(capacity)
        self.max_staleness = int(max_staleness)
        self.staleness_policy = staleness_policy
        self.downweight = float(downweight)
        self._samples: List[RolloutSample] = []
        self._rng = np.random.default_rng(seed)
        self.pushed = 0
        self.rejects = 0
        self.evicted = 0
        self.draws = 0

    def __len__(self) -> int:
        return len(self._samples)

    @property
    def free_slots(self) -> int:
        return self.capacity - len(self._samples)

    # -- produce -----------------------------------------------------------

    def push(self, sample: RolloutSample) -> bool:
        """Append a finished rollout; False (counted) when full — the
        runtime's slot reservation makes this unreachable in the loop."""
        if len(self._samples) >= self.capacity:
            self.rejects += 1
            _obs.counter("rollout.buffer.rejects").inc()
            return False
        self._samples.append(sample)
        self.pushed += 1
        _obs.counter("rollout.samples").inc()
        _obs.gauge("rollout.buffer_fill").set(len(self._samples))
        return True

    # -- staleness ---------------------------------------------------------

    def ages(self, current_epoch: int) -> List[int]:
        return [current_epoch - s.weight_epoch for s in self._samples]

    def staleness_p50(self, current_epoch: int) -> float:
        ages = self.ages(current_epoch)
        return float(np.median(ages)) if ages else 0.0

    def evict_stale(self, current_epoch: int) -> int:
        """Drop samples older than ``max_staleness`` epochs (no-op under
        the downweight policy).  Returns the eviction count."""
        if self.staleness_policy != "drop":
            return 0
        keep = [s for s in self._samples
                if current_epoch - s.weight_epoch <= self.max_staleness]
        n = len(self._samples) - len(keep)
        if n:
            self._samples = keep
            self.evicted += n
            _obs.counter("rollout.evicted_stale").inc(n)
            _obs.gauge("rollout.buffer_fill").set(len(self._samples))
        return n

    # -- consume -----------------------------------------------------------

    def sample_batch(self, batch_size: int, seq_len: int, *,
                     current_epoch: int) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
        """Draw ``batch_size`` fixed-length token windows (seeded, with
        replacement; short rollouts tile deterministically via
        ``np.resize``).  Returns ``(ids (B,S) int32, weights (B,) f32,
        ages (B,) int)`` — weights are all-ones under ``"drop"`` and the
        staleness decay under ``"downweight"``."""
        if not self._samples:
            raise ValueError("sample_batch on an empty RolloutBuffer")
        idx = self._rng.integers(0, len(self._samples), size=batch_size)
        xs = np.stack([np.resize(self._samples[i].tokens, seq_len)
                       for i in idx]).astype(np.int32)
        ages = np.array([current_epoch - self._samples[i].weight_epoch
                         for i in idx], np.int64)
        if self.staleness_policy == "downweight":
            over = np.maximum(ages - self.max_staleness, 0)
            w = (self.downweight ** over).astype(np.float32)
        else:
            w = np.ones(batch_size, np.float32)
        self.draws += 1
        for a in ages:
            _obs.histogram("rollout.staleness").observe(float(a))
        return xs, w, ages

    # -- checkpoint --------------------------------------------------------

    def state_dict(self) -> Dict:
        """Everything a bit-exact resume needs: samples, counters, and
        the replay Generator's bit-generator state."""
        return {
            "samples": [{"rid": s.rid, "tokens": s.tokens.copy(),
                         "prompt_len": s.prompt_len,
                         "weight_epoch": s.weight_epoch}
                        for s in self._samples],
            "rng": self._rng.bit_generator.state,
            "counters": {"pushed": self.pushed, "rejects": self.rejects,
                         "evicted": self.evicted, "draws": self.draws},
            "config": {"capacity": self.capacity,
                       "max_staleness": self.max_staleness,
                       "staleness_policy": self.staleness_policy,
                       "downweight": self.downweight},
        }

    def load_state_dict(self, sd: Dict) -> "RolloutBuffer":
        cfg = sd.get("config", {})
        if cfg and int(cfg["capacity"]) != self.capacity:
            raise ValueError(
                f"rollout buffer capacity mismatch: checkpoint has "
                f"{cfg['capacity']}, this buffer {self.capacity} — "
                f"replay would diverge")
        self._samples = [RolloutSample(**s) for s in sd["samples"]]
        self._rng.bit_generator.state = sd["rng"]
        c = sd.get("counters", {})
        self.pushed = int(c.get("pushed", 0))
        self.rejects = int(c.get("rejects", 0))
        self.evicted = int(c.get("evicted", 0))
        self.draws = int(c.get("draws", 0))
        return self
