"""RolloutRuntime: the generate-then-train loop, the PyTorch counterpart
of ``apex_tpu/rollout/runtime.py``.

One runtime owns one :class:`~apex_tpu_torch.serve.engine.ServeEngine`
(the generator), one fused train step (the consumer), one
:class:`~apex_tpu_torch.rollout.buffer.RolloutBuffer` between them, and the
measured weight-publish path closing the loop.  Work proceeds in
deterministic *rounds*:

1. **evict** — samples older than the staleness bound leave the buffer;
2. **generate** — up to ``rollouts_per_round`` seeded prompts are
   submitted, THROTTLED to the buffer's free slots (backpressure: when
   the trainer falls behind, the serve side generates less, never
   drops a finished rollout);
3. **harvest** — finished continuations enter the buffer stamped with
   the weight epoch they were admitted under;
4. **train** — ``train_steps_per_round`` fused steps on seeded windows
   drawn from the buffer (and, when an
   :class:`~apex_tpu_torch.rollout.distill.OnlineDistiller` is attached,
   ``distill_steps_per_round`` draft-distillation steps on the same
   distribution);
5. **publish** — every ``publish_every`` rounds the trainer's masters
   flow serve-ward (one ``weight_publish`` dispatch copying them into the
   serve parameters in place, epoch bumped); draft publishes ride their
   own cadence with
   the acceptance rate observed under the outgoing draft logged next
   to the new epoch.

Round structure is what makes reproducibility cheap: generation
is greedy and scheduler order is deterministic, prompts and replay
windows come from checkpointed ``numpy`` Generators, and checkpoints
cut at round boundaries — so a job killed mid-round and resumed from
the last checkpoint replays the exact loss trajectory the uninterrupted
job produced (``tests/test_torch_rollout.py`` pins this under a chaos
``train.step`` kill).

A checkpoint carries BOTH model states (target trainer + draft
distiller), the served weight copies at their exact epochs, the buffer
(samples + replay rng), and the loop's own counters — everything
:meth:`RolloutRuntime.restore` needs to continue as if never
interrupted.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from ..observe import registry as _obs
from ..serve.scheduler import Request
from .buffer import RolloutBuffer, RolloutSample
from .distill import OnlineDistiller
from .publish import WeightPublisher, master_leaves

__all__ = ["RolloutRuntime"]


def _default_batch_fn(xs, weights, device="cpu"):
    # self-training LM batch: ids are both input and labels (the loss_fn
    # shifts), int64 on the trainer model's device; staleness weights are
    # dropped — the "drop" policy already evicted anything outside the
    # bound
    del weights
    ids = torch.as_tensor(np.asarray(xs), dtype=torch.long).to(device)
    return ids, ids


class RolloutRuntime:
    def __init__(self, engine, train_step, *,
                 buffer: Optional[RolloutBuffer] = None,
                 capacity: int = 32, max_staleness: int = 2,
                 staleness_policy: str = "drop",
                 prompt_len: int = 8, max_new_tokens: int = 8,
                 rollouts_per_round: int = 4,
                 train_batch: int = 4, train_steps_per_round: int = 2,
                 seq_len: int = 16, publish_every: int = 1,
                 distiller: Optional[OnlineDistiller] = None,
                 distill_batch: int = 4, distill_steps_per_round: int = 1,
                 distill_publish_every: int = 1,
                 batch_fn: Optional[Callable] = None,
                 prompt_fn: Optional[Callable] = None,
                 seed: int = 0):
        self.engine = engine
        self.train_step = train_step
        self.buffer = buffer if buffer is not None else RolloutBuffer(
            capacity, max_staleness=max_staleness,
            staleness_policy=staleness_policy, seed=seed + 1)
        self.publisher = WeightPublisher(engine, which="target")
        self.distiller = distiller
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.rollouts_per_round = int(rollouts_per_round)
        self.train_batch = int(train_batch)
        self.train_steps_per_round = int(train_steps_per_round)
        self.seq_len = int(seq_len)
        self.publish_every = int(publish_every)
        self.distill_batch = int(distill_batch)
        self.distill_steps_per_round = int(distill_steps_per_round)
        self.distill_publish_every = int(distill_publish_every)
        self.batch_fn = batch_fn or functools.partial(
            _default_batch_fn,
            device=next(train_step.model.parameters()).device)
        self.prompt_fn = prompt_fn or self._default_prompts
        self._vocab = int(engine.model.tok_emb.weight.shape[0])
        self._prompt_rng = np.random.default_rng(seed)
        self.round = 0
        self.losses: List[float] = []
        self.accept_windows: List[Optional[float]] = []
        self.tokens_generated = 0
        self.backpressure_rounds = 0

    # -- prompt stream -----------------------------------------------------

    def _default_prompts(self, round_idx: int, rng) -> List[Request]:
        """Seeded synthetic prompt stream.  Always draws a full round's
        worth from ``rng`` — backpressure throttles SUBMISSION, not rng
        consumption, so the stream stays aligned across a resume."""
        return [Request(rid=f"r{round_idx}.{i}",
                        prompt=[int(t) for t in
                                rng.integers(0, self._vocab,
                                             size=self.prompt_len)],
                        max_new_tokens=self.max_new_tokens)
                for i in range(self.rollouts_per_round)]

    # -- one round ---------------------------------------------------------

    def run_round(self) -> dict:
        eng = self.engine
        epoch = eng.weight_epochs["target"]
        evicted = self.buffer.evict_stale(epoch)
        reqs = self.prompt_fn(self.round, self._prompt_rng)
        n = min(len(reqs), self.buffer.free_slots)
        if n < len(reqs):
            self.backpressure_rounds += 1
            _obs.counter("rollout.backpressure").inc()
            _obs.event("rollout.backpressure", round=self.round,
                       submitted=n, throttled=len(reqs) - n,
                       buffer_fill=len(self.buffer))
        reqs = reqs[:n]
        spec0 = eng.metrics()["spec"] if eng.spec else None
        if reqs:
            eng.run(reqs)
            for rq in reqs:
                out = eng.results.pop(rq.rid)
                meta = eng.result_meta.pop(rq.rid, {})
                toks = np.concatenate(
                    [np.asarray(rq.prompt, np.int32),
                     np.asarray(out, np.int32)])
                self.tokens_generated += len(out)
                self.buffer.push(RolloutSample(
                    rid=rq.rid, tokens=toks, prompt_len=len(rq.prompt),
                    weight_epoch=meta.get("weight_epoch", epoch)))
        accept_window = None
        if eng.spec:
            spec1 = eng.metrics()["spec"]
            d_off = spec1["offered"] - spec0["offered"]
            d_acc = spec1["accepted"] - spec0["accepted"]
            accept_window = (d_acc / d_off) if d_off else None
            self.accept_windows.append(accept_window)
        round_losses: List[float] = []
        if len(self.buffer) >= self.train_batch:
            for _ in range(self.train_steps_per_round):
                xs, w, _ages = self.buffer.sample_batch(
                    self.train_batch, self.seq_len, current_epoch=epoch)
                loss = float(self.train_step(*self.batch_fn(xs, w)))
                round_losses.append(loss)
                self.losses.append(loss)
            _obs.counter("rollout.train_steps").inc(len(round_losses))
        distill_losses: List[float] = []
        if self.distiller is not None \
                and len(self.buffer) >= self.distill_batch:
            for _ in range(self.distill_steps_per_round):
                xs, _w, _ages = self.buffer.sample_batch(
                    self.distill_batch, self.seq_len, current_epoch=epoch)
                distill_losses.append(self.distiller.train_on(xs))
        self.round += 1
        if round_losses and self.round % self.publish_every == 0:
            pub = self.publisher.publish(master_leaves(self.train_step))
            _obs.gauge("rollout.weight_epoch").set(pub["epoch"])
        if self.distiller is not None and distill_losses \
                and self.round % self.distill_publish_every == 0:
            self.distiller.publish(accept_rate=accept_window)
        p50 = self.buffer.staleness_p50(eng.weight_epochs["target"])
        rec = {"round": self.round - 1, "submitted": len(reqs),
               "evicted": evicted, "losses": round_losses,
               "distill_losses": distill_losses,
               "accept_rate_window": accept_window,
               "weight_epoch": eng.weight_epochs["target"],
               "buffer_fill": len(self.buffer),
               "staleness_p50": p50}
        _obs.event("rollout.round", round=rec["round"],
                   submitted=rec["submitted"], evicted=evicted,
                   loss_last=round_losses[-1] if round_losses else None,
                   accept_rate_window=accept_window,
                   weight_epoch=rec["weight_epoch"],
                   buffer_fill=rec["buffer_fill"], staleness_p50=p50)
        return rec

    def run(self, rounds: int, *, manager=None,
            save_every: int = 1) -> List[dict]:
        """Run ``rounds`` rounds; with a
        :class:`~apex_tpu_torch.runtime.resilience.CheckpointManager`, save
        every ``save_every`` round boundaries (the granularity a chaos
        kill can lose)."""
        recs = []
        for _ in range(int(rounds)):
            recs.append(self.run_round())
            if manager is not None and self.round % save_every == 0:
                self.save(manager)
        return recs

    # -- checkpoint --------------------------------------------------------

    def save(self, manager) -> str:
        """One atomic checkpoint of the WHOLE loop: trainer state,
        distiller state, the served weight copies at their exact
        epochs, the buffer (samples + replay rng), and loop meta."""
        serve_weights = {
            "target": [p.data for p in self.engine.model.parameters()]}
        if self.engine.spec:
            serve_weights["draft"] = [
                p.data for p in self.engine.draft.parameters()]
        meta = {
            "round": self.round,
            "epochs": dict(self.engine.weight_epochs),
            "publishes": {
                "target": self.publisher.publishes,
                "draft": (self.distiller.publisher.publishes
                          if self.distiller is not None else 0)},
            "buffer": self.buffer.state_dict(),
            "prompt_rng": self._prompt_rng.bit_generator.state,
            "losses": list(self.losses),
            "accept_windows": list(self.accept_windows),
            "tokens_generated": self.tokens_generated,
            "backpressure_rounds": self.backpressure_rounds,
        }
        comps = {"state": self.train_step.state,
                 "serve_weights": serve_weights, "rollout": meta}
        if self.distiller is not None:
            comps["draft_state"] = self.distiller.dstep.step.state
            meta["distill_losses"] = list(self.distiller.losses)
            meta["publish_log"] = [dict(r) for r in
                                   self.distiller.publish_log]
        return manager.save(self.round, **comps)

    def restore(self, manager) -> Optional[int]:
        """Resume from the newest VALID checkpoint (corrupt ones are
        scanned past, ``restore_or_initialize`` semantics).  Copies the
        trainer state into the step's own tensors, republishes the
        saved serve weights at their SAVED epochs (bit-exact), reloads
        the buffer and both rngs, and rewinds the loop counters.
        Returns the checkpoint's round number, or None on a fresh
        start."""
        step_no, comps = manager.restore_or_initialize()
        if step_no is None:
            return None
        self.train_step.load_state(comps["state"])
        meta = comps["rollout"]
        sw = comps["serve_weights"]
        self.publisher.restore(sw["target"],
                               epoch=int(meta["epochs"]["target"]))
        self.publisher.publishes = int(meta["publishes"]["target"])
        if self.distiller is not None:
            self.distiller.dstep.step.load_state(comps["draft_state"])
            self.distiller.publisher.restore(
                sw["draft"], epoch=int(meta["epochs"]["draft"]))
            self.distiller.publisher.publishes = \
                int(meta["publishes"]["draft"])
            self.distiller.losses = list(meta.get("distill_losses", []))
            self.distiller.publish_log = [
                dict(r) for r in meta.get("publish_log", [])]
        self.buffer.load_state_dict(meta["buffer"])
        self._prompt_rng.bit_generator.state = meta["prompt_rng"]
        self.round = int(meta["round"])
        self.losses = [float(x) for x in meta["losses"]]
        self.accept_windows = list(meta["accept_windows"])
        self.tokens_generated = int(meta["tokens_generated"])
        self.backpressure_rounds = int(meta["backpressure_rounds"])
        _obs.event("rollout.restore", round=self.round,
                   weight_epoch=self.engine.weight_epochs["target"],
                   buffer_fill=len(self.buffer))
        return step_no
