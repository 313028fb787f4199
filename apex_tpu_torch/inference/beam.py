"""Beam-search decoding over the LM families' cache protocol, the PyTorch
counterpart of ``apex_tpu/inference/beam.py``.

Beams fold into the batch (caches and token buffers are ``(B*K, ...)``,
the beams of item ``i`` in rows ``i*K .. i*K + K - 1``).  The prompt is
prefilled once at batch B and the caches fanned out item-major; every
step is one ``decode_step`` and one top-k over ``K*V`` candidates an item,
and the beams' reorder is an ``index_select`` of each held cache written
back into it.  A step is an executor program over held state (the caches,
the beams' tokens, scores, alive flags, lengths and token buffer, the
position and the step index, all on the device), cached per bucket as
``generate``'s is, so on the card it replays as a CUDA graph.

Scores carry the raw sum of token log-probs; the ranking (and the final
beam choice) divides by the GNMT length penalty ``((5 + len) / 6) **
alpha``.  With ``eos_id`` a finished beam freezes its score and length
and pads with ``eos_id`` while it keeps competing.
"""
from __future__ import annotations

import torch

from .._unported import PARALLEL, accept_defaults
from ..utils.jit_cache import compiled_run_cache, model_tensors
from .decode import GraphRun, bucket_capacity, cache_name, compute_dtype, \
    model_device
from .quant import QuantKV, raw

_NEG = -1e30


def _cache_tensors(caches):
    for kv in caches:
        for c in kv:
            yield from (c if isinstance(c, QuantKV) else (c,))


class BeamGraph:
    """One bucket of ``beam_generate``: the beam step as a
    :class:`~.decode.GraphRun` over the held beam state."""

    def __init__(self, model, b, k, capacity, n_new, eos_id, alpha,
                 cache_dtype):
        dev = model_device(model)
        self.model, self.b, self.k = model, b, k
        self.eos_id, self.alpha = eos_id, alpha
        self.capacity = capacity
        self.caches = model.init_caches(b * k, capacity, dtype=cache_dtype)
        long = dict(dtype=torch.long, device=dev)
        self.tok = torch.zeros(b, k, **long)
        self.scores = torch.zeros(b, k, dtype=torch.float32, device=dev)
        self.alive = torch.ones(b, k, dtype=torch.bool, device=dev)
        self.lens = torch.ones(b, k, **long)
        self.buf = torch.zeros(b, k, n_new, **long)
        self.pos = torch.zeros((), **long)
        self.j = torch.zeros((), **long)
        self.run = GraphRun(
            "beam_step", self._step,
            (self.caches, self.tok, self.scores, self.alive, self.lens,
             self.buf, self.pos, self.j), dev, False)

    def _lp(self, lens):
        # the GNMT normaliser; alpha 0 gives exactly 1.0
        return ((5.0 + lens.to(torch.float32)) / 6.0) ** self.alpha

    def _step(self, state, generator):
        caches, tok, scores, alive, lens, buf, pos, j = state
        b, k = self.b, self.k
        logits, _ = self.model.decode_step(tok.reshape(b * k), caches, pos)
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1) \
            .reshape(b, k, v)
        if self.eos_id is not None:
            # a finished beam's only continuation is eos at +0
            frozen = torch.full((v,), _NEG, device=logp.device)
            frozen[self.eos_id] = 0.0
            logp = torch.where(alive[:, :, None], logp, frozen)
        cand = (scores[:, :, None] + logp).reshape(b, k * v)
        denom = self._lp(lens + alive.to(torch.long))
        rank = (cand.reshape(b, k, v) / denom[:, :, None]).reshape(b, k * v)
        idx = torch.topk(rank, k, dim=1).indices
        new_scores = torch.gather(cand, 1, idx)
        beam = idx // v
        new_tok = idx % v
        rows = (torch.arange(b, device=idx.device)[:, None] * k
                + beam).reshape(-1)
        for c in _cache_tensors(caches):
            c.copy_(c.index_select(0, rows))
        n_new = buf.shape[2]
        new_buf = torch.gather(buf, 1, beam[:, :, None].expand(b, k, n_new))
        new_buf.index_copy_(2, j.reshape(1) + 1, new_tok[:, :, None])
        src_alive = torch.gather(alive, 1, beam)
        lens.copy_(torch.gather(lens, 1, beam) + src_alive.to(torch.long))
        if self.eos_id is not None:
            src_alive = src_alive & (new_tok != self.eos_id)
        alive.copy_(src_alive)
        scores.copy_(new_scores)
        tok.copy_(new_tok)
        buf.copy_(new_buf)
        pos.add_(1)
        j.add_(1)

    def generate(self, prompt, n_new, eager=False):
        """Prefill, fan out, then ``n_new - 1`` steps (with ``eager``
        the un-captured step); returns ``(B, P + n_new)``."""
        model, b, k = self.model, self.b, self.k
        p = prompt.shape[1]
        with torch.no_grad():
            caches = model.init_caches(b, self.capacity,
                                       dtype=_dtype_of(self.caches))
            logits, caches = model.prefill(prompt, caches)
            for held, c in zip(_cache_tensors(self.caches),
                               _cache_tensors(caches)):
                held.copy_(c.repeat_interleave(k, dim=0))
            del caches
            logp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
            top = torch.topk(logp, k, dim=1)
            self.scores.copy_(top.values)
            self.tok.copy_(top.indices)
            if self.eos_id is not None:
                self.alive.copy_(top.indices != self.eos_id)
            else:
                self.alive.fill_(True)
            self.lens.fill_(1)
            self.buf.zero_()
            self.buf[:, :, 0].copy_(top.indices)
            self.pos.fill_(p)
            self.j.zero_()
        run = self.run
        run.start(None)
        for t in range(p, p + n_new - 1):
            if t >= self.capacity:
                raise ValueError(f"beam position {t} is past the capacity "
                                 f"{self.capacity}")
            run.step(eager)
        run.finish(eager)
        with torch.no_grad():
            best = torch.argmax(self.scores / self._lp(self.lens), dim=1)
            seq = torch.gather(
                self.buf, 1, best[:, None, None].expand(b, 1, n_new))[:, 0]
            return torch.cat([prompt, seq], dim=1)


def _dtype_of(caches):
    c = caches[0][0]
    return "int8" if isinstance(c, QuantKV) else c.dtype


def beam_generate(model, prompt_ids, max_new_tokens, num_beams, eos_id=None,
                  length_penalty=0.0, cache_dtype=None, mesh=None):
    """Beam-search continuation of ``prompt_ids (B, P)``: the best beam an
    item, ``(B, P + max_new_tokens)``.  ``num_beams=1`` is greedy
    ``generate``.  ``length_penalty`` is the GNMT exponent (0 ranks by the
    raw summed log-probs); ``cache_dtype`` follows ``generate``
    (``"int8"`` for the quantized KV cache); ``mesh`` is taken at its
    default and refused otherwise."""
    accept_defaults("beam_generate: sharded decode (mesh)", PARALLEL,
                    mesh=(mesh, None))
    b, p = prompt_ids.shape
    k = int(num_beams)
    if k < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    s_total = p + max_new_tokens
    if s_total > model.max_positions:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_positions {model.max_positions}")
    missing = [a for a in ("init_caches", "prefill", "decode_step")
               if not hasattr(model, a)]
    if missing:
        raise ValueError(
            f"beam_generate needs model.{missing[0]} (the GPT/Llama "
            f"cache protocol)")
    vocab = getattr(model, "vocab_size", None) or raw(model.tok_emb).shape[0]
    if k > vocab:
        raise ValueError(f"num_beams ({k}) exceeds vocab ({vocab})")
    if eos_id is not None and not 0 <= eos_id < vocab:
        raise ValueError(f"eos_id {eos_id} out of vocab range {vocab}")
    if length_penalty < 0.0:
        raise ValueError(
            f"length_penalty must be >= 0, got {length_penalty}")
    if cache_dtype is None:
        cache_dtype = compute_dtype(model)
    alpha = float(length_penalty)
    cap = bucket_capacity(s_total, model.max_positions)
    graph = compiled_run_cache(
        model, "_beam_jit_cache",
        (b, cap, max_new_tokens, k, eos_id, alpha, cache_name(cache_dtype)),
        model_tensors(model),
        lambda: BeamGraph(model, b, k, cap, max_new_tokens, eos_id, alpha,
                           cache_dtype))
    prompt = prompt_ids.to(device=model_device(model), dtype=torch.long)
    return graph.generate(prompt, max_new_tokens)
