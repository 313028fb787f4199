"""Speculative decoding, the PyTorch counterpart of
``apex_tpu/inference/speculative.py``: a draft model proposes ``k``
tokens, the target verifies them in one ``decode_chunk`` of ``k + 1``.

Greedy (``temperature == 0``): a draft token is accepted iff it equals the
target's own argmax, so the output is ``generate(target)``'s greedy
decode for any draft, up to the floating point of scoring a chunk instead
of one token (an exact argmax tie may resolve otherwise).  The batch runs
in lockstep, advancing every row by the batch's least accepted count.
Sampled (``temperature > 0``, batch 1): the Leviathan et al. rejection
scheme, whose output is distributed as the target's own sampling.

The JAX program is one ``lax.while_loop``.  The port runs a host loop of
rounds: a round (the draft's ``k + 1`` decode steps and the target's
chunk, at positions on the device, the acceptance and the merge into the
token buffer) is one executor program over held state, cached per
(batch, k, capacity, sampler, both models' parameters), so on the card it
replays as one CUDA graph; the host reads one number a round, the
accepted count.  Cache entries past the accepted tokens need no cleanup:
attention masks by position, and a re-fed position overwrites its slot
first (with a rolling cache, ``ROLLING_SLACK`` keeps a rejected write out
of every later band).
"""
from __future__ import annotations

import torch

from .._unported import PARALLEL, accept_defaults
from ..utils.jit_cache import compiled_run_cache, model_tensors
from .decode import GraphRun, bucket_capacity, cache_name, compute_dtype, \
    model_device, sample_probs


class SpeculativeGraph:
    """One bucket of ``speculative_generate``: a round as a
    :class:`~.decode.GraphRun` over ``(target caches, draft caches, ids
    (B, capacity), m ())``; a round returns its accepted count (0-d)."""

    def __init__(self, target, draft, b, k, capacity, t_dtype, d_dtype,
                 temperature):
        dev = model_device(target)
        self.target, self.draft = target, draft
        self.k, self.capacity = k, capacity
        self.temperature = float(temperature)
        self.t_caches = target.init_caches(b, capacity, dtype=t_dtype)
        self.d_caches = draft.init_caches(b, capacity, dtype=d_dtype)
        self.ids = torch.zeros(b, capacity, dtype=torch.long, device=dev)
        self.m = torch.zeros((), dtype=torch.long, device=dev)
        self.run = GraphRun(
            "speculative_round", self._round,
            (self.t_caches, self.d_caches, self.ids, self.m), dev,
            self.temperature > 0.0)

    def _round(self, state, generator):
        t_caches, d_caches, ids, m = state
        k, temp = self.k, self.temperature
        sampled = temp > 0.0
        dev = ids.device
        tok0 = ids.index_select(1, m.reshape(1))           # (B, 1)
        tok, props, d_probs = tok0[:, 0], [], []
        # k + 1 draft steps, so its cache also covers position m + k for
        # a round that accepts every proposal
        for i in range(k + 1):
            logits, _ = self.draft.decode_step(tok, d_caches, m + i)
            if sampled:
                probs = torch.softmax(logits.float() / temp, dim=-1)
                tok = sample_probs(probs, generator)
                d_probs.append(probs)
            else:
                tok = torch.argmax(logits, dim=-1)
            props.append(tok)
        drafts = torch.stack(props[:k], dim=1)              # (B, k)
        t_logits, _ = self.target.decode_chunk(
            torch.cat([tok0, drafts], dim=1), t_caches, m)
        arange = torch.arange(k + 1, device=dev)
        if sampled:
            p_t = torch.softmax(t_logits[0].float() / temp, dim=-1)
            p_d = torch.stack(d_probs)[:, 0]                # (k + 1, V)
            d_row = drafts[0]
            ar = arange[:k]
            ratio = p_t[ar, d_row] / torch.clamp_min(p_d[ar, d_row], 1e-20)
            u = torch.rand(k, generator=generator, device=dev)
            accept = u < torch.clamp_max(ratio, 1.0)
            acc0 = torch.argmin(torch.cat(
                [accept, torch.zeros(1, dtype=torch.bool, device=dev)])
                .to(torch.int32))
            # the residual at 0 .. k-1, the target's own at k (the bonus)
            res = torch.clamp_min(p_t[:k] - p_d[:k], 0.0)
            res_samples = sample_probs(
                torch.cat([res, p_t[k:]], dim=0) + 1e-30, generator)
            emit = torch.where(arange == acc0, res_samples,
                               torch.cat([d_row, d_row[-1:]]))
            merged, n_round = emit[None], acc0 + 1
        else:
            greedy = torch.argmax(t_logits, dim=-1)         # (B, k + 1)
            agree = drafts == greedy[:, :k]
            acc = torch.argmin(torch.cat(
                [agree, torch.zeros_like(agree[:, :1])], dim=1)
                .to(torch.int32), dim=1)
            merged, n_round = greedy, torch.min(acc) + 1
        idx = m + 1 + arange
        merged = torch.where(arange[None] < n_round, merged,
                             ids.index_select(1, idx))
        ids.index_copy_(1, idx, merged)
        m.add_(n_round)
        return n_round

    def generate(self, prompt, max_new_tokens, generator=None, eager=False):
        """Prefill both models, then rounds until the buffer holds
        ``P + max_new_tokens`` tokens: ``(ids, rounds)``."""
        target, draft, k = self.target, self.draft, self.k
        b, p = prompt.shape
        s_total = p + max_new_tokens
        with torch.no_grad():
            self.ids[:, :p].copy_(prompt)
            if p > 1:
                t_logits, _ = target.prefill(prompt, self.t_caches)
                draft.prefill(prompt, self.d_caches)
            else:
                t_logits, _ = target.decode_chunk(prompt, self.t_caches, 0)
                draft.decode_chunk(prompt, self.d_caches, 0)
            last = t_logits[:, -1]
            if self.temperature > 0.0:
                first = sample_probs(
                    torch.softmax(last.float() / self.temperature, dim=-1),
                    generator)
            else:
                first = torch.argmax(last, dim=-1)
            self.ids[:, p].copy_(first)
            self.m.fill_(p)
        run = self.run
        run.start(generator)
        m, rounds = p, 0
        while m < s_total - 1:
            if m + k + 2 > self.capacity:
                raise ValueError(f"speculative round at {m} (k {k}) is past "
                                 f"the capacity {self.capacity}")
            m = min(m + int(run.step(eager)), s_total - 1)
            rounds += 1
        run.finish(eager)
        return self.ids[:, :s_total].clone(), rounds


def speculative_generate(target, draft, prompt_ids, max_new_tokens, k=4,
                         cache_dtype=None, temperature=0.0, generator=None,
                         mesh=None, return_stats=False):
    """Decode of ``target`` accelerated by ``draft`` proposals:
    ``prompt_ids (B, P)`` -> ``(B, P + max_new_tokens)``.

    ``temperature == 0``: greedy, ``generate(target)``'s tokens for any
    draft.  ``k`` proposals a round; each round accepts 1 .. k + 1 tokens.
    ``temperature > 0``: sampled speculative decoding (batch 1, needs
    ``generator``).  ``return_stats`` also returns ``{"rounds",
    "tokens_per_round", "draft_acceptance"}``.  ``mesh`` is taken at its
    default and refused otherwise."""
    from .rolling import ROLLING_SLACK
    accept_defaults("speculative_generate: sharded decode (mesh)", PARALLEL,
                    mesh=(mesh, None))
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    sampled = temperature > 0.0
    if sampled and generator is None:
        raise ValueError("sampled speculative decoding (temperature > 0) "
                         "needs a torch.Generator")
    if sampled and prompt_ids.shape[0] != 1:
        raise ValueError(
            "sampled speculative decoding supports batch 1 (lockstep "
            "re-feeding would resample committed tokens)")
    for name, m in (("target", target), ("draft", draft)):
        missing = [a for a in ("init_caches", "decode_step",
                               "decode_chunk", "prefill")
                   if not hasattr(m, a)]
        if missing:
            raise ValueError(
                f"speculative_generate needs {name}.{missing[0]} "
                f"(the GPT/Llama cache protocol: init_caches, "
                f"decode_step, decode_chunk, prefill)")
        if getattr(m, "sliding_window", None) is not None \
                and k + 1 > ROLLING_SLACK:
            raise ValueError(
                f"speculative k={k} with a sliding-window {name}: "
                f"rejected chunks up to k+1 tokens must fit the "
                f"rolling cache's rewind margin "
                f"(ROLLING_SLACK={ROLLING_SLACK}, "
                f"inference/rolling.py) — use k <= {ROLLING_SLACK - 1}")
    b, p = prompt_ids.shape
    if p < 1:
        raise ValueError("prompt must hold at least one token")
    s_total = p + max_new_tokens
    # a round writes up to k + 1 positions past the last one needed
    s_buf = s_total + k + 1
    for name, m in (("target", target), ("draft", draft)):
        if s_buf > m.max_positions:
            raise ValueError(
                f"{name}.max_positions ({m.max_positions}) < prompt + "
                f"max_new_tokens + k + 1 ({s_buf}) — speculative "
                f"verification needs k+1 slack positions")
    t_dtype = cache_dtype or compute_dtype(target)
    d_dtype = cache_dtype or compute_dtype(draft)
    cap = bucket_capacity(s_buf, min(target.max_positions,
                                     draft.max_positions))
    graph = compiled_run_cache(
        target, "_spec_jit_cache",
        (id(draft), b, cap, k, float(temperature), cache_name(t_dtype),
         cache_name(d_dtype)),
        model_tensors(target) + model_tensors(draft),
        lambda: SpeculativeGraph(target, draft, b, k, cap, t_dtype, d_dtype,
                                 temperature), cap=8)
    prompt = prompt_ids.to(device=model_device(target), dtype=torch.long)
    ids, rounds = graph.generate(prompt, max_new_tokens, generator)
    if return_stats:
        # the first new token comes from the prefill, so the rounds make
        # max_new_tokens - 1; the last round's clamp makes this a floor
        tpr = (max_new_tokens - 1) / max(rounds, 1)
        return ids, {"rounds": rounds, "tokens_per_round": tpr,
                     "draft_acceptance": (tpr - 1.0) / k if k else 0.0}
    return ids
