"""Shared fixtures of the port's serve tests: the JAX serve tests' tiny
GPT (vocab 73, hidden 32, 2 layers, 4 heads) in the JAX package and its
copy in the port (weights carried by ``from_jax_state_dict``), the seeded
traces, and the JAX serve engine's results on them.

Most of a JAX engine's cost on the CPU is compiling its bucket programs,
so each reference runs once a process (``functools.cache``): one JAX
engine a geometry serves several traces and a PagedSession, and the port's
arms are all held against those results.  Each reference empties the JAX
step cache it filled (``apex_tpu.runtime.step_cache.clear()``), so the
files that run after it in the process find that cache as it was."""
import functools

import numpy as np

import apex_tpu.nn as jnn
from apex_tpu.models.gpt import GptModel as JaxGpt

from apex_tpu_torch.models import GptModel, from_jax_state_dict

from torch_decode_pairs import sd

CFG = dict(vocab_size=73, hidden=32, layers=2, heads=4, max_positions=96,
           dropout=0.0, attn_dropout=0.0)
PROMPTS = [[5, 9, 11, 3], [7, 2], [1, 2, 3, 4, 5, 6, 7, 8, 9], [12, 30, 4]]
MAX_NEW = 6
#: 16 tokens = 2 full blocks at block_size 8: a repeat is a full-chain hit
SHARED = list(range(1, 17))
#: the PagedSession turns (tokens appended, tokens generated)
TURNS = (([5, 9, 11, 3], 5), ([8, 8, 2], 4))
#: the engine geometry of most tests
GEOM = dict(num_blocks=64, block_size=8, max_batch=4, prefill_chunk=4)
#: the small-block geometry whose pool preempts
DRY = dict(num_blocks=9, block_size=4, max_batch=4, prefill_chunk=4)


def gpt_tiny(seed=6):
    """A fresh JAX tiny GPT and its port copy (eval mode, CPU)."""
    jnn.manual_seed(seed)
    jm = JaxGpt(**CFG)
    jm.eval()
    tm = from_jax_state_dict(GptModel(**CFG, device="cpu").eval(), sd(jm))
    return jm, tm


@functools.cache
def models():
    """The shared pair (seed 6, the JAX serve tests'); tests must not
    change its weights."""
    return gpt_tiny()


def prompt_reqs(request_cls, prefix="r", prompts=PROMPTS, max_new=MAX_NEW):
    return [request_cls(f"{prefix}{i}", p, max_new)
            for i, p in enumerate(prompts)]


def prefix_trace(request_cls):
    """Three requests over one shared prefix: two suffix extensions
    (partial hits) and one exact block-aligned repeat (a full hit, a
    copy-on-write fork), arriving 6 ticks apart."""
    return ([request_cls("x0", SHARED + [20], 6),
             request_cls("x1", SHARED + [21, 22], 6),
             request_cls("x2", SHARED, 6)], [0, 6, 12])


def dry_reqs(request_cls, width):
    """Six requests of ``width`` tokens through a pool too small for all."""
    base = [5, 7, 9][:width - 1]
    return [request_cls(f"q{width}_{i}", [3 + i] + base, 8)
            for i in range(6)]


def _events(obs):
    """The ``serve.request`` lifecycle events without their timestamps."""
    return [{k: v for k, v in e.items() if k != "ts_ms"}
            for e in obs.events("serve.request")]


def _paged(session_cls, eng, turns):
    """A PagedSession's append / generate turns: each turn's last logits
    (numpy) and generated tokens."""
    out = []
    with session_cls(eng) as s:
        for toks, n in turns:
            lg = s.append(toks)
            out.append((np.asarray(lg, np.float32),
                        np.asarray(s.generate(n)).reshape(-1).tolist()))
    return out


def jax_refs(cache_dtype=None):
    """The JAX engine at GEOM (``cache_dtype`` None or ``"int8"``) over, in
    turn: the PROMPTS trace (its tokens, its lifecycle events, the keys of
    its ``metrics()``), the prefix trace, and PagedSessions: the TURNS,
    then SHARED with 6 new tokens and SHARED + [20, 21] with 4."""
    return _jax_refs(cache_dtype)


@functools.cache
def _jax_refs(cache_dtype):
    from apex_tpu.inference.session import PagedSession
    from apex_tpu.observe import registry as obs
    from apex_tpu.runtime import step_cache
    from apex_tpu.serve import Request, ServeEngine
    jm, _ = models()
    eng = ServeEngine(jm, cache_dtype=cache_dtype, **GEOM)
    # the serve metrics of this run alone: another test in the process may
    # have left others (a speculative engine's histogram)
    obs.get_registry().clear_events()
    obs.get_registry().remove("serve.")
    out = dict(prompts=eng.run(prompt_reqs(Request)))
    out["events"] = _events(obs)
    m = eng.metrics()
    out["metrics_keys"] = {k: sorted(v) if isinstance(v, dict) else None
                           for k, v in m.items()}
    reqs, arrivals = prefix_trace(Request)
    got = eng.run(reqs, arrivals=[a + eng.tick for a in arrivals])
    out["prefix"] = {r.rid: got[r.rid] for r in reqs}
    out["turns"] = _paged(PagedSession, eng, TURNS)
    out["shared"] = _paged(PagedSession, eng, [(SHARED, 6)])
    out["extended"] = _paged(PagedSession, eng, [(SHARED + [20, 21], 4)])
    eng.close()
    step_cache.clear()
    return out


@functools.cache
def jax_dry_refs():
    """The JAX engine at DRY over both preempting traces (3- and 4-token
    prompts): their tokens, and whether it preempted."""
    from apex_tpu.observe import registry as obs
    from apex_tpu.runtime import step_cache
    from apex_tpu.serve import Request, ServeEngine
    jm, _ = models()
    eng = ServeEngine(jm, **DRY)
    p0 = obs.counter("serve.preemptions").value
    out = {}
    for width in (3, 4):
        out.update(eng.run(dry_reqs(Request, width)))
    out["preempted"] = obs.counter("serve.preemptions").value > p0
    eng.close()
    step_cache.clear()
    return out


@functools.cache
def jax_window_refs():
    """The JAX engine with a sliding window of 8 over one long request."""
    from apex_tpu.runtime import step_cache
    from apex_tpu.serve import Request, ServeEngine
    jm, _ = models()
    eng = ServeEngine(jm, num_blocks=32, block_size=4, max_batch=2,
                      prefill_chunk=4, window=8)
    out = eng.run([Request("w", list(range(1, 20)), 10)])
    eng.close()
    step_cache.clear()
    return out
