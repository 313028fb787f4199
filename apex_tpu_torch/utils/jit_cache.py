"""Per-model cache of compiled decode runs, the PyTorch counterpart of
``apex_tpu/utils/jit_cache.py``, shared by the decode entry points
(``models.gpt.generate``, ``models.seq2seq.seq2seq_generate``,
``inference.beam_generate``, ``inference.speculative_generate``,
``inference.DecodeSession``).

What it caches is a run built once per configuration: on the card an
executor :class:`~apex_tpu_torch.runtime.executor.Program` with its held
state, whose second call is captured as a CUDA graph and replayed from
then on.  The invariants, as in the JAX package:

* the parameter objects' ids are part of the key, so a LoRA apply or
  merge, or ``quantize_int8`` (each swaps parameter objects for others or
  for buffers), misses: a stale hit would replay a graph that reads the
  old weights;
* each entry pins the objects it keyed on, so their ids cannot be recycled
  into false hits while the entry lives;
* pop + reinsert on a hit is an LRU, capped, so dead parameter sets (and
  the graphs and pools that read them) do not accumulate.

Two more, the port's own:

* a graph reads each tensor at the address it had at the capture, so an
  entry also records the objects' data pointers, and a hit whose objects
  have moved (``p.data = ...``, as ``TrainStep.sync_to_objects`` does) is
  dropped and built again;
* unlike a compiled executable, a run keeps device state (KV caches,
  token and logit buffers, its graph's memory pool), so the entries of
  one cache are also bounded by the bytes they hold: past
  :data:`HELD_BYTES` the oldest go, the newest always stays.
  A storage that several entries share counts once.  :func:`held_bytes`
  reports what a model's cache holds.
"""
from __future__ import annotations

import torch

#: the most bytes of device state one model's cache of runs keeps
HELD_BYTES = 2 << 30


def _held(run):
    """``{storage or pool: bytes}`` of what a cached run holds: a run with
    a ``run`` attribute (an ``inference.decode.GraphRun``) holds its state
    and its graph's pool; any other holds nothing."""
    graph_run = getattr(run, "run", None)
    return graph_run.held() if graph_run is not None else {}


def held_bytes(model, attr):
    """The bytes of device state that ``model``'s cache ``attr`` holds,
    each storage counted once."""
    held = {}
    for _, _, run in model.__dict__.get(attr, {}).values():
        held.update(_held(run))
    return sum(held.values())


def compiled_run_cache(model, attr, cfg, pinned_objs, build_fn, cap=16):
    """The cached run for ``cfg``, built with ``build_fn()`` on a miss.

    ``attr``: the name of the dict attribute holding the cache on
    ``model``; ``cfg``: a hashable configuration without the parameter ids
    (appended here); ``pinned_objs``: the parameter and buffer objects the
    run reads, whose ids join the key and which the entry holds; ``cap``:
    the most entries kept (the oldest evicted first), which also hold at
    most :data:`HELD_BYTES` of device state, the newest aside."""
    cache = model.__dict__.get(attr)
    if cache is None:
        cache = {}
        # a plain attribute: not a submodule, parameter or buffer
        object.__setattr__(model, attr, cache)
    key = (*cfg, tuple(id(o) for o in pinned_objs))
    ptrs = tuple(o.data_ptr() if isinstance(o, torch.Tensor) else None
                 for o in pinned_objs)
    entry = cache.pop(key, None)    # pop + reinsert = LRU refresh
    if entry is not None and entry[1] != ptrs:
        entry = None                # the objects moved: a stale graph
    if entry is None:
        while len(cache) >= cap:
            cache.pop(next(iter(cache)))
        # the run's held state is updated in place from any mode, so it
        # must not be made as inference tensors
        with torch.inference_mode(False):
            entry = (list(pinned_objs), ptrs, build_fn())
    cache[key] = entry
    while len(cache) > 1 and held_bytes(model, attr) > HELD_BYTES:
        cache.pop(next(iter(cache)))
    return entry[2]


def model_tensors(model):
    """The objects a decode run of ``model`` reads: its parameters and
    buffers (an int8 weight's values and scales are buffers)."""
    return list(model.parameters()) + list(model.buffers())
