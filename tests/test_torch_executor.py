"""The port's runtime executor, step cache and prefetcher
(``apex_tpu_torch/runtime``) against ``apex_tpu/runtime``, on the CPU.

On the card the executor captures a step's second call as a CUDA graph and
replays it (``chip_smoke.py`` holds each replay bit for bit against the
un-captured step); here, without a card, the same static-buffer body runs
eagerly on every call, with the same counting.  So these tests hold:

* the port's ``step_cache.stats()`` deltas equal the JAX package's for the
  same calls: one compile and N dispatches a window, a new batch shape a
  second compile, ``accum_steps`` in the key, the LRU cap;
* the static-buffer step equals the plain step (``_raw_step_fn``) bit for
  bit over changing batches at dropout 0.1, and each call's loss is its
  own;
* ``Executor.drive`` copies one window a transfer, respects ``max_steps``
  and gives the plain loop's losses; ``DataPrefetcher`` normalises as the
  JAX one does;
* a capture that fails raises, then and on every later call, and the
  program never runs eagerly in its place;
* the knobs and refusals (``gather`` overlap, shardings) and the
  telemetry drain of a step without telemetry.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.nn import functional as JF
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.runtime import DataPrefetcher as JaxDataPrefetcher
from apex_tpu.runtime import executor as jax_rex
from apex_tpu.runtime import step_cache as jax_step_cache
from apex_tpu.runtime.step_cache import StepCache as JaxStepCache
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.models import from_jax_state_dict, gpt
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.runtime import (DataPrefetcher, data, executor,
                                    step_cache)
from apex_tpu_torch.runtime.step_cache import StepCache
from apex_tpu_torch.training import make_train_step
from torch_products import value_products

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh():
    for sc in (step_cache, jax_step_cache):
        sc.clear()
        sc.reset_stats()
    data.reset_counts()
    yield
    for sc in (step_cache, jax_step_cache):
        sc.clear()
        sc.reset_stats()


def _pair(seed=7):
    jnn.manual_seed(seed)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    tm = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                             torch.nn.Linear(32, 4))
    from_jax_state_dict(tm, {k: np.asarray(v)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _jax_loss(o, t):
    return JF.cross_entropy(o, t)


def _loss(o, t):
    return torch.nn.functional.cross_entropy(o, t)


def _batches(seed, n, b=8):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((b, 16)).astype(np.float32),
             r.integers(0, 4, (b,))) for _ in range(n)]


def _counters(stats):
    keep = ("compiles", "cache_hits", "dispatches", "programs")
    return ({k: stats[k] for k in keep},
            stats["by_kind"].get("train_step"))


def test_stats_equal_the_jax_step_caches_for_the_same_calls():
    """1 compile and N dispatches a window; a new batch shape compiles
    again; a K = 4 stacked step is a program of its own."""
    jm, tm = _pair()
    js = jax_make_train_step(jm, JaxFusedSGD(list(jm.parameters()), lr=0.05),
                             _jax_loss, half_dtype=None, loss_scale=1.0)
    ts = make_train_step(tm, FusedSGD(list(tm.parameters()), lr=0.05),
                         _loss, half_dtype=None, loss_scale=1.0)
    seen = []
    for b, n in ((8, 3), (4, 2)):
        for x, y in _batches(b, n, b=b):
            js(jnp.asarray(x), jnp.asarray(y))
            ts(torch.from_numpy(x), torch.from_numpy(y))
        seen.append((_counters(jax_step_cache.stats()),
                     _counters(step_cache.stats())))
    jm2, tm2 = _pair(seed=8)
    js4 = jax_make_train_step(jm2, JaxFusedSGD(list(jm2.parameters()),
                                               lr=0.05),
                              _jax_loss, half_dtype=None, loss_scale=1.0,
                              accum_steps=4, accum_stacked=True)
    ts4 = make_train_step(tm2, FusedSGD(list(tm2.parameters()), lr=0.05),
                          _loss, half_dtype=None, loss_scale=1.0,
                          accum_steps=4, accum_stacked=True)
    r = np.random.default_rng(3)
    xb = r.standard_normal((4, 4, 16)).astype(np.float32)
    yb = r.integers(0, 4, (4, 4))
    for _ in range(3):
        js4(jnp.asarray(xb), jnp.asarray(yb))
        ts4(torch.from_numpy(xb), torch.from_numpy(yb))
    seen.append((_counters(jax_step_cache.stats()),
                 _counters(step_cache.stats())))
    for want, got in seen:
        assert got == want
    assert seen[-1][1][1] == {"compiles": 3, "cache_hits": 5,
                              "dispatches": 8}


def _cache_calls(cache, make_args, keep):
    """a, b, a, c (evicts b at cap 2), b again; the stats after each."""
    out = []
    for key in "abacb":
        cache.program("train_step", ("k", key), make_args(),
                      lambda: keep.append(object()) or _Held(keep))
        s = cache.stats()
        out.append((s["compiles"], s["cache_hits"], s["programs"]))
    return out


class _Held:
    """A built entry, kept alive by the test (the port's cache holds it
    weakly, as a program holds its graphs)."""

    def __init__(self, keep):
        keep.append(self)


def test_lru_cap_counts_as_the_jax_cache_does():
    keep = []
    jax_cache = JaxStepCache(cap=2, metrics_prefix="test_torch_executor.")
    want = _cache_calls(jax_cache, lambda: (jnp.ones(3),), [])
    got = _cache_calls(StepCache(cap=2), lambda: (torch.ones(3),), keep)
    assert got == want
    # an entry whose holder is gone is built (and counted) again
    cache = StepCache(cap=4)
    held = []
    cache.program("train_step", "x", (torch.ones(2),),
                  lambda: _Held(held))
    held.clear()
    cache.program("train_step", "x", (torch.ones(2),),
                  lambda: _Held(held))
    assert cache.stats()["compiles"] == 2
    # the strides are part of the signature: another memory format is
    # another entry
    a = torch.ones(2, 3, 4, 4)
    cache.program("train_step", "y", (a,), lambda: _Held(held))
    cache.program("train_step", "y",
                  (a.contiguous(memory_format=torch.channels_last),),
                  lambda: _Held(held))
    assert cache.stats()["compiles"] == 4


def _tiny_gpt(seed):
    torch.manual_seed(seed)
    return gpt.GptModel(vocab_size=64, hidden=32, layers=2, heads=2,
                        max_positions=16, dropout=0.1, attn_dropout=0.1,
                        device="cpu")


def _lm_loss(logits, ids):
    return torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]).float(),
        ids[:, 1:].reshape(-1))


@pytest.mark.parametrize("kw", [{}, dict(accum_steps=2)],
                         ids=["k1", "accum2"])
def test_the_static_buffer_step_is_the_plain_step_bit_for_bit(kw):
    """Through the executor (static input buffers, the state written back
    in place, the dropout generators re-seeded each call) against
    ``_raw_step_fn`` from the same weights, over three changing batches at
    dropout 0.1: every loss and state tensor equal, each loss its own."""
    model = _tiny_gpt(3)

    def make():
        return make_train_step(model, FusedAdam(list(model.parameters()),
                                                lr=1e-2),
                               _lm_loss, half_dtype=torch.bfloat16,
                               loss_scale="dynamic", **kw)
    step, raw = make(), make()
    ids = [torch.from_numpy(np.random.default_rng(s).integers(0, 64, (4, 16)))
           for s in range(3)]
    first = step.state.master_params[0]
    # the two steps' products alike (a CPU BLAS may give other bits for the
    # same values at other addresses; tests/torch_products.py)
    with value_products():
        got = [step(x, x) for x in ids]
        want = [raw._raw_step_fn(raw.state, i, x, x)[1]
                for i, x in enumerate(ids)]
    assert [float(v) for v in got] == [float(v) for v in want]
    assert len({float(v) for v in got}) == 3
    assert len({v.data_ptr() for v in got}) == 3
    from torch.utils._pytree import tree_leaves
    a = [t for t in tree_leaves(step.state) if isinstance(t, torch.Tensor)]
    b = [t for t in tree_leaves(raw.state) if isinstance(t, torch.Tensor)]
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(step.state.step) == 3
    assert step.graph_stats()["entries"] == 1
    # the state is updated in place, never rebound
    assert step.state.master_params[0] is first


def _drive_pair(accum):
    jm, tm = _pair()
    kw = dict(accum_steps=accum, accum_stacked=True) if accum > 1 else {}
    js = jax_make_train_step(jm, JaxFusedSGD(list(jm.parameters()), lr=0.05),
                             _jax_loss, half_dtype=None, loss_scale=1.0, **kw)
    ts = make_train_step(tm, FusedSGD(list(tm.parameters()), lr=0.05), _loss,
                         half_dtype=None, loss_scale=1.0, **kw)
    return js, ts


def test_drive_copies_one_window_a_transfer_and_keeps_each_loss():
    js, ts = _drive_pair(4)
    batches = _batches(5, 20)
    executor.set_overlap(h2d=True)
    jax_rex.set_overlap(h2d=True)
    try:
        got = executor.executor.drive(ts, batches, accum_steps=4,
                                      device="cpu")
        want = jax_rex.executor.drive(js, batches, accum_steps=4)
    finally:
        executor.set_overlap(h2d="auto")
        jax_rex.set_overlap(h2d="auto")
    assert data.COUNTS["h2d"] == 5 == len(got) == len(want)
    assert _counters(step_cache.stats()) == \
        _counters(jax_step_cache.stats())
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-5)
    # the plain loop over the same stacked blocks, bit for bit
    _, ts2 = _drive_pair(4)
    ref = []
    for w in range(5):
        blk = batches[4 * w:4 * w + 4]
        ref.append(float(ts2(torch.from_numpy(np.stack([b[0] for b in blk])),
                             torch.from_numpy(np.stack([b[1] for b in blk])))))
    assert [float(v) for v in got] == ref
    assert len(set(ref)) == 5


def test_drive_respects_max_steps_and_picks_the_depth():
    _, ts = _drive_pair(1)
    losses = executor.executor.drive(ts, _batches(6, 10), max_steps=3,
                                     device="cpu")
    assert len(losses) == 3
    assert step_cache.kind_stats("train_step")["dispatches"] == 3
    made = []

    class Recording(DataPrefetcher):
        def __init__(self, loader, **kw):
            made.append(kw["depth"])
            super().__init__(loader, **kw)
    for mode, depth in ((True, 2), (False, 1)):
        executor.set_overlap(h2d=mode)
        try:
            orig = data.DataPrefetcher
            data.DataPrefetcher = Recording
            executor.executor.drive(ts, _batches(7, 2), device="cpu")
        finally:
            data.DataPrefetcher = orig
            executor.set_overlap(h2d="auto")
        assert made[-1] == depth


@pytest.mark.parametrize("channels_last,accum", [(False, 1), (True, 1),
                                                 (False, 3)])
def test_prefetcher_normalises_as_the_jax_one(channels_last, accum):
    r = np.random.default_rng(8)
    batches = [(r.integers(0, 256, (2, 6, 5, 3), np.uint8),
                r.integers(0, 10, (2,))) for _ in range(6)]
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
    got = list(DataPrefetcher(batches, mean=mean, std=std, device="cpu",
                              channels_last=channels_last,
                              accum_steps=accum))
    jp = JaxDataPrefetcher(batches, mean=mean, std=std,
                           channels_last=channels_last, accum_steps=accum)
    want = list(jp)
    jp.close()
    assert len(got) == len(want) == 6 // accum
    for (x, y), (wx, wy) in zip(got, want):
        assert tuple(x.shape) == np.asarray(wx).shape
        np.testing.assert_allclose(x.numpy(), np.asarray(wx), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(y.numpy(), np.asarray(wy))
    half = DataPrefetcher(batches, half_dtype=torch.bfloat16, device="cpu")
    x, _ = half.next()
    assert x.dtype == torch.bfloat16 and x.shape == (2, 3, 6, 5)
    for _ in range(5):
        half.next()
    assert half.next() == (None, None) and half.next() == (None, None)
    half.close()


class _FakeStream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


def _stub_cuda(monkeypatch, graph_context, graph_cls):
    for name, value in (("current_stream", lambda *a: _FakeStream()),
                        ("Stream", lambda *a: _FakeStream()),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("graph_pool_handle", lambda: None),
                        ("CUDAGraph", graph_cls), ("graph", graph_context),
                        ("synchronize", lambda *a: None),
                        ("memory_reserved", lambda *a: 0),
                        ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, value)


def test_a_capture_holds_the_cached_tensors_it_reads(monkeypatch):
    """A graph bakes in the addresses of the multi-tensor kernels' cached
    scalar vectors and chunk tables, which live in process-wide LRUs of 64
    entries that a replay (no Python) never refreshes.  The executor's card
    path with the CUDA calls stubbed: the capture's entry holds every
    cached tensor the captured program read, so after 65 later insertions
    evict them from both caches the tensors (the memory the graph reads)
    are still alive and unchanged.  The warm-up holds nothing."""
    from apex_tpu_torch.kernels import multi_tensor as mt
    ps = [torch.ones(5), torch.ones(300)]
    read = []

    def fn(x):
        read.append((mt.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 7, True, 0.01,
                                     "cpu"),
                     mt._table(ps, ps, None, 64)[0]))

    class Graph:
        def __init__(self, keep_graph=False):
            pass

        def register_generator_state(self, g):
            pass

        def instantiate(self):
            pass

        def replay(self):
            pass
    _stub_cuda(monkeypatch, lambda graph, pool=None: contextlib.nullcontext(),
               Graph)
    prog = executor.Program("train_step", ("holds",), fn)
    x = torch.ones(3)
    entry = executor.executor.compile(prog, (x,))
    entry.cuda = True
    executor.executor.submit(prog, (x,))
    assert entry._kept == []            # the eager warm-up holds nothing
    executor.executor.submit(prog, (x,))
    assert entry.captures == 1
    scal, table = read[-1]
    assert [id(t) for t in entry._kept] == [id(scal), id(table)]
    want_scal, want_table = scal.clone(), table.clone()
    others = [torch.ones(n) for n in range(1, 66)]
    for i in range(65):
        # a host int step: a new scalar key a call, as an eager FusedAdam's
        mt.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 100 + i, True, 0.01, "cpu")
        mt._table([others[i]], [others[i]], None, 64)
    assert all(t is not scal for t in mt._SCALARS.values())
    assert all(t is not table for t, _ in mt._TABLES.values())
    assert torch.equal(entry._kept[0], want_scal)
    assert torch.equal(entry._kept[1], want_table)
    executor.executor.submit(prog, (x,))     # a replay: no Python runs
    assert len(read) == 2 and entry.replays == 2


def test_a_failed_capture_raises_and_nothing_runs_eagerly(monkeypatch):
    """The executor's card path with the CUDA calls stubbed: the first
    call runs the program (its eager warm-up), the capture fails and
    raises, and every later call raises without running the program."""
    calls = []

    def fn(x):
        calls.append(1)

    @contextlib.contextmanager
    def failing_graph(graph, pool=None):
        yield
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    class Graph:
        def __init__(self, keep_graph=False):
            pass

        def register_generator_state(self, g):
            pass
    _stub_cuda(monkeypatch, failing_graph, Graph)
    prog = executor.Program("train_step", ("fails",), fn)
    x = torch.ones(3)
    executor.executor.compile(prog, (x,)).cuda = True
    executor.executor.submit(prog, (x,))
    assert calls == [1]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="does not run eagerly|"
                                               "capture failed"):
            executor.executor.submit(prog, (x,))
    assert calls == [1, 1]          # the warm-up and the capture only
    assert prog.entries()[0].captures == 0


def test_knobs_and_refusals():
    assert executor.overlap_enabled("h2d") is torch.cuda.is_available()
    executor.set_overlap(h2d=True)
    assert executor.overlap_enabled("h2d")
    assert not executor.overlap_enabled("h2d", override=False)
    executor.set_overlap(h2d="auto")
    assert not executor.overlap_enabled("gather")
    # ZeRO's all-gather prefetch knob is accepted and resolves as set
    executor.set_overlap(gather=True)
    assert executor.overlap_enabled("gather")
    assert not executor.overlap_enabled("gather", override=False)
    executor.set_overlap(gather="auto")
    assert executor.overlap_enabled("gather") is torch.cuda.is_available()
    with pytest.raises(ValueError, match="True/False/'auto'"):
        executor.set_overlap(h2d="on")
    # the telemetry drain is ported (A8): a step without telemetry has
    # nothing to drain
    from types import SimpleNamespace
    assert executor.drain_telemetry(SimpleNamespace(
        state=SimpleNamespace(telem=None), calls=0)) is None
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        executor.Program("train_step", (), lambda: None, wrap=lambda f: f)
    # the state is always updated in place: donation is on, and a request
    # to turn it off is refused, not accepted and ignored
    d = executor.DonationPolicy()
    assert d.enabled is True and d.mode == "auto"
    assert executor.donation.enabled is True
    d.set(True)
    assert d.resolve("auto") and d.resolve(True) and d.mode is True
    with pytest.raises(NotImplementedError, match="in place"):
        d.set(False)
    with pytest.raises(NotImplementedError, match="in place"):
        d.resolve(False)
    with pytest.raises(ValueError):
        d.set("yes")
    assert executor.TRAIN_KINDS == jax_rex.TRAIN_KINDS
    # no graph on the CPU, so nothing to read back
    prog = executor.Program("train_step", ("cpu",), lambda x: x + 1)
    executor.executor.submit(prog, (torch.ones(2),))
    assert executor.graph_dot(prog) == []
