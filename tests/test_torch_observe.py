"""The port's observe runtime (``apex_tpu_torch/observe``) against the JAX
package's ``tests/test_observe.py``, on the CPU: spans, the on-device
telemetry accumulator (the drained gradient norm bit for bit against the
port's eager recompute and within fp32 tolerance of the JAX step's drained
record on the same weights and data; one compile and one dispatch a
window; the drain's one read and its reset in place), the stall watchdog
over the train step and the serve loop, the chaos mirror, the step cache's
counters in the registry, and the package's exports and catalog against
the JAX package's."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import apex_tpu.nn as jnn
from apex_tpu import observe as jax_observe
from apex_tpu.nn import functional as jax_F
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch import observe
from apex_tpu_torch.models import from_jax_state_dict
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.observe import (SCHEMA_VERSION, StallWatchdog,
                                    get_registry, heartbeat, last_span,
                                    span, telemetry)
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.runtime import chaos, executor, step_cache
from apex_tpu_torch.training import make_train_step

from torch_decode_pairs import sd
from torch_products import value_products

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    """Empty the JAX step cache after the module (its LRU is shared by
    the files that run after this one)."""
    from apex_tpu.runtime import step_cache as jax_step_cache
    yield
    jax_step_cache.clear()


@pytest.fixture(autouse=True)
def _no_leftover_controller():
    yield
    chaos.uninstall()


def _jax_mlp(seed=0, din=8, hidden=16, dout=4):
    """``tests/test_observe.py``'s MLP."""
    jnn.manual_seed(seed)
    return jnn.Sequential(jnn.Linear(din, hidden), jnn.ReLU(),
                          jnn.Linear(hidden, dout))


def _port_mlp(seed=0, din=8, hidden=16, dout=4):
    """The port's twin on the JAX MLP's weights."""
    jm = _jax_mlp(seed, din, hidden, dout)
    tm = torch.nn.Sequential(torch.nn.Linear(din, hidden), torch.nn.ReLU(),
                             torch.nn.Linear(hidden, dout))
    return jm, from_jax_state_dict(tm, sd(jm))


def _data(n=4, din=8, dout=4, seed=0):
    """``tests/test_observe.py``'s data, as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, din)).astype(np.float32),
            rng.integers(0, dout, (n,)))


def _ce(o, t):
    return F.cross_entropy(o, t)


def _port_step(model, **kw):
    opt = FusedSGD(list(model.parameters()), lr=0.1, momentum=0.9)
    return make_train_step(model, opt, _ce, **kw)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_emits_event_histogram_and_last_span():
    reg = get_registry()
    reg.clear_events()
    with span("test.region", phase="fwd"):
        pass
    (ev,) = [e for e in reg.events("span") if e["span"] == "test.region"]
    assert ev["phase"] == "fwd" and ev["dur_ms"] >= 0
    assert ev["schema"] == SCHEMA_VERSION
    assert last_span()["span"] == "test.region"
    assert reg.histogram("span.test.region_ms").count >= 1


def test_span_opens_a_profiler_range_only_while_one_records():
    """Under ``torch.profiler`` the span is a ``record_function`` range of
    its name; with no profiler on, no range is opened (and on the CPU no
    NVTX range either)."""
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch.observe import spans
    with span("test.unprofiled"):
        assert not spans._profiling()
    assert spans._nvtx_module() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("test.profiled", k=1):
            torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "test.profiled" in names and "test.unprofiled" not in names


# ---------------------------------------------------------------------------
# the on-device telemetry accumulator
# ---------------------------------------------------------------------------


def test_drained_grad_norm_bitwise_and_against_the_jax_record():
    """At a static scale of 1.0 the master gradients are the raw fp32
    gradients: the drained norm equals, bit for bit, the port's eager
    recompute over the same forward from the pre-step masters, through the
    one helper of the sum's order (``telemetry.global_grad_norm``); and the
    JAX step's drained record on the same weights and data within fp32
    tolerance (the two sum in other orders)."""
    jm, tm = _port_mlp()
    xn, yn = _data()
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    reg = get_registry()
    reg.clear_events()
    step = _port_step(tm, half_dtype=None, loss_scale=1.0, telemetry=True,
                      drain_every=1)
    names = [n for n, _ in tm.named_parameters()]
    leaves = [m.detach().clone().requires_grad_(True)
              for m in step.state.master_params]
    with value_products():
        out = functional_call(tm, dict(zip(names, leaves)), (x,))
        scaled = _ce(out, y).float() * torch.ones((), dtype=torch.float32)
        grads = torch.autograd.grad(scaled, leaves)
        ref = float(telemetry.global_grad_norm(grads))
        loss = float(step(x, y))
    assert np.isfinite(loss)
    (rec,) = reg.events("train.telemetry")
    assert rec["windows"] == 1 and rec["step"] == 1
    assert rec["grad_norm"] == ref                  # bitwise
    assert rec["loss_scale"] == 1.0 and rec["overflow_count"] == 0
    assert rec["loss_mean"] == loss

    jax_observe.get_registry().clear_events()
    jstep = jax_make_train_step(
        jm, JaxFusedSGD(list(jm.parameters()), lr=0.1, momentum=0.9),
        lambda o, t: jax_F.cross_entropy(o, t), half_dtype=None,
        loss_scale=1.0, telemetry=True, drain_every=1)
    jstep(jnp.asarray(xn), jnp.asarray(yn))
    (jrec,) = jax_observe.get_registry().events("train.telemetry")
    np.testing.assert_allclose(rec["grad_norm"], jrec["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(rec["loss_mean"], jrec["loss_mean"],
                               rtol=1e-5)
    assert {k: rec[k] for k in ("step", "windows", "loss_scale",
                                "overflow_count")} == \
        {k: jrec[k] for k in ("step", "windows", "loss_scale",
                              "overflow_count")}


def test_telemetry_keeps_one_compile_one_dispatch_per_window():
    """With telemetry on and a stacked 4-microbatch window, the step stays
    one program (one compile) and one dispatch a window; drains land at
    steps 2, 4, 6 and read back into the gauges; the accumulator's tensors
    are reset in place (a captured step keeps writing them)."""
    _, tm = _port_mlp()
    reg = get_registry()
    reg.clear_events()
    step = _port_step(tm, half_dtype=torch.bfloat16, loss_scale="dynamic",
                      accum_steps=4, accum_stacked=True, telemetry=True,
                      drain_every=2)
    held = [t.data_ptr() for t in step.state.telem]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 4, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (4, 4)))
    step_cache.reset_stats()
    for _ in range(6):
        step(x, y)
    st = step_cache.stats()["by_kind"]["train_step"]
    assert st == {"compiles": 1, "dispatches": 6, "cache_hits": 5}
    recs = reg.events("train.telemetry")
    assert [r["step"] for r in recs] == [2, 4, 6]
    for r in recs:
        assert r["windows"] == 2 and r["loss_scale"] == 65536.0
        assert np.isfinite(r["loss_mean"]) and np.isfinite(r["grad_norm"])
    assert reg.gauge("train.grad_norm").value == recs[-1]["grad_norm"]
    assert [t.data_ptr() for t in step.state.telem] == held
    assert int(step.state.telem.windows) == 0
    assert float(step.state.telem.loss_scale) == 1.0
    assert step.drain_telemetry() is None       # nothing since the drain


def test_drain_is_one_read_of_the_five_scalars():
    """``read_telemetry`` is one stacked copy: its values are the
    accumulator's, the int32 counts exact."""
    t = telemetry.init_telemetry(device="cpu")
    new = telemetry.accumulate(
        t, loss=torch.tensor(2.5), master_grads=[torch.full((3,), 2.0)],
        flag=torch.ones((), dtype=torch.int32),
        loss_scale=torch.tensor(8.0))
    host = executor.read_telemetry(new)
    assert host == {"loss_sum": 2.5,
                    "grad_norm": float(np.float32(np.sqrt(12.0))),
                    "loss_scale": 8.0, "overflow_count": 1.0,
                    "windows": 1.0}
    # the data axis is ported (averaged over torch.distributed's group; a
    # world of one here); another axis is refused
    one = telemetry.accumulate(
        t, loss=torch.tensor(2.5), master_grads=[torch.full((3,), 2.0)],
        flag=torch.ones((), dtype=torch.int32),
        loss_scale=torch.tensor(8.0), mean_axes=("data",))
    assert executor.read_telemetry(one) == host
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        telemetry.accumulate(t, loss=None, master_grads=[], flag=None,
                             loss_scale=1.0, mean_axes=("model",))


def test_grad_norm_reads_half_gradients_in_fp32():
    """A bf16 gradient's norm is taken in fp32, not summed in bf16."""
    g = torch.full((4096,), 0.01, dtype=torch.bfloat16)
    want = torch.linalg.vector_norm(g.float())
    assert telemetry.global_grad_norm([g]).dtype == torch.float32
    assert float(telemetry.global_grad_norm([g])) == pytest.approx(
        float(want), rel=1e-6)


def test_telemetry_off_leaves_state_signature_unchanged():
    """``telemetry=False`` keeps ``StepState.telem`` None (no leaves), so
    states and checkpoints are the six-field ones; ``drain_every < 1``
    with telemetry raises the JAX error."""
    _, tm = _port_mlp()
    step = _port_step(tm)
    assert step.state.telem is None
    assert step.drain_telemetry() is None
    x, y = (torch.from_numpy(a) for a in _data())
    step(x, y)
    assert step.state.telem is None
    with pytest.raises(ValueError, match="drain_every must be >= 1"):
        _port_step(tm, telemetry=True, drain_every=0)


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------


def test_watchdog_fires_once_on_injected_stall():
    """A chaos ``train.step`` delay wedges the loop: exactly one typed
    diagnostic with the last step, the last span, the backend and the
    hint, mirrored as one ``watchdog.stall`` event; the firing itself as a
    ``chaos.inject`` event."""
    reg = get_registry()
    reg.clear_events()
    _, tm = _port_mlp()
    step = _port_step(tm)
    x, y = (torch.from_numpy(a) for a in _data())
    step(x, y)
    heartbeat()
    wd = StallWatchdog(deadline_s=0.12, poll_s=0.03)
    with wd:
        with chaos.session(seed=0) as c:
            c.on("train.step", action="delay", delay_s=0.6, at=1)
            step(x, y)                  # the hook's call 0: fast, beats
            step(x, y)                  # its call 1: delayed 0.6 s
    assert len(wd.stalls) == 1
    diag = wd.stalls[0]
    assert diag["deadline_s"] == 0.12
    assert diag["since_last_step_s"] >= 0.12
    assert diag["last_step"] == 2       # heartbeats carry the call count
    assert diag["backend"] == "cpu"
    assert diag["last_span"] is not None and "span" in diag["last_span"]
    assert diag["hint"] == observe.STALL_HINT
    assert "hung" in diag["hint"] and "tunnel" not in diag["hint"]
    (ev,) = reg.events("watchdog.stall")
    assert ev["hint"] == diag["hint"]
    (inj,) = reg.events("chaos.inject")
    assert (inj["point"], inj["call"], inj["action"]) == \
        ("train.step", 1, "delay")


def test_watchdog_silent_on_clean_run():
    _, tm = _port_mlp()
    step = _port_step(tm)
    x, y = (torch.from_numpy(a) for a in _data())
    step(x, y)
    heartbeat()
    wd = StallWatchdog(deadline_s=0.6, poll_s=0.05)
    with wd:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.0:
            step(x, y)
            time.sleep(0.05)
    assert wd.stalls == []


def test_watchdog_rejects_nonpositive_deadline():
    with pytest.raises(ValueError):
        StallWatchdog(deadline_s=0.0)
    with pytest.raises(ValueError):
        StallWatchdog(deadline_s=-1.0)


def test_serve_loop_heartbeats_under_the_watchdog():
    """``ServeEngine.run(watchdog_deadline_s=...)`` over a small trace:
    the tokens of the run without it, every tick spanned and beating, no
    stall."""
    from apex_tpu_torch.models import GptModel
    from apex_tpu_torch.serve import Request, ServeEngine
    torch.manual_seed(0)
    model = GptModel(vocab_size=41, hidden=16, layers=1, heads=2,
                     max_positions=48, dropout=0.0, attn_dropout=0.0,
                     device="cpu").eval()
    reqs = [Request(f"r{i}", [3 + i, 5, 7], 4) for i in range(3)]
    geom = dict(num_blocks=16, block_size=4, max_batch=4, prefill_chunk=4)
    ref = ServeEngine(model, **geom).run(reqs)
    reg = get_registry()
    reg.clear_events()
    beat0 = observe.last_heartbeat()[0]
    got = ServeEngine(model, **geom).run(
        [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs],
        watchdog_deadline_s=30.0)
    assert got == ref
    kinds = {e["kind"] for e in reg.events("span") if e["span"] == "dispatch"}
    assert {"prefill_step", "decode_step"} <= kinds
    assert observe.last_heartbeat()[0] > (beat0 or 0.0)
    assert reg.events("watchdog.stall") == []


# ---------------------------------------------------------------------------
# the registry's other clients and the public surface
# ---------------------------------------------------------------------------


def test_step_cache_counters_live_in_the_registry():
    """The JAX names: ``step_cache.<counter>`` and
    ``step_cache.kind.<kind>.<counter>``, from which ``stats()`` is
    read."""
    _, tm = _port_mlp()
    step = _port_step(tm)
    x, y = (torch.from_numpy(a) for a in _data())
    step_cache.reset_stats()
    step(x, y)
    step(x, y)
    counters = get_registry().snapshot()["counters"]
    assert counters["step_cache.dispatches"] == 2
    assert counters["step_cache.kind.train_step.compiles"] == 1
    assert counters["step_cache.kind.train_step.cache_hits"] == 1
    assert step_cache.kind_stats("train_step") == {
        "compiles": 1, "cache_hits": 1, "dispatches": 2}
    step_cache.set_dispatch_spans(True)
    try:
        get_registry().clear_events()
        prog = executor.Program("amp_unscale", ("t",), lambda a: a * 2)
        executor.executor.submit(prog, (torch.ones(2),))
        (ev,) = get_registry().events("span")
        assert ev["kind"] == "amp_unscale"
    finally:
        step_cache.set_dispatch_spans(False)


def test_observe_exports_and_catalog_equal_the_jax_packages():
    assert sorted(observe.__all__) == sorted(jax_observe.__all__)
    for name in jax_observe.__all__:
        assert hasattr(observe, name), name
    assert observe.CATALOG == jax_observe.CATALOG
    assert observe.catalog_names("serve.") == \
        jax_observe.catalog_names("serve.")
    assert observe.describe("plan.search_ms") == \
        jax_observe.describe("plan.search_ms")
    assert observe.describe("no.such.metric") is None
