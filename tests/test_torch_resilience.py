"""The port's resilience runtime (``apex_tpu_torch/runtime/{resilience,
chaos}.py``) against the JAX package's, on the CPU: the chaos harness,
atomic writes that survive a kill, validation with fallback past corrupt
files, the reader's allow-list, async saves, ``BadStepGuard`` on the fused
step and the eager amp loop, the ``dist.init`` / ``dist.collective`` hooks,
and schema-3 checkpoints that either package restores (a 2-layer GPT with
FusedAdam both ways; an MLP that the JAX package wrote on its 8-device
mesh)."""
import os
import pickle
import socket
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.nn import functional as jax_F
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import auto
from apex_tpu.runtime import chaos as jax_chaos
from apex_tpu.runtime import resilience as jax_res
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.runtime import chaos
from apex_tpu_torch.runtime import resilience as res
from apex_tpu_torch.runtime.resilience import (
    BadStepGuard, CheckpointCorruptError, CheckpointManager,
    CheckpointReshardError, CollectiveTimeoutError, DistributedInitError,
    SCHEMA_VERSION, TrainingDivergedError, read_checkpoint_file,
    restore_state, snapshot_state, write_checkpoint_file)
from apex_tpu_torch.training import make_train_step

from torch_decode_pairs import V, gpt_pair, ids

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leftover_controller():
    yield
    chaos.uninstall()
    jax_chaos.uninstall()


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    """The JAX steps built here leave their programs in the JAX package's
    process-wide step cache (an LRU of 128); drop them after the module,
    as the JAX package's own step tests do, so that the files run after
    this one in the process find the cache as the module found it."""
    from apex_tpu.runtime import step_cache
    yield
    step_cache.clear()


def _leaves(state):
    return [t for _, t in res._flatten(state)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert np.array_equal(_np(x), _np(y)), i


# ---------------------------------------------------------------------------
# chaos: the JAX harness's semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [chaos, jax_chaos], ids=["port", "jax"])
def test_chaos_deterministic_at_times_after(mod):
    """The same at=/after=/times= counting on both sides."""
    c = mod.ChaosController(seed=0)
    c.on("p", action="fail", at=(1, 3))
    c.on("q", action="fail", after=2, times=2)
    fired = {"p": [], "q": []}
    for point, n in (("p", 5), ("q", 6)):
        for _ in range(n):
            try:
                c.fire(point)
                fired[point].append(0)
            except mod.ChaosInjectedFailure:
                fired[point].append(1)
    assert fired == {"p": [0, 1, 0, 1, 0], "q": [0, 0, 1, 1, 0, 0]}
    assert [e[0] for e in c.log] == ["p", "p", "q", "q"]


def test_chaos_seeded_probability_matches_jax():
    """A probabilistic fault fires on the same calls for one seed."""
    runs = []
    for mod in (chaos, jax_chaos):
        c = mod.ChaosController(seed=5)
        c.on("p", action="delay", after=0, times=-1, probability=0.4)
        runs.append([c.fire("p") for _ in range(40)])
    assert runs[0] == runs[1] and runs[0].count("delay") not in (0, 40)


def test_chaos_session_and_callable_action():
    assert not chaos.active()
    with chaos.session() as c:
        assert chaos.active()
        c.on("x", action="kill")
        with pytest.raises(chaos.ChaosKilled):
            chaos.hook("x")
    assert not chaos.active() and chaos.hook("x") is None
    seen = {}
    with chaos.session() as c:
        c.on("pt", action=lambda ctx: seen.update(ctx) or "custom")
        assert chaos.hook("pt", foo=7) == "custom"
    assert seen == {"foo": 7, "point": "pt", "call": 0}
    with pytest.raises(ValueError):
        chaos.ChaosController().on("p", action="explode")


# ---------------------------------------------------------------------------
# the write path, validation and the reader
# ---------------------------------------------------------------------------


def test_atomic_write_roundtrips_and_the_jax_reader_agrees(tmp_path):
    path = str(tmp_path / "c.pkl")
    w = torch.arange(4.0)
    b = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    write_checkpoint_file(path, {"model": {"w": w, "b": b}, "step": 7})
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []
    out = read_checkpoint_file(path)
    assert out["step"] == 7
    assert isinstance(out["model"]["w"], np.ndarray)
    np.testing.assert_array_equal(out["model"]["w"], np.arange(4.0))
    assert out["model"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["model"]["b"], b)
    # the JAX package's reader validates the same container, and its plain
    # pickle.loads rebuilds the bf16 leaf as an ml_dtypes array of the same
    # 2-byte patterns, through no global of the port
    jout = jax_res.read_checkpoint_file(path)
    assert jout["step"] == 7
    jb = jout["model"]["b"]
    assert isinstance(jb, np.ndarray) and jb.dtype.name == "bfloat16"
    np.testing.assert_array_equal(jb.view(np.int16),
                                  b.view(torch.int16).numpy())
    container = pickle.loads(open(path, "rb").read())
    assert b"apex_tpu_torch" not in container["payload"]["model"]
    # and the port reads the JAX writer's
    jpath = str(tmp_path / "j.pkl")
    jax_res.write_checkpoint_file(jpath, {"model": {"w": jnp.arange(4.0)},
                                          "step": 3})
    got = read_checkpoint_file(jpath)
    assert got["step"] == 3
    np.testing.assert_array_equal(got["model"]["w"], np.arange(4.0))


@pytest.mark.parametrize("point", ["ckpt.mid_write", "ckpt.pre_rename"])
def test_kill_during_save_preserves_previous_checkpoint(tmp_path, point):
    path = str(tmp_path / "c.pkl")
    write_checkpoint_file(path, {"v": 1})
    with chaos.session() as c:
        c.on(point, action="kill")
        with pytest.raises(chaos.ChaosKilled):
            write_checkpoint_file(path, {"v": 2})
    assert read_checkpoint_file(path)["v"] == 1


def _future(path):
    with open(path, "wb") as f:
        pickle.dump({"__apex_tpu_checkpoint__": SCHEMA_VERSION + 1,
                     "manifest": {}, "payload": {}}, f)


def _flip(path, at):
    blob = bytearray(open(path, "rb").read())
    blob[at] ^= 0xFF
    open(path, "wb").write(bytes(blob))


def _truncate(path):
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:len(blob) // 2])


@pytest.mark.parametrize("damage", ["bit_rot", "truncated", "future_schema"])
def test_damaged_checkpoint_raises_typed_error(tmp_path, damage):
    path = str(tmp_path / "c.pkl")
    write_checkpoint_file(path, {"model": {"w": np.zeros(64)}})
    {"bit_rot": lambda: _flip(path, -30), "truncated": lambda: _truncate(path),
     "future_schema": lambda: _future(path)}[damage]()
    with pytest.raises(CheckpointCorruptError,
                       match="schema" if damage == "future_schema"
                       else None):
        read_checkpoint_file(path)


def test_legacy_pickle_loads_with_warning_and_the_allow_list_holds(tmp_path):
    path = str(tmp_path / "legacy.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": {"w": np.ones(3)}, "epoch": 2}, f)
    with pytest.warns(UserWarning, match="legacy"):
        out = read_checkpoint_file(path)
    assert out["epoch"] == 2

    class Evil:
        def __reduce__(self):
            return (os.getcwd, ())
    with open(path, "wb") as f:
        pickle.dump({"model": Evil()}, f)
    with pytest.raises(CheckpointCorruptError, match="posix.getcwd"):
        read_checkpoint_file(path)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def test_manager_retention_and_empty_restore(tmp_path):
    m = CheckpointManager(str(tmp_path / "a"), keep_n=2)
    for s in range(1, 6):
        m.save(s, value=s)
    assert m.all_steps() == [4, 5] and m.latest_step() == 5
    assert m.restore()["value"] == 5 and m.restore(step=4)["value"] == 4
    e = CheckpointManager(str(tmp_path / "b"))
    assert e.restore_or_initialize(lambda: {"fresh": True}) == \
        (None, {"fresh": True})
    assert e.restore_or_initialize() == (None, None)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "c"), keep_n=0)


def test_manager_survives_midwrite_kill_and_sweeps_tmp(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_n=3)
    m.save(1, value=1)
    with chaos.session() as c:
        c.on("ckpt.mid_write", action="kill")
        with pytest.raises(chaos.ChaosKilled):
            m.save(2, value=2)
    assert any(".tmp." in f for f in os.listdir(tmp_path))
    assert m.all_steps() == [1]
    assert m.restore_or_initialize()[1]["value"] == 1
    m.save(3, value=3)
    assert not any(".tmp." in f for f in os.listdir(tmp_path))


def test_manager_falls_back_past_corrupt_to_latest_valid(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_n=5)
    for s in (1, 2, 3):
        m.save(s, value=s)
    _flip(m.path_for(3), -10)
    with pytest.warns(UserWarning, match="corrupt"):
        step, out = m.restore_or_initialize()
    assert (step, out["value"]) == (2, 2)


def test_async_save_results_errors_and_isolation(tmp_path):
    m = CheckpointManager(str(tmp_path / "ok"), keep_n=4)
    handles = [m.save_async(s, value=torch.full((8,), float(s)))
               for s in (1, 2, 3)]
    for h in handles:
        assert h.wait(timeout=30) == m.path_for(h.step)
    assert m.all_steps() == [1, 2, 3]
    np.testing.assert_array_equal(m.restore(2)["value"], np.full(8, 2.0))
    # the host copy is taken at submit: an in-place update of the saved
    # tensor afterwards (a replay's) does not reach the file
    w = torch.ones(4)
    h = m.save_async(4, model={"w": w})
    w.fill_(0.0)
    h.wait(timeout=30)
    np.testing.assert_array_equal(m.restore(4)["model"]["w"], np.ones(4))
    m.close()
    with pytest.raises(RuntimeError, match="closed"):
        m.save_async(5, value=1)

    bad = CheckpointManager(str(tmp_path / "bad"))
    with chaos.session() as c:
        c.on("ckpt.mid_write", action="fail")
        h = bad.save_async(1, value=1)
        with pytest.raises(chaos.ChaosInjectedFailure):
            h.wait(timeout=30)
    assert bad.all_steps() == []
    assert not any(".tmp." in f for f in os.listdir(tmp_path / "bad"))


# ---------------------------------------------------------------------------
# the fused step: sharded saves, kills, resume
# ---------------------------------------------------------------------------


def _mlp_step(seed=11, half=torch.bfloat16, **kw):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                                torch.nn.Linear(32, 8))
    opt = FusedAdam(list(model.parameters()), lr=5e-3)
    return make_train_step(model, opt, lambda o, t: F.cross_entropy(o, t),
                           half_dtype=half, loss_scale="dynamic", **kw)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((32, 16)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 8, (32,))))


def test_chaos_resume_matches_uninterrupted_run(tmp_path):
    """Periodic saves, one killed mid-write, a 'process restart': the
    newest valid checkpoint restores into fresh objects' own tensors and
    the resumed losses equal the uninterrupted run's."""
    x, y = _batch()
    ref = [float(s) for s in (lambda st: [st(x, y) for _ in range(8)])(
        _mlp_step())]
    m = CheckpointManager(str(tmp_path), keep_n=3)
    s1 = _mlp_step()
    for i in range(1, 6):
        s1(x, y)
        if i == 3:
            m.save(i, state=s1.state)
        if i == 5:
            with chaos.session() as c:
                c.on("ckpt.mid_write", action="kill")
                with pytest.raises(chaos.ChaosKilled):
                    m.save(i, state=s1.state)
    s2 = _mlp_step()
    step, comp = m.restore_or_initialize()
    assert step == 3
    tensors = [t.data_ptr() for t in _leaves(s2.state)]
    assert restore_state(comp["state"], into=s2.state) is s2.state
    assert [t.data_ptr() for t in _leaves(s2.state)] == tensors
    s2.calls = 3
    np.testing.assert_array_equal([float(s2(x, y)) for _ in range(5)],
                                  ref[3:])


@pytest.mark.parametrize("point,at", [("ckpt.shard_write", 3),
                                      ("ckpt.mid_write", 0),
                                      ("ckpt.pre_rename", 0)])
def test_killed_sharded_save_leaves_the_previous_one_newest(tmp_path, point,
                                                            at):
    st = _mlp_step()
    x, y = _batch()
    st(x, y)
    m = CheckpointManager(str(tmp_path), keep_n=3)
    m.save_sharded(1, st, epoch=1)
    assert m.last_save_stats["shard_bytes_peak_host"] == 32 * 16 * 4 and \
        m.last_save_stats["bytes"] > 0
    saved = snapshot_state(st.state)
    st(x, y)
    with chaos.session() as c:
        c.on(point, action="kill", at=at)
        with pytest.raises(chaos.ChaosKilled):
            m.save_sharded(2, st, epoch=2)
    assert m.all_steps() == [1]
    step, comp = m.restore_or_initialize()
    assert step == 1 and comp["epoch"] == 1
    _assert_states_equal(comp["state"], saved)
    m.save_sharded(3, st)            # sweeps the partial shard directory
    assert not os.path.exists(m.shard_dir_for(2))
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000001.pkl", "ckpt_00000001.shards", "ckpt_00000003.pkl",
        "ckpt_00000003.shards"]


def test_resume_into_the_same_step_is_bit_exact_with_dropout(tmp_path):
    """save_sharded, N steps, restore into the same step's tensors (its
    call count too, which seeds the dropout), the same N steps again: the
    losses and every state tensor equal, bit for bit; a state of another
    config raises, naming the leaf."""
    _, tm = gpt_pair(3, dropout=0.1, attn_dropout=0.1)
    tm.train()
    step = make_train_step(
        tm, FusedAdam(list(tm.parameters()), lr=1e-3, weight_decay=0.1),
        lambda lg, x: F.cross_entropy(lg[:, :-1].reshape(-1, V),
                                      x[:, 1:].reshape(-1)),
        half_dtype=torch.bfloat16, loss_scale="dynamic")
    x = torch.from_numpy(ids(1, 2, 16))
    for _ in range(2):
        step(x, x)
    m = CheckpointManager(str(tmp_path))
    m.save_sharded(2, step)
    first = [float(step(x, x)) for _ in range(3)]
    after = snapshot_state(step.state)
    ptrs = [t.data_ptr() for t in _leaves(step.state)]
    for t in _leaves(step.state):
        t.zero_()
    step.calls = 99
    assert m.restore_resharded(step) == (2, {})
    assert step.calls == 2 and m.last_restore_stats["mode"] == "streamed"
    assert [t.data_ptr() for t in _leaves(step.state)] == ptrs
    assert [float(step(x, x)) for _ in range(3)] == first
    _assert_states_equal(step.state, after)
    other = _mlp_step()
    with pytest.raises(CheckpointReshardError, match="leaves"):
        m.restore_resharded(other)


def test_load_state_writes_into_the_steps_own_tensors():
    """TrainStep.load_state copies a host state into the step's tensors
    (the addresses a captured graph holds); with the call count set back
    the steps repeat; a state of another shape raises, naming the leaf."""
    x, y = _batch(4)
    step = _mlp_step()
    step(x, y)
    saved = snapshot_state(step.state)
    want = [float(step(x, y)) for _ in range(2)]
    ptrs = [t.data_ptr() for t in _leaves(step.state)]
    assert step.load_state(saved) is step
    assert [t.data_ptr() for t in _leaves(step.state)] == ptrs
    step.calls = 1
    assert [float(step(x, y)) for _ in range(2)] == want
    bad = saved._replace(master_params=[torch.zeros(3)]
                         + saved.master_params[1:])
    with pytest.raises(CheckpointReshardError,
                       match=r"leaf \.master_params\[0\]: saved shape"):
        step.load_state(bad)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def _jax_loss(lg, x):
    return jax_F.cross_entropy(lg[:, :-1].reshape((-1, V)),
                               x[:, 1:].reshape((-1,)))


def _torch_loss(lg, x):
    return F.cross_entropy(lg[:, :-1].reshape(-1, V), x[:, 1:].reshape(-1))


def _gpt_steps(seed=3, half="bfloat16"):
    jm, tm = gpt_pair(seed)
    kw = dict(lr=1e-3, weight_decay=0.1)
    js = jax_make_train_step(jm, JaxFusedAdam(list(jm.parameters()), **kw),
                             _jax_loss, half_dtype=half and jnp.bfloat16,
                             loss_scale="dynamic")
    ts = make_train_step(tm, FusedAdam(list(tm.parameters()), **kw),
                         _torch_loss, half_dtype=half and torch.bfloat16,
                         loss_scale="dynamic")
    return js, ts


def _assert_cross_equal(jstate, tstate):
    jl = jax.tree_util.tree_leaves(jstate)
    tl = _leaves(tstate)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert np.array_equal(_np(a), _np(b)), i


@pytest.mark.parametrize("half", ["bfloat16", None])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_schema3_checkpoints_cross_between_the_packages(tmp_path, writer,
                                                         half):
    """A 2-layer GPT with FusedAdam, with bf16 half copies and in fp32: one
    package's save_sharded after 2 steps restores into the other's step
    through its restore_resharded, every leaf equal to the saved one (bf16
    by its 2-byte patterns).  One more step on both sides then moves every
    master, and each master's change over that step agrees across the
    packages: in fp32 within tests/test_torch_train.py's fp32 train-step
    bound (1e-5 for 99.9%), with bf16 halves within a tenth of lr for
    99.9%; the loss within that file's bound for the half type."""
    x = ids(1, 2, 16)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    js, ts = _gpt_steps(half=half)
    if writer == "jax":
        with force_mode("interpret"):
            for _ in range(2):
                js(jx, jx)
        jax_res.CheckpointManager(str(tmp_path)).save_sharded(2, js)
        assert CheckpointManager(str(tmp_path)).restore_resharded(ts) == \
            (2, {})
    else:
        for _ in range(2):
            ts(tx, tx)
        CheckpointManager(str(tmp_path)).save_sharded(2, ts, epoch=7)
        got = jax_res.CheckpointManager(str(tmp_path)).restore_resharded(js)
        assert got[0] == 2 and int(got[1]["epoch"]) == 7
        # a plain pickle.loads in the JAX package rebuilds the skeleton
        blob = pickle.loads(open(tmp_path / "ckpt_00000002.pkl", "rb").read())
        skel = pickle.loads(blob["payload"]["state"])
        assert type(skel).__module__ == "apex_tpu.training.step"
        assert type(skel.scaler).__module__ == "apex_tpu.amp.scaler"
        assert skel.telem is None
    _assert_cross_equal(js.state, ts.state)
    before = [m.numpy().copy() for m in ts.state.master_params]
    with force_mode("interpret"):
        lj = float(js(jx, jx))
    lt = float(ts(tx, tx))
    np.testing.assert_allclose(lt, lj, rtol=2e-2 if half else 1e-5)
    dj = [np.asarray(m) - b for m, b in zip(js.state.master_params, before)]
    dt = [m.numpy() - b for m, b in zip(ts.state.master_params, before)]
    assert all(np.any(d != 0) for d in dj)
    assert all(np.any(d != 0) for d in dt)
    # an update is about lr (1e-3) an element; with bf16 halves the two
    # packages' gradients differ at bf16 rounding, so their updates agree
    # to a tenth of lr, where a missing or partial update would not
    LR = 1e-3
    close = LR / 10 if half else 1e-5
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(dj, dt)])
    assert diff.max() <= 8 * LR
    assert (diff <= close).mean() >= 0.999, (diff > close).sum()


def _jax_mlp(hidden=32):
    jnn.manual_seed(0)
    m = jnn.Sequential(jnn.Linear(16, hidden), jnn.GELU(),
                       jnn.Linear(hidden, 10))
    return m, JaxFusedSGD(list(m.parameters()), lr=0.1, momentum=0.9)


def _port_mlp(hidden=32):
    m = torch.nn.Sequential(torch.nn.Linear(16, hidden), torch.nn.GELU(),
                            torch.nn.Linear(hidden, 10))
    return make_train_step(
        m, FusedSGD(list(m.parameters()), lr=0.1, momentum=0.9),
        lambda o, t: F.cross_entropy(o, t), half_dtype=None, loss_scale=1.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_schema3_checkpoint_with_telemetry_crosses(tmp_path, writer):
    """An MLP step built with ``telemetry=True`` on both sides: one
    package's ``save_sharded`` after 2 undrained windows restores into the
    other's step, the telemetry accumulator (``StepState.telem``, five 0-d
    leaves under the JAX ``StepTelemetry`` name) leaf for leaf with the
    rest of the state; the restored accumulator then drains as the
    writer's would have."""
    rng = np.random.default_rng(2)
    xn = rng.standard_normal((8, 16)).astype(np.float32)
    yn = rng.integers(0, 10, (8,))
    model, jopt = _jax_mlp()
    js = jax_make_train_step(model, jopt, lambda o, t: jax_F.cross_entropy(o, t),
                             half_dtype=None, loss_scale=1.0, telemetry=True,
                             drain_every=100)
    tm = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                             torch.nn.Linear(32, 10))
    ts = make_train_step(tm, FusedSGD(list(tm.parameters()), lr=0.1,
                                      momentum=0.9),
                         lambda o, t: F.cross_entropy(o, t), half_dtype=None,
                         loss_scale=1.0, telemetry=True, drain_every=100)
    if writer == "jax":
        for _ in range(2):
            js(jnp.asarray(xn), jnp.asarray(yn))
        jax_res.CheckpointManager(str(tmp_path)).save_sharded(2, js)
        assert CheckpointManager(str(tmp_path)).restore_resharded(ts) == \
            (2, {})
        src, dst = js, ts
    else:
        for _ in range(2):
            ts(torch.from_numpy(xn), torch.from_numpy(yn))
        CheckpointManager(str(tmp_path)).save_sharded(2, ts)
        got = jax_res.CheckpointManager(str(tmp_path)).restore_resharded(js)
        assert got[0] == 2
        blob = pickle.loads(open(tmp_path / "ckpt_00000002.pkl", "rb").read())
        skel = pickle.loads(blob["payload"]["state"])
        assert type(skel.telem).__module__ == "apex_tpu.observe.telemetry"
        src, dst = ts, js
    _assert_cross_equal(js.state, ts.state)
    assert int(np.asarray(ts.state.telem.windows)) == 2
    rec = dst.drain_telemetry()
    assert rec["windows"] == 2 and rec["overflow_count"] == 0
    assert rec["loss_scale"] == 1.0


def test_jax_checkpoint_from_the_8_device_mesh_restores(tmp_path):
    """An MLP step under auto.Plan(dp=8, zero_stage=1, n_devices=8)
    (tests/test_elastic.py's) saves its ZeRO-sharded state as 8 shard
    files a leaf; the port's single-device step assembles each leaf from
    them, equal to the JAX state.  A step of another width raises
    CheckpointReshardError on both sides, naming the same leaf."""
    model, opt = _jax_mlp()
    step = jax_make_train_step(
        model, opt, lambda o, t: jax_F.cross_entropy(o, t), half_dtype=None,
        loss_scale=1.0, parallel=auto.Plan(dp=8, zero_stage=1, n_devices=8))
    rng = np.random.default_rng(1)
    step(jnp.asarray(rng.standard_normal((8, 16)), jnp.float32),
         jnp.asarray(rng.integers(0, 10, (8,))))
    jax_res.CheckpointManager(str(tmp_path)).save_sharded(0, step)
    _, man = read_checkpoint_file(str(tmp_path / "ckpt_00000000.pkl"),
                                  return_manifest=True,
                                  assemble_streamed=False)
    shards = [len(leaf["shards"]) for leaf in
              man["components"]["state"]["streamed"]["leaves"] if leaf]
    assert max(shards) == 8
    ts = _port_mlp()
    assert CheckpointManager(str(tmp_path)).restore_resharded(ts) == (0, {})
    _assert_cross_equal(step.state, ts.state)
    wide_j = jax_make_train_step(*_jax_mlp(48),
                                 lambda o, t: jax_F.cross_entropy(o, t),
                                 half_dtype=None, loss_scale=1.0)
    with pytest.raises(jax_res.CheckpointReshardError) as je:
        jax_res.CheckpointManager(str(tmp_path)).restore_resharded(wide_j)
    with pytest.raises(CheckpointReshardError) as te:
        CheckpointManager(str(tmp_path)).restore_resharded(_port_mlp(48))
    leaf = str(je.value).split(" leaf ")[1].split(":")[0]
    assert leaf == ".master_params[0]"
    assert f" leaf {leaf}:" in str(te.value)


def test_gathered_jax_bf16_payload_and_set_telemetry_are_refused(tmp_path):
    """A gathered JAX payload holding an ml_dtypes array names the leaf and
    points at save_sharded; a StepState with telemetry, once refused naming
    A8, now reads as the port's seven-field state (telemetry is ported)."""
    js, _ = _gpt_steps()
    path = str(tmp_path / "g.pkl")
    jax_res.write_checkpoint_file(path, {"state": js.state})
    with pytest.raises(CheckpointReshardError,
                       match=r"leaf \.model_params\[0\].*save_sharded"):
        read_checkpoint_file(path)
    telem = object()
    st = res._format_step_state(*([None] * 6 + [telem]))
    assert st.telem is telem and len(st) == 7
    assert res._format_step_state(*([None] * 6)).telem is None


# ---------------------------------------------------------------------------
# BadStepGuard
# ---------------------------------------------------------------------------


def test_guard_escalates_warn_rollback_raise_on_fused_step():
    """The JAX test's storm on the port's step: the rollback copies the
    snapshot into the live tensors bit for bit, keeping the halved scale."""
    step = _mlp_step()
    x, y = _batch(1)
    events = []
    guard = BadStepGuard(patience=3, policy=("warn", "rollback", "raise"),
                         snapshot_interval=5, on_event=events.append)
    guard.attach(step)
    for _ in range(5):          # the fifth clean step refreshes the snapshot
        step(x, y)
    guard.flush()
    assert guard.stats == {"observed": 5, "skipped": 0, "escalations": 0,
                           "rollbacks": 0}
    anchor = snapshot_state(step.state)
    for _ in range(2):          # clean steps past the snapshot
        step(x, y)
    moved = snapshot_state(step.state)
    ptrs = [t.data_ptr() for t in _leaves(step.state)]
    with chaos.session() as c:
        c.on("train.step", action="nonfinite_grads", after=0, times=6)
        with pytest.warns(UserWarning, match="BadStepGuard"):
            for _ in range(6):
                step(x, y)
            guard.flush()
    assert guard.stats["skipped"] == 6
    assert [e["stage"] for e in events] == ["warn", "rollback"]
    assert guard.stats["rollbacks"] == 1
    assert [t.data_ptr() for t in _leaves(step.state)] == ptrs
    got, want = _leaves(step.state), _leaves(anchor)
    for i, (a, b) in enumerate(zip(got, want)):
        if i < len(got) - 4:     # all but the scaler's three and the step
            assert torch.equal(a, b), i
    assert not torch.equal(moved.master_params[0], anchor.master_params[0])
    assert int(step.state.step) == int(anchor.step) == 5
    assert float(step.state.scaler.loss_scale) == 2.0 ** 16 / 2 ** 6
    with chaos.session() as c:
        c.on("train.step", action="nonfinite_grads", after=0, times=-1)
        with pytest.raises(TrainingDivergedError), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for _ in range(8):
                step(x, y)
            guard.flush()
    assert [e["stage"] for e in events] == ["warn", "rollback", "raise"]


def test_guard_rollback_resumes_training_and_policies():
    step = _mlp_step()
    x, y = _batch(2)
    guard = BadStepGuard(patience=2, policy="rollback", snapshot_interval=1)
    guard.attach(step)
    for _ in range(3):
        step(x, y)
    with chaos.session() as c:
        c.on("train.step", action="nonfinite_grads", after=0, times=2)
        with pytest.warns(UserWarning, match="BadStepGuard"):
            for _ in range(2):
                step(x, y)
            guard.flush()
    assert guard.stats["rollbacks"] == 1
    post = [float(step(x, y)) for _ in range(3)]
    guard.flush()
    assert np.all(np.isfinite(post)) and guard.stats["skipped"] == 2
    for bad in (dict(patience=0), dict(policy="retrain-from-scratch"),
                dict(policy=())):
        with pytest.raises(ValueError):
            BadStepGuard(**bad)
    g = BadStepGuard(patience=2, policy="warn")
    with pytest.warns(UserWarning, match="BadStepGuard"):
        for _ in range(8):
            g.observe(1)
    assert g.stats["escalations"] == 4


def test_overflow_streak_clamps_at_min_loss_scale():
    torch.manual_seed(5)
    model = torch.nn.Sequential(torch.nn.Linear(8, 8))
    step = make_train_step(
        model, FusedAdam(list(model.parameters()), lr=1e-3),
        lambda o, t: F.cross_entropy(o, t), half_dtype=torch.float16,
        loss_scale="dynamic", min_loss_scale=2.0 ** 10)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 8, (16,)))
    with chaos.session() as c:
        c.on("train.step", action="nonfinite_grads", after=0, times=-1)
        for _ in range(12):
            step(x, y)
    assert float(step.state.scaler.loss_scale) == 2.0 ** 10
    assert int(step.state.step) == 0 and c.counts["train.step"] == 12


def _amp_loop(guarded, storm, steps):
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import _amp_state, reset
    from apex_tpu_torch.runtime import step_cache
    reset()
    torch.manual_seed(7)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 4))
    opt = FusedAdam(list(model.parameters()), lr=1e-3)
    model, opt = amp.initialize(model, opt, opt_level="O2", verbosity=0,
                                defer_scale_update=True)
    guard = BadStepGuard(patience=3, policy=("warn", "raise"))
    if guarded:
        guard.attach_optimizer(opt)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (8,)))
    step_cache.reset_stats()
    try:
        with chaos.session() as c:
            if storm:
                c.on("amp.backward", action="nonfinite_grads", after=0,
                     times=-1)
            for _ in range(steps):
                loss = F.cross_entropy(model(x), y)
                with amp.scale_loss(loss, opt) as scaled:
                    scaled.backward()
                opt.step()
                opt.zero_grad()
            guard.flush()
        return step_cache.stats()["dispatches"], guard, \
            _amp_state.loss_scalers[0].loss_scale()
    finally:
        reset()


def test_guard_on_the_eager_amp_loop():
    """The deferred scaler's device flag reaches the guard: no extra
    dispatch on the clean path, and a storm forced through the
    ``amp.backward`` hook escalates to TrainingDivergedError."""
    base, _, _ = _amp_loop(False, False, 6)
    guarded, guard, _ = _amp_loop(True, False, 6)
    assert guarded == base
    assert guard.stats["observed"] == 6 and guard.stats["skipped"] == 0
    with pytest.raises(TrainingDivergedError), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _amp_loop(True, True, 10)


def test_guard_hears_the_ordinary_amp_skip():
    """Without the deferred mode a skipped step is scale_loss's one-shot
    patch, which notifies the attached guard itself."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp._amp_state import reset
    reset()
    try:
        torch.manual_seed(7)
        model = torch.nn.Linear(4, 2)
        opt = FusedAdam(list(model.parameters()), lr=1e-3)
        model, opt = amp.initialize(model, opt, opt_level="O2", verbosity=0)
        guard = BadStepGuard(patience=2, policy="warn")
        guard.attach_optimizer(opt)
        with chaos.session() as c:
            c.on("amp.backward", action="nonfinite_grads", at=(0, 1))
            with pytest.warns(UserWarning, match="BadStepGuard"):
                for _ in range(3):
                    loss = model(torch.ones(3, 4)).float().sum()
                    with amp.scale_loss(loss, opt) as scaled:
                        scaled.backward()
                    opt.step()
                    opt.zero_grad()
        assert guard.stats == {"observed": 3, "skipped": 2,
                               "escalations": 1, "rollbacks": 0}
    finally:
        reset()


# ---------------------------------------------------------------------------
# distributed init and the timed collective
# ---------------------------------------------------------------------------


def test_init_distributed_absorbs_chaos_failures_and_dies_to_kill():
    from apex_tpu_torch.parallel import distributed as D
    calls = []
    with chaos.session() as c:
        c.on("dist.init", action="fail", times=2)
        D.init_distributed("h:1", num_processes=2, process_id=0,
                           timeout_s=30, backoff_s=0.01, device="cpu",
                           _initialize=lambda **kw: calls.append(kw))
    assert len(calls) == 1
    with chaos.session() as c:
        c.on("dist.init", action="kill")
        with pytest.raises(chaos.ChaosKilled):
            D.init_distributed("h:1", num_processes=2, process_id=0,
                               timeout_s=30, backoff_s=0.01, device="cpu",
                               _initialize=lambda **kw: None)
    with pytest.raises(DistributedInitError):
        D.init_distributed("h:1", num_processes=2, process_id=0,
                           timeout_s=0.0, device="cpu",
                           _initialize=lambda **kw: None)
    assert D.DistributedInitError is DistributedInitError


def test_timed_flat_dist_call_in_one_process():
    from apex_tpu_torch.parallel import distributed as D
    tensors = [torch.ones(4), torch.full((2, 2), 3.0)]
    out = D.timed_flat_dist_call(tensors, lambda t: t * 2, timeout_s=30)
    assert torch.equal(out[0], torch.full((4,), 2.0))
    assert torch.equal(out[1], torch.full((2, 2), 6.0))

    def bad(t):
        raise ValueError("boom")
    with pytest.raises(ValueError, match="boom"):
        D.timed_flat_dist_call(tensors, bad, timeout_s=30)
    D._PRESENCE_PROBE = lambda: [1, 3]
    try:
        with chaos.session() as c:
            c.on("dist.collective", action="delay", delay_s=3.0)
            with pytest.raises(CollectiveTimeoutError, match=r"\[1, 3\]"):
                D.timed_flat_dist_call(tensors, lambda t: t, timeout_s=0.2)
    finally:
        D._PRESENCE_PROBE = None
    assert D.missing_ranks() is None


WORKER = r'''
import os, sys, threading, time
import torch
import torch.distributed as dist
from apex_tpu_torch import parallel
from apex_tpu_torch.parallel import distributed as D
from apex_tpu_torch.runtime.resilience import CollectiveTimeoutError

parallel.init_distributed(device="cpu")
r = parallel.rank()


def reduce(t):
    dist.all_reduce(t)
    return t


out = D.timed_flat_dist_call([torch.full((3,), float(r + 1)),
                              torch.ones(2, 2) * r], reduce, timeout_s=60)
res = {"sum": [o.tolist() for o in out], "missing": D.missing_ranks()}
if r == 0:
    try:
        D.timed_flat_dist_call([torch.ones(2)], reduce, timeout_s=1.0)
    except CollectiveTimeoutError as e:
        res["timeout"] = str(e)
    # the abandoned collective completes when rank 1 joins it late: wait
    # for its thread, so the group is not torn down under it
    for t in threading.enumerate():
        if t.name == "apex-tpu-torch-collective":
            t.join(60)
else:
    time.sleep(3.0)         # rank 0 times out first, then this joins
    reduce(torch.ones(2))
torch.save(res, os.path.join(sys.argv[1], f"rank{r}.pt"))
dist.barrier()
dist.destroy_process_group()
'''


def test_timed_flat_dist_call_over_gloo(tmp_path):
    """Two gloo ranks through the port's launcher: each announces itself
    in the default store (no rank missing), the timed all-reduce sums, and
    a collective that rank 1 joins late times out on rank 0."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, APEX_TPU_COORD_PORT=str(port),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc", "--nproc",
         "2", str(worker), str(tmp_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in range(2))
    assert r0["sum"] == r1["sum"] == [[3.0] * 3, [[1.0, 1.0], [1.0, 1.0]]]
    assert r0["missing"] == r1["missing"] == []
    assert "within 1s on rank 0 of 2" in r0["timeout"]


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "CheckpointManager", "BadStepGuard", "write_checkpoint_file",
    "read_checkpoint_file", "serialize_checkpoint", "deserialize_checkpoint",
    "stream_components_to_dir", "reshard_state", "reshard_streamed",
    "stream_kv_handoff", "load_kv_handoff", "read_kv_handoff_meta",
    "discard_kv_handoff"])
def test_signatures_take_the_jax_arguments(name):
    import inspect
    want = inspect.signature(getattr(jax_res, name)).parameters
    got = inspect.signature(getattr(res, name)).parameters
    for p, v in want.items():
        assert p in got, p
        assert got[p].default == v.default, p


def test_kv_handoff_and_elastic_refuse_naming_their_items(tmp_path):
    """The KV handoff is ported (the serve engine's, ROADMAP A6): a pool's
    blocks stream out and load back bit for bit (the cross-package and
    error cases are in test_torch_serve_disagg.py); elastic training still
    refuses, naming ROADMAP A9."""
    from apex_tpu_torch.runtime import elastic
    from apex_tpu_torch.serve import init_pool_buffer
    pool = init_pool_buffer(1, 2, 4, 4, 2, device="cpu")
    pool[:, :, 1] = torch.arange(pool[:, :, 1].numel(),
                                 dtype=torch.float32).view(pool[:, :, 1].shape)
    manifest, peak = res.stream_kv_handoff(str(tmp_path), pool, [1])
    assert manifest["n_blocks"] == 1 and peak == pool[:, :, 1].numel() * 4
    dst, _ = res.load_kv_handoff(str(tmp_path),
                                 init_pool_buffer(1, 2, 4, 4, 2,
                                                  device="cpu"), [3])
    assert torch.equal(dst[:, :, 3], pool[:, :, 1])
    for call in (lambda: elastic.current_devices(),
                 lambda: elastic.ElasticTrainer(None, None, None, None),
                 lambda: elastic.elastic_restore(None, None, None, None)):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            call()
