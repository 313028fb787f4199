"""The port's ``utils/checkpoint.py`` against the JAX package's, on the
CPU: the three-part {model, optimizer, amp} checkpoint of the reference's
documented workflow (save mid-training, restore into fresh objects after
``amp.initialize`` with the same opt_level, continue as the uninterrupted
run), and a fused step's whole state in an atomic directory of schema-3
shard files (``save_train_state``, ``AsyncTrainStateSaver``,
``restore_train_state``), which replaces the JAX package's orbax
directory."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.utils import checkpoint as jax_checkpoint

from apex_tpu_torch import amp
from apex_tpu_torch.amp._amp_state import reset
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.runtime import chaos
from apex_tpu_torch.runtime.resilience import CheckpointManager
from apex_tpu_torch.training import make_train_step
from apex_tpu_torch.utils import (AsyncTrainStateSaver,
                                  CheckpointCorruptError, load_checkpoint,
                                  restore_train_state, save_checkpoint,
                                  save_train_state)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_amp_state():
    reset()
    yield
    reset()
    chaos.uninstall()


def _model():
    torch.manual_seed(21)
    return torch.nn.Sequential(torch.nn.Linear(12, 24), torch.nn.ReLU(),
                               torch.nn.Linear(24, 3))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((8, 12)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 3, (8,))))


def _amp_step(model, opt, x, y, set_to_none=False):
    loss = F.cross_entropy(model(x).float(), y)
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    opt.step()
    opt.zero_grad(set_to_none=set_to_none)
    return float(loss.detach())


def _o2_sgd():
    model = _model()
    opt = FusedSGD(list(model.parameters()), lr=0.1, momentum=0.9)
    return amp.initialize(model, opt, opt_level="O2", verbosity=0)


def test_resume_continues_identically(tmp_path):
    """amp O2 with FusedSGD: 6 uninterrupted steps against 3, a save, fresh
    objects, a load, 3 more.  As in the JAX test: the steps to the first
    resumed one equal, the later ones within fp16 rounding (O2's masters
    are re-derived from the fp16 model after a load)."""
    x, y = _data()
    path = os.path.join(tmp_path, "ckpt.pkl")
    model, opt = _o2_sgd()
    base = [_amp_step(model, opt, x, y) for _ in range(6)]
    reset()
    model, opt = _o2_sgd()
    first = [_amp_step(model, opt, x, y) for _ in range(3)]
    save_checkpoint(path, model=model.state_dict(),
                    optimizer=opt.state_dict(), amp=amp.state_dict(), step=3)
    reset()
    model, opt = _o2_sgd()
    ckpt = load_checkpoint(path)
    assert ckpt["step"] == 3
    model.load_state_dict(ckpt["model"])
    opt.load_state_dict(ckpt["optimizer"])
    amp.load_state_dict(ckpt["amp"])
    rest = [_amp_step(model, opt, x, y) for _ in range(3)]
    np.testing.assert_allclose(first + rest[:1], base[:4], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(rest[1:], base[4:], rtol=2e-4, atol=1e-5)


def test_arrays_come_back_as_cpu_tensors_and_cross_the_packages(tmp_path):
    path = os.path.join(tmp_path, "c.pkl")
    save_checkpoint(path, tree={"a": torch.ones(3), "n": 7,
                                "nested": [torch.zeros(2, 2)]})
    out = load_checkpoint(path)["tree"]
    assert isinstance(out["a"], torch.Tensor) and out["n"] == 7
    assert torch.equal(out["nested"][0], torch.zeros(2, 2))
    # the JAX package's load_checkpoint reads the port's file, and back
    got = jax_checkpoint.load_checkpoint(path)["tree"]
    np.testing.assert_array_equal(got["a"], np.ones(3))
    jpath = os.path.join(tmp_path, "j.pkl")
    jax_checkpoint.save_checkpoint(jpath, model={"w": jnp.arange(3.0)},
                                   epoch=2)
    back = load_checkpoint(jpath)
    assert back["epoch"] == 2
    assert torch.equal(back["model"]["w"], torch.arange(3.0))


def test_save_checkpoint_is_atomic_and_validated(tmp_path):
    path = os.path.join(tmp_path, "c.pkl")
    save_checkpoint(path, epoch=1)
    with chaos.session() as c:
        c.on("ckpt.mid_write", action="kill")
        with pytest.raises(chaos.ChaosKilled):
            save_checkpoint(path, epoch=2)
    assert load_checkpoint(path)["epoch"] == 1
    blob = bytearray(open(path, "rb").read())
    blob[-5] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(path)


def test_zero_grad_set_to_none_resume_exact_fused_adam(tmp_path):
    """amp O1 FusedAdam under dynamic scaling resumes exactly through a
    CheckpointManager whose next save is killed mid-write."""
    def make():
        reset()
        model = _model()
        opt = FusedAdam(list(model.parameters()), lr=0.01)
        return amp.initialize(model, opt, opt_level="O1", verbosity=0)

    x, y = _data()
    model, opt = make()
    base = [_amp_step(model, opt, x, y, True) for _ in range(6)]
    mgr = CheckpointManager(str(tmp_path / "run"))
    model, opt = make()
    first = [_amp_step(model, opt, x, y, True) for _ in range(3)]
    mgr.save(3, model=model.state_dict(), optimizer=opt.state_dict(),
             amp=amp.state_dict())
    with chaos.session() as c:
        c.on("ckpt.mid_write", action="kill")
        with pytest.raises(chaos.ChaosKilled):
            mgr.save(4, model=model.state_dict(),
                     optimizer=opt.state_dict(), amp=amp.state_dict())
    model, opt = make()
    step, ckpt = mgr.restore_or_initialize()
    assert step == 3
    ckpt = load_checkpoint(mgr.path_for(step))
    model.load_state_dict(ckpt["model"])
    opt.load_state_dict(ckpt["optimizer"])
    amp.load_state_dict(ckpt["amp"])
    rest = [_amp_step(model, opt, x, y, True) for _ in range(3)]
    np.testing.assert_array_equal(first + rest, base)


def _fused_step(dropout=0.0):
    torch.manual_seed(1)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Linear(16, 64)
            self.b = torch.nn.Linear(64, 8)

        def forward(self, x, generator=None):
            h = torch.nn.functional.gelu(self.a(x))
            if dropout:
                keep = torch.rand(h.shape, generator=generator) >= dropout
                h = h * keep / (1 - dropout)
            return self.b(h)
    m = Net()
    return make_train_step(m, FusedAdam(list(m.parameters()), lr=5e-3),
                           lambda o, t: F.cross_entropy(o, t),
                           half_dtype=torch.bfloat16, loss_scale="dynamic")


def _xy(seed, n=64):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, 16)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 8, (n,))))


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_train_state_checkpoint_exact_resume(tmp_path, dropout):
    """save_train_state / restore_train_state: the whole state (and the
    call count that seeds the dropout) round-trips into a fresh step's own
    tensors and the resumed losses are bit-identical."""
    x, y = _xy(0)
    s1 = _fused_step(dropout)
    for _ in range(5):
        s1(x, y)
    path = str(tmp_path / "ckpt")
    save_train_state(path, s1)
    save_train_state(path, s1)          # a re-save replaces it atomically
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    ref = [float(s1(x, y)) for _ in range(3)]
    s2 = _fused_step(dropout)
    ptrs = [t.data_ptr() for t in s2.state.master_params]
    restore_train_state(path, s2)
    assert s2.calls == 5
    assert [t.data_ptr() for t in s2.state.master_params] == ptrs
    assert [float(s2(x, y)) for _ in range(3)] == ref


def test_async_saver_overlaps_and_serializes(tmp_path):
    """Two saves to two paths while training goes on: each restores the
    training point it was taken at, bit-identically."""
    x, y = _xy(2, 32)
    s1 = _fused_step()
    s1(x, y)
    with AsyncTrainStateSaver() as saver:
        saver.save(str(tmp_path / "a"), s1)
        a_ref = [float(s1(x, y)) for _ in range(2)]
        saver.save(str(tmp_path / "b"), s1)
        b_ref = [float(s1(x, y)) for _ in range(2)]
    for name, want in (("a", a_ref), ("b", b_ref)):
        s = _fused_step()
        restore_train_state(str(tmp_path / name), s)
        assert [float(s(x, y)) for _ in range(2)] == want


def test_killed_train_state_save_and_orbax_directories(tmp_path):
    """A save killed mid-shard leaves the previous directory readable;
    a directory without the manifest (an orbax one) is refused."""
    x, y = _xy(3, 32)
    s1 = _fused_step()
    s1(x, y)
    path = str(tmp_path / "ckpt")
    save_train_state(path, s1)
    want = [t.clone() for t in s1.state.master_params]
    s1(x, y)
    with chaos.session() as c:
        c.on("ckpt.shard_write", action="kill", at=2)
        with pytest.raises(chaos.ChaosKilled):
            save_train_state(path, s1)
    s2 = _fused_step()
    restore_train_state(path, s2)
    assert all(torch.equal(a, b)
               for a, b in zip(s2.state.master_params, want))
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(CheckpointCorruptError, match="orbax"):
        restore_train_state(str(orbax), s2)
