"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy-seeded inputs go through the JAX kernel (Pallas interpret
mode on the CPU) and through the port's wrapper on CPU tensors, which takes
the kernel's plain PyTorch version.  The CUDA kernels themselves run only
on the card (``chip_smoke.py`` holds them against these plain versions);
here the wrappers' validation and device rule are pinned as well.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import attn_funcs as jax_attn_funcs
from apex_tpu.kernels import attention as jax_attn
from apex_tpu.kernels import layer_norm as jax_ln
from apex_tpu.kernels.dispatch import force_mode

from apex_tpu_torch import _build
from apex_tpu_torch.contrib.multihead_attn import attn_funcs
from apex_tpu_torch.kernels import attention, dispatch, layer_norm

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch CPU tensor of ``dtype``
    (bf16 rounding done once, by JAX, and carried across exactly)."""
    jd, td = _DT[dtype]
    j = jnp.asarray(a, jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# -- LayerNorm forward ------------------------------------------------------

@pytest.mark.parametrize("dtype,affine,rows,n", [
    ("float32", True, 37, 64),
    ("float32", False, 37, 64),
    ("float32", True, 5, 300),        # ragged rows and a ragged width
    ("bfloat16", True, 21, 96),
    ("bfloat16", False, 21, 96),
])
def test_ln_forward_matches_jax(dtype, affine, rows, n):
    r = np.random.default_rng(rows * n)
    xj, xt = _pair(r.normal(1.0, 2.0, (rows, n)), dtype)
    wj = bj = wt = bt = None
    if affine:
        w, b = r.normal(size=n), r.normal(size=n)
        wj, bj = jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32)
        wt, bt = torch.tensor(w, dtype=torch.float32), \
            torch.tensor(b, dtype=torch.float32)
    with force_mode("interpret"):
        yj, mj, rj = jax_ln.ln_forward(xj, wj, bj, 1e-5, interpret=True)
    yt, mt, rt = layer_norm.ln_forward(xt, wt, bt, 1e-5)
    assert yt.dtype == xt.dtype and yt.shape == (rows, n)
    assert mt.shape == rt.shape == (rows, 1)
    assert mt.dtype == rt.dtype == torch.float32
    # fp32 statistics: 1e-5 (summation order differs); a bf16 output may
    # round to a neighbouring value, one bf16 step
    np.testing.assert_allclose(_np(mt), _np(mj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(rt), _np(rj), rtol=1e-5, atol=1e-5)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=tol, atol=tol)


# -- flash-attention forward ------------------------------------------------

def _bias(r, kind, bh, sq, sk):
    if kind is None:
        return None
    if kind == "keypad":                        # (BH, 1, Sk), -1e30 pads
        b = np.zeros((bh, 1, sk), np.float32)
        for i in range(bh):
            b[i, 0, sk - 1 - i % 3:] = -1e30
        return b
    return r.normal(size=(1, sq, sk)).astype(np.float32)   # (1, Sq, Sk)


@pytest.mark.parametrize("dtype,causal,bias,window,sq,sk,d", [
    ("float32", True, None, None, 24, 24, 16),
    ("float32", False, "keypad", None, 20, 20, 16),
    ("float32", True, "full", None, 16, 16, 32),
    ("float32", True, None, 5, 32, 32, 16),
    ("float32", True, None, None, 13, 13, 8),      # Sq not a multiple of 8
    ("float32", False, "full", None, 12, 20, 16),  # Sq != Sk
    ("bfloat16", True, None, None, 24, 24, 16),
])
def test_flash_forward_matches_jax(dtype, causal, bias, window, sq, sk, d):
    r = np.random.default_rng(sq * 31 + sk)
    bh = 4
    qj, qt = _pair(r.normal(size=(bh, sq, d)), dtype)
    kj, kt = _pair(r.normal(size=(bh, sk, d)), dtype)
    vj, vt = _pair(r.normal(size=(bh, sk, d)), dtype)
    b = _bias(r, bias, bh, sq, sk)
    scale = d ** -0.5
    with force_mode("interpret"):
        oj, lj = jax_attn.flash_attention_fwd(
            qj, kj, vj, None if b is None else jnp.asarray(b), scale, causal,
            interpret=True, window=window)
    ot, lt = attention.flash_attention_fwd(
        qt, kt, vt, None if b is None else torch.from_numpy(b), scale,
        causal, window=window)
    assert ot.dtype == qt.dtype and ot.shape == (bh, sq, d)
    assert lt.dtype == torch.float32 and lt.shape == (bh, sq)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=1e-5, atol=1e-5)


def test_flash_attention_functional_matches_reference():
    """The (B, H, S, D) entries repeat a per-batch bias per head, as the JAX
    package's do: the port's ``flash_attention`` and ``attention_reference``
    both equal the JAX package's ``attention_reference``."""
    r = np.random.default_rng(3)
    q, k, v = (r.normal(size=(2, 3, 10, 8)).astype(np.float32)
               for _ in range(3))
    bias = r.normal(size=(2, 1, 10)).astype(np.float32)
    want = np.asarray(jax_attn_funcs.attention_reference(
        *map(jnp.asarray, (q, k, v, bias)), True, 8 ** -0.5, window=4))
    qt, kt, vt, bt = map(torch.from_numpy, (q, k, v, bias))
    got = attn_funcs.flash_attention(qt, kt, vt, bias=bt, causal=True,
                                     sliding_window=4)
    ref = attn_funcs.attention_reference(qt, kt, vt, bt, True, 8 ** -0.5,
                                         window=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)


# -- what the wrappers refuse -----------------------------------------------

def test_wrappers_refuse_what_the_kernels_cannot_take():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(TypeError, match="dtype"):
        attention.flash_attention_fwd(q.double(), q.double(), q.double(),
                                      None, 0.25, True)
    big = torch.zeros(2, 8, 160)
    with pytest.raises(ValueError, match="head dim 160"):
        attention.flash_attention_fwd(big, big, big, None, 0.1, True)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        attention.flash_attention_fwd(q, q, q, None, 0.25, True,
                                      dropout_p=0.1)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        attn_funcs.flash_attention(q[None], q[None], q[None], dropout_p=0.1)
    with pytest.raises(ValueError, match="sliding_window requires causal"):
        attn_funcs.flash_attention(q[None], q[None], q[None],
                                   sliding_window=4)
    with pytest.raises(ValueError, match="bias shape"):
        attention.flash_attention_fwd(q, q, q, torch.zeros(3, 1, 8), 0.25,
                                      False)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention_fwd(q.transpose(0, 1), q.transpose(0, 1),
                                      q.transpose(0, 1), None, 0.25, False)
    x = torch.zeros(4, 32)
    with pytest.raises(TypeError, match="dtype"):
        layer_norm.ln_forward(x.double(), None, None, 1e-5)
    wide = torch.zeros(2, layer_norm.MAX_N + 1)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        layer_norm.ln_forward(wide, None, None, 1e-5)
    with pytest.raises(ValueError, match="both given or both None"):
        layer_norm.ln_forward(x, torch.ones(32), None, 1e-5)


def test_device_rule_and_counters():
    """CPU tensors take the plain version and launch nothing; a device with
    neither a kernel nor a plain version raises."""
    dispatch.reset_counts()
    x = torch.randn(3, 16)
    layer_norm.ln_forward(x, None, None, 1e-5)
    q = torch.randn(2, 8, 16)
    attention.flash_attention_fwd(q, q, q, None, 0.25, True)
    assert dispatch.counts()["ln_forward"] == 0
    assert dispatch.counts()["flash_attention_fwd"] == 0
    assert not any(dispatch.counts().values())
    with pytest.raises(ValueError, match="no kernel or plain version"):
        dispatch.use_kernel(torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        dispatch.use_kernel(torch.empty(2), torch.empty(2, device="meta"))


def _fake_nvcc(tmp_path, body):
    """A stand-in ``nvcc`` under ``tmp_path/bin`` running the shell
    ``body`` with ``$src`` and ``$out`` set from its arguments."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do case \"$1\" in -o) out=\"$2\"; shift;; "
        "*.cu) src=\"$1\";; esac; shift; done\n" + body)
    nvcc.chmod(0o755)


def test_started_builds_are_waited_for_one_by_one(monkeypatch, tmp_path):
    """``start_all`` starts every source's build and returns; a load waits
    for its own source only, ``build_all`` for the rest, each source's
    seconds reported from its own start; a failed source raises and the
    builds still running are killed."""
    _fake_nvcc(tmp_path, 'case "$src" in *layer_norm*) sleep 1;; '
                         '*broken*) echo "bad source"; exit 2;; esac\n'
                         'echo built > "$out"\n')
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_pending", {})
    monkeypatch.setattr(_build, "_seconds", {})
    _build.start_all()
    assert sorted(_build._pending) == _build.sources()
    with _build._lock:
        assert _build._build(["xentropy"]) == {
            "xentropy": _build._seconds["xentropy"]}
    report = _build.build_all()
    assert set(report) == set(_build.sources()) and not _build._pending
    assert report["layer_norm"] >= 1.0 > report["xentropy"]
    assert all(_build._lib_path(n).is_file() for n in report)
    assert set(_build.build_all().values()) <= set(report.values())
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for n in ("broken", "layer_norm"):
        (csrc / f"{n}.cu").write_text("")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "_seconds", {})
    _build.start_all()
    jobs = dict(_build._pending)
    with pytest.raises(RuntimeError, match="bad source"):
        _build.build_all()
    assert jobs["layer_norm"].proc.poll() is not None
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.sources() == ["flash_attention", "flash_attention_bwd",
                                "flash_attention_tc", "layer_norm",
                                "lm_head_xent",
                                "multi_tensor_adam", "multi_tensor_sgd",
                                "rms_norm", "xentropy"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("layer_norm")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
