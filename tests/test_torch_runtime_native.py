"""The port's host runtime (``apex_tpu_torch/csrc/runtime.cpp``, built with
``g++`` at first use and called through ``ctypes``) held bit for bit
against the JAX package's (``apex_tpu.runtime``, over ``csrc/runtime.cpp``)
and against numpy and torch on the same seeded inputs; a failed build
raises."""
import numpy as np
import pytest
import torch

from apex_tpu import runtime as jax_runtime

from apex_tpu_torch import _build
from apex_tpu_torch import runtime

torch.set_num_threads(2)

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def test_native_lib_builds_into_the_build_dir():
    assert runtime.available()
    assert runtime._get() is _build.load_host("runtime")
    assert any(p.name.startswith("libruntime_")
               for p in _build.BUILD_DIR.glob("*.so"))


@pytest.mark.parametrize("dtype", ["float32", "float16", "int64"])
@pytest.mark.parametrize("threads", [0, 1, 3])
def test_flatten_unflatten_bitwise_against_jax(rng, dtype, threads):
    arrays = [(rng.standard_normal(s) * 100).astype(dtype)
              for s in [(3, 4), (7,), (2, 5, 6), (1,), (0,)]]
    flat = runtime.flatten(arrays, threads=threads)
    assert flat.tobytes() == jax_runtime.flatten(arrays).tobytes()
    assert flat.tobytes() == np.concatenate(
        [a.ravel() for a in arrays]).tobytes()
    back = runtime.unflatten(flat, arrays, threads=threads)
    for a, b in zip(back, arrays):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    out = np.empty_like(flat)
    assert runtime.flatten(arrays, out=out) is out


def test_flatten_and_unflatten_errors():
    with pytest.raises(TypeError):
        runtime.flatten([np.zeros(3, np.float32), np.zeros(3, np.float16)])
    with pytest.raises(ValueError):
        runtime.unflatten(np.zeros(5, np.float32), [np.zeros((2, 2))])
    with pytest.raises(ValueError, match="bad out"):
        runtime.flatten([np.zeros(3, np.float32)],
                        out=np.zeros(4, np.float32))
    assert runtime.flatten([]).shape == (0,)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_normalize_bitwise_against_jax(rng, layout):
    batch = rng.integers(0, 256, (4, 10, 12, 3), dtype=np.uint8)
    name = f"normalize_u8_nhwc_to_f32_{layout}"
    got = getattr(runtime, name)(batch, MEAN, STD)
    want = getattr(jax_runtime, name)(batch, MEAN, STD)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    ref = (batch.astype(np.float32) / 255.0 - MEAN) / STD
    if layout == "nchw":
        ref = ref.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        getattr(runtime, name)(batch, MEAN[:2], STD[:2])


def test_f32_to_bf16_bitwise_against_jax_and_torch(rng):
    x = (rng.standard_normal(70001) * 3).astype(np.float32)
    x[:6] = [np.inf, -np.inf, np.nan, 0.0, -0.0, 3.4e38]
    got = runtime.f32_to_bf16(x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    bits = got.view(torch.int16).numpy().view(np.uint16)
    want = np.asarray(jax_runtime.f32_to_bf16(x)).view(np.uint16)
    assert np.array_equal(bits, want)
    # round to nearest even, as torch's cast; a NaN stays a quiet NaN
    ref = torch.from_numpy(x).to(torch.bfloat16)
    fin = np.isfinite(x)
    assert np.array_equal(bits[fin], ref.view(torch.int16).numpy().view(
        np.uint16)[fin])
    assert torch.isnan(got[2]) and torch.isinf(got[:2]).all()


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("this is not C++;\n")
    (src / "fine.cpp").write_text('extern "C" int f() { return 1; }\n')
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g.. failed to build broken"):
        _build.load_host("broken")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        _build.load_host("fine")
