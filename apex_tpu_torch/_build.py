"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers) into its own shared library under
``build/apex_tpu_torch/`` at the repository root, which is loaded with
``ctypes``.  A library's file name carries a hash of its source and the
compiler flags, so an edited source rebuilds and an unchanged one is
loaded as it is.  Nothing is compiled when the package is imported: a
kernel's library is built at its first launch, or all of them at once,
one ``nvcc`` per source running side by side, by :func:`build_all`.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``), sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the apex_tpu_torch CUDA kernels cannot be "
        "built on this host")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, final path)
    or None when the library is already built."""
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _build(names) -> dict:
    """Build the named sources that are not built yet, one ``nvcc`` per
    source, all started together; the caller holds ``_lock``.  Returns
    ``{name: seconds}`` for the sources built now and ``{name: "cached"}``
    for the others.  The first failure raises, and no ``nvcc`` outlives
    the call."""
    t0 = time.perf_counter()
    started = {}
    try:
        for n in names:
            started[n] = _start(n)
        report = {}
        for n, s in started.items():
            if s is None:
                report[n] = "cached"
                continue
            proc, tmp, out = s
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed to build {n}.cu (exit "
                    f"{proc.returncode}):\n{log}")
            os.replace(tmp, out)
            report[n] = round(time.perf_counter() - t0, 3)
        return report
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
                s[1].unlink(missing_ok=True)


def build_all() -> dict:
    """Build every kernel source that is not built yet (see :func:`_build`
    for the report)."""
    with _lock:
        return _build(sources())


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``
    (every source exports ``apex_strerror`` to name it)."""
    if err != 0:
        lib.apex_strerror.argtypes = [ctypes.c_int]
        lib.apex_strerror.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.apex_strerror(err).decode()}) at launch")
