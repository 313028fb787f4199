"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers) into its own shared library under
``build/apex_tpu_torch/`` at the repository root, which is loaded with
``ctypes``.  A library's file name carries a hash of its source and the
compiler flags, so an edited source rebuilds and an unchanged one is
loaded as it is.  Nothing is compiled when the package is imported: a
kernel's library is built at its first launch, or all of them at once,
one ``nvcc`` per source running side by side, by :func:`build_all`.
:func:`start_all` starts those builds and returns at once: a later load
or :func:`build_all` waits only for the sources it needs, so a program
can go on while the slowest ones compile.

The host runtime, ``csrc/runtime.cpp`` (plain C++, no CUDA), builds the
same way with ``g++`` at its first use (:func:`load_host`).

There is no fallback: a missing ``nvcc`` or ``g++``, or a failed build,
raises.
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}
# builds started by start_all and not yet waited for, by source name
_pending: dict = {}
# seconds from start to end of each source this process built
_seconds: dict = {}


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


class _Job:
    """One running ``nvcc``: its process, its output's temporary and final
    paths, its log file and its start time.  A ``background`` build runs
    under ``nice`` (where there is one), so the program that goes on
    while it compiles keeps its core."""

    def __init__(self, name: str, out: Path, background: bool = False):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.out = out
        self.tmp = out.with_suffix(f".{os.getpid()}.tmp")
        self.log = tempfile.TemporaryFile(mode="w+")
        self.begun = time.perf_counter()
        nice = shutil.which("nice") if background else None
        self.proc = subprocess.Popen(
            [*([nice, "-n", "10"] if nice else []), _nvcc(), *NVCC_FLAGS,
             "-o", str(self.tmp), str(CSRC / f"{name}.cu")],
            stdout=self.log, stderr=subprocess.STDOUT, text=True)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.tmp.unlink(missing_ok=True)
        self.log.close()


def _start(name: str, background: bool = False):
    """Start ``nvcc`` for one source; None when it is already built."""
    out = _lib_path(name)
    return None if out.is_file() else _Job(name, out, background)


def _build(names) -> dict:
    """Build the named sources that are not built yet, one ``nvcc`` per
    source, all started together (or by :func:`start_all` before); the
    caller holds ``_lock``.  Returns ``{name: seconds}`` for the sources
    built now, each from its start to its end, and ``{name: "cached"}``
    for the others.  The first failure raises, and no ``nvcc`` outlives
    the call."""
    jobs = {}
    try:
        report = {}
        for n in names:
            jobs[n] = _pending.pop(n, None) or _start(n)
            if jobs[n] is None:
                report[n] = "cached"
        live = {n: j for n, j in jobs.items() if j is not None}
        while live:
            for n, j in list(live.items()):
                if j.proc.poll() is None:
                    continue
                del live[n]
                if j.proc.returncode != 0:
                    j.log.seek(0)
                    raise RuntimeError(
                        f"nvcc failed to build {n}.cu (exit "
                        f"{j.proc.returncode}):\n{j.log.read()}")
                os.replace(j.tmp, j.out)
                report[n] = _seconds[n] = round(
                    time.perf_counter() - j.begun, 3)
            if live:
                time.sleep(0.05)
        return report
    finally:
        for j in jobs.values():
            if j is not None:
                j.stop()


@atexit.register
def _stop_pending() -> None:
    with _lock:
        for j in _pending.values():
            j.stop()
        _pending.clear()


def start_all() -> None:
    """Start ``nvcc`` for every kernel source that is neither built nor
    building, under ``nice``, and return without waiting; a load or
    :func:`build_all` waits for them, and the interpreter's exit kills
    those nobody waited for."""
    with _lock:
        for n in sources():
            if n not in _pending:
                j = _start(n, background=True)
                if j is not None:
                    _pending[n] = j


def build_all() -> dict:
    """Build every kernel source that is not built yet; returns ``{name:
    seconds}`` for each source this process built (by a load too), each
    from its start to its end, and ``{name: "cached"}`` for the others."""
    with _lock:
        report = _build(sources())
        return {n: _seconds.get(n, r) for n, r in report.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib


HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, built
    with ``g++`` first if needed (into ``build/apex_tpu_torch/``, its name
    carrying a hash of the source and the flags, as the kernels')."""
    with _lock:
        key = f"host:{name}"
        lib = _loaded.get(key)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cpp"
        h = hashlib.sha256(src.read_bytes())
        h.update(" ".join(HOST_FLAGS).encode())
        out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
        if not out.is_file():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(
                    f"g++ not found on PATH: the host runtime "
                    f"csrc/{name}.cpp cannot be built on this host")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([gxx, *HOST_FLAGS, str(src), "-o",
                                  str(tmp)], capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed to build {name}.cpp (exit "
                    f"{res.returncode}):\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        lib = _loaded[key] = ctypes.CDLL(str(out))
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
