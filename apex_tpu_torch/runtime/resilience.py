"""Atomic and async checkpoints, auto-resume and escalation on overflow
storms, the PyTorch counterpart of ``apex_tpu/runtime/resilience.py``.

* :func:`write_checkpoint_file` / :func:`read_checkpoint_file`: the one
  write path, in the JAX package's container (``_MAGIC``, schema 3, a
  manifest with a CRC32 per component).  A write is a tmp file, fsync,
  one ``os.rename`` and an fsync of the directory; the chaos hooks
  ``ckpt.mid_write``, ``ckpt.pre_rename`` and ``ckpt.post_rename`` fire
  where the JAX writer fires them.
* Schema-3 shard files (:func:`stream_components_to_dir`): each tensor of a
  component streams to ``{component}_l{i}_s{k}.bin`` (``i`` the leaf's
  index in the JAX package's tree order, ``k`` its shard) with its
  ``shape``, its ``dtype`` as a string and a CRC32 per file in the
  manifest, and the container commits last.  A tensor on the card reaches
  the disk through one pinned host buffer at a time.  bf16 is written and
  read as its raw 2-byte pattern under the dtype string ``"bfloat16"``, as
  the JAX writer leaves it, so either package restores the other's shard
  files (a JAX file written on an 8-device mesh too: its shards are placed
  at their indices).
* The pickled names are the format's.  The writer pickles this package's
  ``StepState``, ``ScalerState`` and ``_StreamedLeaf`` under the JAX
  package's module paths, so a plain ``pickle.loads`` there rebuilds them;
  the reader maps those names back and refuses any global outside an
  allow-list (those classes, numpy's array reconstructors and dtypes,
  builtins, ``collections``) with :class:`CheckpointCorruptError`.  The
  ``StepState``'s seventh field, ``telem``, is None or an
  ``observe.StepTelemetry`` of five 0-d tensors, pickled under the JAX
  package's name, so a state with telemetry crosses both ways; a state
  without leaves it None.  A gathered bf16 tensor is
  pickled as ``numpy.ndarray(shape, ml_dtypes.bfloat16, bytes)``, which
  the JAX package loads as an ``ml_dtypes`` array and this reader as a CPU
  ``torch.bfloat16`` tensor; other gathered arrays come back as host
  numpy.  A gathered JAX payload with an ``ml_dtypes`` array (numpy's own
  pickle of it) raises :class:`CheckpointReshardError` naming the leaf,
  since this package never imports ``ml_dtypes``: the JAX package's
  ``save_sharded`` writes such a state as shard files instead.
* :class:`CheckpointManager`: the same layout (``ckpt_%08d.pkl``,
  ``.shards/``), retention, tmp sweep and return values.  ``save_async``
  takes its host copy on the caller thread (non-blocking copies into
  pinned buffers on the current stream, then one synchronize of that
  stream, so a later in-place replay cannot reach the copy) and pickles
  and writes on a worker thread.  ``restore_resharded`` and
  :meth:`~apex_tpu_torch.training.step.TrainStep.load_state` copy into the
  step's own tensors: a captured graph holds their addresses.
* :class:`BadStepGuard`: warn, roll back, raise on a streak of skipped
  steps.  Each observed device flag is copied, by a kernel, into a slot of
  a small ring of pinned host memory mapped into the card's address space,
  followed by a recorded CUDA event; the guard consumes a flag once its
  event has completed and reads it from host memory, so the clean path
  adds no device-to-host copy and no synchronize.

* The serve stack's KV-block handoff (:func:`stream_kv_handoff`,
  :func:`load_kv_handoff`): a paged pool's blocks as schema-3 block files
  under the JAX package's manifest, so a handoff written by either
  package loads into the other's pool.

Saves and restores run inside the JAX package's ``observe`` spans:
``ckpt.save`` (``mode`` ``sync``, ``sharded`` or ``async``, the last on
the writer thread), ``ckpt.save.submit`` (an async save's host copy on
the caller's thread) and ``ckpt.restore`` (``mode="resharded"`` for
:meth:`CheckpointManager.restore_resharded`).
"""
from __future__ import annotations

import collections
import io
import os
import pickle
import re
import shutil
import threading
import warnings
import zlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..observe import spans as _spans
from . import chaos as _chaos

SCHEMA_VERSION = 3
_MAGIC = "__apex_tpu_checkpoint__"
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pkl$")
_SHARD_DIR_RE = re.compile(r"^ckpt_(\d+)\.shards$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed manifest, schema or checksum validation (a
    partial write, bit rot, a future schema, or a pickled global outside
    the reader's allow-list).  ``restore_or_initialize`` falls back past
    these to the newest checkpoint that validates."""


class CheckpointReshardError(RuntimeError):
    """A checkpoint validated but cannot be laid out into the target
    step: its structure, a leaf's shape or a leaf's dtype differs (another
    model or optimizer config), or a leaf is of a kind this package cannot
    hold.  The message names the component and the leaf.  A config error:
    restores do not scan past it."""


class TrainingDivergedError(RuntimeError):
    """Raised by :class:`BadStepGuard` when a streak of overflow-skipped
    steps exhausts its escalation ladder."""


class DistributedInitError(RuntimeError):
    """``init_distributed`` exhausted its attempts or its deadline."""


class CollectiveTimeoutError(RuntimeError):
    """A collective did not complete within its deadline; the message
    names the ranks missing from the presence registry where it can."""


# ---------------------------------------------------------------------------
# the JAX package's tree order: the leaf indices of the format follow it
# ---------------------------------------------------------------------------


def _node(x):
    """``(keys, children)`` of a container the format walks, None for a
    leaf.  As ``jax.tree_util``: None has no leaves, a named tuple's
    fields, a list's and a tuple's items in order, a dict's values by
    sorted key (an ``OrderedDict``'s in its order)."""
    if x is None:
        return (), []
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return tuple(f".{f}" for f in x._fields), list(x)
    if isinstance(x, (list, tuple)):
        return tuple(f"[{i}]" for i in range(len(x))), list(x)
    if isinstance(x, dict):
        keys = list(x) if isinstance(x, collections.OrderedDict) \
            else sorted(x)
        return tuple(f"[{k!r}]" for k in keys), [x[k] for k in keys]
    return None


def _flatten(tree, path=""):
    """The leaves of ``tree`` in the format's order, as ``(path, leaf)``
    pairs (paths as ``jax.tree_util.keystr`` writes them)."""
    node = _node(tree)
    if node is None:
        return [(path, tree)]
    out = []
    for key, child in zip(*node):
        out += _flatten(child, path + key)
    return out


def _structure(tree):
    """A comparable description of ``tree``'s containers."""
    node = _node(tree)
    if node is None:
        return "*"
    kind = type(tree).__name__ if tree is not None else "None"
    return (kind, node[0], tuple(_structure(c) for c in node[1]))


def _map(tree, fn, path=""):
    """``tree`` with each leaf ``x`` replaced by ``fn(x, path)``, visited in
    the format's order; containers are rebuilt (a dict in its own key
    order)."""
    node = _node(tree)
    if node is None:
        return fn(tree, path)
    if tree is None:
        return None
    kids = [_map(c, fn, path + k) for k, c in zip(*node)]
    if isinstance(tree, dict):
        keys = list(tree) if isinstance(tree, collections.OrderedDict) \
            else sorted(tree)
        by_key = dict(zip(keys, kids))
        out = {k: by_key[k] for k in tree}
        return type(tree)(out) if type(tree) in (
            dict, collections.OrderedDict) else out
    if hasattr(tree, "_fields"):
        return type(tree)(*kids)
    return type(tree)(kids)


def _map_leaves(tree, fn):
    return _map(tree, lambda x, _: fn(x))


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _dtype_name(x) -> str:
    """The format's dtype string of a tensor or host array."""
    if isinstance(x, torch.Tensor):
        return _DTYPE_NAMES[x.dtype]
    return str(np.dtype(x.dtype))


def _host_view(raw: np.ndarray, dtype: str, shape):
    """The host array of ``raw`` bytes: numpy, or a CPU bf16 tensor."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).copy()).view(
            torch.bfloat16).reshape(tuple(shape))
    return raw.view(np.dtype(dtype)).reshape(tuple(shape))


def _host_leaf(x):
    if not isinstance(x, torch.Tensor):
        return x
    return x if x.dtype == torch.bfloat16 else x.numpy()


def _to_host(tree):
    """``tree`` with every tensor fetched to the host: numpy arrays, and
    CPU bf16 tensors where numpy has no dtype (one synchronize, like
    ``torch.save``)."""
    return _map_leaves(snapshot_state(tree), _host_leaf)


def _fsync_dir(path):
    # rename durability: fsync the containing directory so the new entry
    # survives power loss, not just process death (best-effort on
    # filesystems that refuse O_RDONLY dir fds)
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def capture_layout(tree) -> Optional[dict]:
    """The sharding layout the schema-2 manifest records.  A process of
    this package drives one card and places nothing on a mesh, so there
    is none to record: always None (the manifest then carries no
    ``layout``, as the JAX package's single-device saves)."""
    return None


def _plan_meta(plan) -> Optional[dict]:
    """Manifest entry for the parallel plan a state was saved under.
    Duck-typed (anything with ``key()``/``name()`` works), as in the JAX
    package."""
    if plan is None:
        return None
    try:
        return {"key": list(plan.key()), "name": plan.name(),
                "zero_stage": int(getattr(plan, "zero_stage", 0)),
                "n_devices": int(getattr(plan, "n_devices", 1))}
    except Exception:
        return None


# ---------------------------------------------------------------------------
# the format's pickled names
# ---------------------------------------------------------------------------


class _StreamedLeaf:
    """Placeholder pickled in place of an array leaf whose bytes live in
    shard files (schema 3); carries only the leaf's flat index."""

    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = int(idx)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"_StreamedLeaf({self.idx})"


#: the JAX package, named by the globals its pickles carry (this package
#: never imports it)
_JAX = "apex_tpu"
_PORT = __name__.rsplit(".", 2)[0]
#: this package's classes -> the format's names for them
_FORMAT_NAMES = {
    (f"{_PORT}.training.step", "StepState"):
        (f"{_JAX}.training.step", "StepState"),
    (f"{_PORT}.amp.scaler", "ScalerState"):
        (f"{_JAX}.amp.scaler", "ScalerState"),
    (f"{_PORT}.observe.telemetry", "StepTelemetry"):
        (f"{_JAX}.observe.telemetry", "StepTelemetry"),
    (__name__, "_StreamedLeaf"):
        (f"{_JAX}.runtime.resilience", "_StreamedLeaf"),
}


class _Global:
    """A global of the format, written by its module and name."""

    __slots__ = ("module", "name")

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __call__(self, *args):  # pragma: no cover - a name, never called
        raise TypeError(f"{self.module}.{self.name} is a pickled name")


class _Writer(pickle._Pickler):
    """The pickler of the format: this package's state classes under the
    JAX package's names (rebuilt there by calling them), tensors as host
    numpy arrays, a bf16 tensor as ``numpy.ndarray(shape,
    ml_dtypes.bfloat16, bytearray)`` over its 2-byte patterns (an
    ``ml_dtypes`` array in the JAX package, named here with no import)."""

    def save(self, obj, save_persistent_id=True):
        if type(obj) is _Global:
            self.save(obj.module)
            self.save(obj.name)
            self.write(pickle.STACK_GLOBAL)
            return
        super().save(obj, save_persistent_id)

    def reducer_override(self, obj):
        t = type(obj)
        name = _FORMAT_NAMES.get((t.__module__, t.__qualname__))
        if name is not None:
            if t is _StreamedLeaf:
                return _Global(*name), (obj.idx,)
            return _Global(*name), tuple(obj)
        if isinstance(obj, torch.Tensor):
            x = obj.detach().cpu()
            if x.dtype == torch.bfloat16:
                raw = x.contiguous().view(torch.int16).numpy().tobytes()
                return (_Global("numpy", "ndarray"),
                        (tuple(x.shape), _Global("ml_dtypes", "bfloat16"),
                         bytearray(raw)))
            return x.numpy().__reduce_ex__(pickle.HIGHEST_PROTOCOL)
        return NotImplemented


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _Writer(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _format_step_state(*fields):
    """The format's ``StepState`` (seven fields, the last ``telem``; six
    in a file written before it) as this package's."""
    from ..training.step import StepState
    return StepState(*fields)


class _FormatStepState:
    """Rebuilds the format's ``StepState``, called (this package's
    writer) or through ``__new__`` (the JAX package's)."""

    def __new__(cls, *fields):
        return _format_step_state(*fields)


def _format_scaler_state(*fields):
    from ..amp.scaler import ScalerState
    return ScalerState(*fields)


class _FormatScalerState:
    def __new__(cls, *fields):
        return _format_scaler_state(*fields)


def _format_step_telemetry(*fields):
    from ..observe.telemetry import StepTelemetry
    return StepTelemetry(*fields)


class _FormatStepTelemetry:
    def __new__(cls, *fields):
        return _format_step_telemetry(*fields)


class _ForeignType:
    """A dtype of a package this one does not import (``ml_dtypes``)."""

    def __init__(self, name):
        self.name = name

    def __setstate__(self, state):
        pass


def _np_core(sub):
    core = getattr(np, "_core", None)
    if core is None:
        import numpy.core as core
    return getattr(core, sub)


class _Pending:
    """An array the reader rebuilds once its state arrives; a foreign
    dtype's stays unresolved and is refused by leaf afterwards."""

    def __init__(self, foreign=None, shape=()):
        self.foreign, self.shape, self.array = foreign, shape, None

    def __setstate__(self, state):
        dtype = state[2]
        if isinstance(dtype, _ForeignType):
            self.foreign, self.shape = dtype.name, tuple(state[1])
            return
        a = _np_core("multiarray")._reconstruct(np.ndarray, (0,), b"b")
        a.__setstate__(state)
        self.array = a


def _np_dtype(obj, *args):
    if isinstance(obj, _ForeignType):
        return obj
    return np.dtype(obj, *args)


def _ndarray(shape, dtype=float, buffer=None, *args):
    """``numpy.ndarray``; called with the ``ml_dtypes.bfloat16`` name and a
    buffer (this package's writer's bf16 leaves) it gives a CPU
    ``torch.bfloat16`` tensor of those 2-byte patterns."""
    if isinstance(dtype, _ForeignType):
        if dtype.name == "bfloat16" and buffer is not None and not args:
            return _host_view(np.frombuffer(buffer, np.uint8), "bfloat16",
                              shape)
        return _Pending(dtype.name, tuple(shape))
    return np.ndarray(shape, dtype, buffer, *args)


def _reconstruct(cls, shape, typecode):
    return _Pending()


def _frombuffer(buf, dtype, shape, order):
    if isinstance(dtype, _ForeignType):
        return _Pending(dtype.name, tuple(shape))
    return _np_core("numeric")._frombuffer(buf, dtype, shape, order)


def _scalar(dtype, *args):
    return _np_core("multiarray").scalar(dtype, *args)


_NP_MODULES = ("numpy.core.multiarray", "numpy._core.multiarray",
               "numpy.core.numeric", "numpy._core.numeric")
_BUILTINS = {"set", "frozenset", "complex", "slice", "range", "bytearray",
             "tuple", "list", "dict", "int", "float", "bool", "str",
             "bytes"}
_COLLECTIONS = {"OrderedDict", "defaultdict", "deque", "Counter"}


class _Reader(pickle.Unpickler):
    """The reader of the format: the JAX package's state classes as this
    package's, numpy's arrays and dtypes, builtins and ``collections``;
    any other global is refused."""

    def find_class(self, module, name):
        if (module, name) == (f"{_JAX}.training.step", "StepState"):
            return _FormatStepState
        if (module, name) == (f"{_JAX}.amp.scaler", "ScalerState"):
            return _FormatScalerState
        if (module, name) == (f"{_JAX}.observe.telemetry", "StepTelemetry"):
            return _FormatStepTelemetry
        if (module, name) == (f"{_JAX}.runtime.resilience",
                              "_StreamedLeaf"):
            return _StreamedLeaf
        if module == "numpy" and name == "dtype":
            return _np_dtype
        if module == "numpy" and name == "ndarray":
            return _ndarray
        if module in _NP_MODULES:
            fn = {"_reconstruct": _reconstruct, "_frombuffer": _frombuffer,
                  "scalar": _scalar}.get(name)
            if fn is not None:
                return fn
        if module == "builtins" and name in _BUILTINS:
            return getattr(__import__("builtins"), name)
        if module == "collections" and name in _COLLECTIONS:
            return getattr(collections, name)
        if module.split(".")[0] == "ml_dtypes":
            return _ForeignType(name)
        raise CheckpointCorruptError(
            f"the checkpoint pickles the global {module}.{name}, which the "
            f"reader does not allow")


def _resolve(tree, source, component):
    """``tree`` with the reader's pending arrays made numpy; a foreign
    dtype's leaf raises, named."""
    def fix(x, path):
        if not isinstance(x, _Pending):
            return x
        if x.foreign is not None:
            raise CheckpointReshardError(
                f"{source}: component {component!r} leaf {path or '<root>'}"
                f" is a gathered ml_dtypes {x.foreign} array of shape "
                f"{x.shape}, which this package does not read (it does "
                f"not import ml_dtypes); the JAX package's "
                f"CheckpointManager.save_sharded writes such a state as "
                f"schema-3 shard files, which it restores")
        return x.array
    return _map(tree, fix)


def _loads(blob, source="<bytes>", component="<container>"):
    obj = _Reader(io.BytesIO(blob)).load()
    return _resolve(obj, source, component)


# ---------------------------------------------------------------------------
# streaming shard IO (schema 3)
# ---------------------------------------------------------------------------


def _shard_bytes(t: torch.Tensor, staging) -> np.ndarray:
    """The bytes of one tensor as a uint8 host array: a CPU tensor's own
    memory, a card tensor's through the pinned ``staging`` buffer."""
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if not flat.is_cuda:
        return flat.numpy()
    host = staging(flat.numel())[:flat.numel()]
    host.copy_(flat)
    return host.numpy()


class _Staging:
    """One pinned host buffer, grown to the largest request."""

    def __init__(self):
        self.buf = None

    def __call__(self, n):
        if self.buf is None or self.buf.numel() < n:
            self.buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return self.buf


def _write_shard_file(dir_path: str, name: str, buf) -> None:
    # same durability contract as the manifest container: tmp + fsync +
    # one rename, so a shard file either exists complete or not at all
    tmp = os.path.join(dir_path, f"{name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(dir_path, name))


def stream_components_to_dir(dir_path: str, components: dict):
    """Write every tensor leaf of ``components`` as a shard file under
    ``dir_path``: one file a tensor (a process holds a whole tensor, one
    shard covering it), raw bytes, atomic per-file writes.  A card tensor
    passes through one pinned host buffer, reused from leaf to leaf; the
    returned peak is the largest single host buffer touched.  Chaos hook
    ``ckpt.shard_write`` fires before each file: a kill there leaves a
    partial shard directory and no manifest.

    Returns ``(skeletons, streamed_meta, peak_bytes)`` as the JAX
    function does: each component with its tensor leaves replaced by
    :class:`_StreamedLeaf` placeholders, the manifest's per-component
    ``streamed`` entries, and the peak."""
    os.makedirs(dir_path, exist_ok=True)
    skeletons, streamed_meta = {}, {}
    peak = 0
    staging = _Staging()
    for comp, tree in components.items():
        leaves = _flatten(tree)
        comp_tag = re.sub(r"[^A-Za-z0-9_.-]", "_", comp)
        leaf_meta = []
        for i, (_, leaf) in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                leaf_meta.append(None)
                continue
            buf = _shard_bytes(leaf, staging)
            peak = max(peak, buf.nbytes)
            fname = f"{comp_tag}_l{i}_s0.bin"
            if _chaos.active():
                _chaos.hook("ckpt.shard_write", dir=dir_path, file=fname,
                            component=comp, leaf=i)
            _write_shard_file(dir_path, fname, buf)
            leaf_meta.append({
                "shape": [int(d) for d in leaf.shape],
                "dtype": _dtype_name(leaf),
                "shards": [{"file": fname, "crc32": zlib.crc32(buf),
                            "nbytes": int(buf.nbytes),
                            "index": [[0, int(d)] for d in leaf.shape]}]})
        pos = iter(range(len(leaves)))
        skeletons[comp] = _map_leaves(
            tree, lambda x, i=pos: _StreamedLeaf(next(i))
            if isinstance(x, torch.Tensor) else (next(i), x)[1])
        if any(leaf_meta):
            streamed_meta[comp] = {"dir": os.path.basename(dir_path),
                                   "leaves": leaf_meta}
    _fsync_dir(dir_path)
    return skeletons, streamed_meta, peak


def _shard_path(base_dir, streamed_dir, shard_meta):
    return os.path.join(base_dir, streamed_dir, shard_meta["file"])


def _read_into(base_dir: str, streamed_dir: str, shard_meta: dict,
               out: np.ndarray, source: str) -> np.ndarray:
    """One shard file read into the uint8 host array ``out`` (at least
    its size), size- and CRC-checked (:class:`CheckpointCorruptError` on a
    mismatch or a missing file).  Returns the filled prefix."""
    path = _shard_path(base_dir, streamed_dir, shard_meta)
    n = shard_meta["nbytes"]
    try:
        with open(path, "rb") as f:
            got = f.readinto(memoryview(out)[:n])
            extra = f.read(1)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"{source}: missing shard file {shard_meta['file']!r} "
            f"(partial shard directory?)") from e
    buf = out[:n]
    if got != n or extra or zlib.crc32(buf) != shard_meta["crc32"]:
        raise CheckpointCorruptError(
            f"{source}: shard file {shard_meta['file']!r} failed checksum "
            f"validation (expected crc32={shard_meta['crc32']:#010x} over "
            f"{shard_meta['nbytes']} bytes)")
    return buf


def _read_shard(base_dir: str, streamed_dir: str, shard_meta: dict,
                dtype, source: str):
    """One shard file as a host array of the shard's block shape."""
    raw = np.empty(shard_meta["nbytes"], np.uint8)
    _read_into(base_dir, streamed_dir, shard_meta, raw, source)
    block = tuple(b - a for a, b in shard_meta["index"])
    return _host_view(raw, str(dtype), block)


def _assemble_leaf(leaf_meta: dict, base_dir: str, streamed_dir: str,
                   source: str):
    """The full host array of one streamed leaf, each shard placed at
    its index: numpy, or a CPU bf16 tensor."""
    shape = tuple(leaf_meta["shape"])
    dtype = leaf_meta["dtype"]
    if dtype == "bfloat16":
        out = torch.empty(shape, dtype=torch.bfloat16)
    else:
        out = np.empty(shape, np.dtype(dtype))
    for sh in leaf_meta["shards"]:
        idx = tuple(slice(a, b) for a, b in sh["index"])
        out[idx] = _read_shard(base_dir, streamed_dir, sh, dtype, source)
    return out


def _assemble_tree(skeleton, streamed_meta: dict, base_dir: str,
                   source: str):
    """``skeleton`` with each :class:`_StreamedLeaf` replaced by its
    assembled host array."""
    leaf_meta = streamed_meta["leaves"]
    return _map_leaves(skeleton, lambda x: _assemble_leaf(
        leaf_meta[x.idx], base_dir, streamed_meta["dir"], source)
        if isinstance(x, _StreamedLeaf) else x)


# ---------------------------------------------------------------------------
# serve KV-block handoff (disaggregated prefill/decode)
# ---------------------------------------------------------------------------

_KV_MANIFEST = "KV_MANIFEST.pkl"
_KV_MAGIC = "__apex_tpu_kv_handoff__"


def _pool_parts(pool):
    """``[("kv", tensor)]`` for a plain pool, ``[("q", ...), ("scale",
    ...)]`` for the int8 :class:`~apex_tpu_torch.inference.quant.QuantKV`
    pair (duck-typed, so this module never imports serve)."""
    if hasattr(pool, "q") and hasattr(pool, "scale"):
        return [("q", pool.q), ("scale", pool.scale)]
    return [("kv", pool)]


def _block_shape(arr):
    """A pool part's per-block shape: ``(L, 2, H, bs, D)``."""
    return [int(d) for d in arr.shape[:2]] + [int(d) for d in arr.shape[3:]]


def stream_kv_handoff(dir_path: str, pool, table, *,
                      source: str = "kv_handoff",
                      extra_meta: Optional[dict] = None, link_from=None):
    """Stream one session's KV blocks out of a paged pool into
    ``dir_path`` under the schema-3 shard-file contract of the JAX
    package: one file per (block, pool part), raw bytes, atomic
    tmp + fsync + rename, CRC32 in the manifest, and the manifest commits
    LAST, so a kill mid-handoff leaves debris with no manifest.  A card
    pool's block passes through one pinned host buffer: the host holds one
    block's bytes at a time.

    ``table`` is the session's physical block ids in logical order; the
    manifest records logical order, so the loader's fresh ids map
    positionally.  Chaos hook ``serve.kv_handoff`` fires before each
    block file.  ``extra_meta`` rides in the manifest under ``"meta"``.
    The manifest is the JAX package's (a plain pickled dict), so either
    package loads the other's handoff.

    ``link_from`` is ``(directory, blocks, n)``: a committed handoff of
    the same session whose first ``n`` blocks hold the bytes that
    ``table``'s first ``n`` blocks hold now (``blocks`` its manifest's
    block records).  Those files are hard-linked from it instead of
    written (the serve fleet's periodic session snapshots rewrite only
    the blocks that changed); the directory is a complete handoff all the
    same, and the chaos hook fires before each of its block files.

    Returns ``(manifest, peak_bytes)``: peak is the largest single host
    buffer written (one block part's bytes)."""
    os.makedirs(dir_path, exist_ok=True)
    parts = _pool_parts(pool)
    staging = _Staging()
    blocks_meta = []
    peak = 0
    src_dir, src_blocks, n_link = link_from or (None, (), 0)
    for logical, bid in enumerate(table):
        entry = {}
        for part, arr in parts:
            fname = f"kvblk{logical}_{part}.bin"
            if _chaos.active():
                _chaos.hook("serve.kv_handoff", dir=dir_path,
                            file=fname, block=logical)
            if logical < n_link:
                old = src_blocks[logical][part]
                os.link(os.path.join(src_dir, old["file"]),
                        os.path.join(dir_path, fname))
                entry[part] = dict(old, file=fname)
                continue
            buf = _shard_bytes(arr[:, :, int(bid)], staging)
            peak = max(peak, buf.nbytes)
            _write_shard_file(dir_path, fname, buf)
            entry[part] = {"file": fname, "crc32": zlib.crc32(buf),
                           "nbytes": int(buf.nbytes)}
        blocks_meta.append(entry)
    manifest = {
        _KV_MAGIC: SCHEMA_VERSION,
        "kind": "kv_handoff",
        "quant": len(parts) == 2,
        "parts": {part: {"shape": _block_shape(arr),
                         "dtype": _dtype_name(arr)}
                  for part, arr in parts},
        "n_blocks": len(blocks_meta),
        "blocks": blocks_meta,
        "source": source,
    }
    if extra_meta is not None:
        manifest["meta"] = dict(extra_meta)
    _write_shard_file(dir_path, _KV_MANIFEST, pickle.dumps(manifest))
    _fsync_dir(dir_path)
    return manifest, peak


class _PlainUnpickler(pickle.Unpickler):
    """A manifest is builtins only: any pickled global is refused."""

    def find_class(self, module, name):
        raise CheckpointCorruptError(
            f"a KV handoff manifest names the global {module}.{name}")


def read_kv_handoff_meta(dir_path: str) -> dict:
    """Load and validate a KV handoff directory's MANIFEST without
    touching the block files; a mid-stream kill's manifest-less debris is
    rejected here with :class:`CheckpointCorruptError`."""
    src = os.path.join(dir_path, _KV_MANIFEST)
    try:
        with open(src, "rb") as f:
            manifest = _PlainUnpickler(io.BytesIO(f.read())).load()
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"{dir_path}: no KV handoff manifest (mid-handoff "
            f"kill?)") from e
    if not isinstance(manifest, dict) or \
            manifest.get(_KV_MAGIC) is None or \
            manifest.get("kind") != "kv_handoff":
        raise CheckpointCorruptError(
            f"{dir_path}: not a KV handoff manifest")
    if manifest[_KV_MAGIC] > SCHEMA_VERSION:
        raise CheckpointCorruptError(
            f"{dir_path}: handoff schema {manifest[_KV_MAGIC]} is newer "
            f"than this reader ({SCHEMA_VERSION})")
    return manifest


def load_kv_handoff(dir_path: str, pool, new_ids):
    """Copy a streamed KV handoff into ``pool`` at the freshly allocated
    physical ids ``new_ids`` (logical order: entry i of the manifest lands
    in ``new_ids[i]``), in place.  The block bytes are written verbatim,
    int8 payloads AND their fp32 scales alike, so a handed-off session's
    continuation is the unified engine's.

    Raises :class:`CheckpointCorruptError` when the directory has no
    manifest (a mid-handoff kill), a block file is absent, or a CRC/size
    check fails; raises :class:`CheckpointReshardError` when the manifest
    describes a different pool geometry (dtype, per-block shape,
    quantization) or another block count than ``new_ids``.  Returns
    ``(pool, peak_bytes)``."""
    manifest = read_kv_handoff_meta(dir_path)
    parts = _pool_parts(pool)
    if manifest["quant"] != (len(parts) == 2):
        raise CheckpointReshardError(
            f"{dir_path}: handoff quant={manifest['quant']} but the "
            f"destination pool is "
            f"{'int8' if len(parts) == 2 else 'dense'}")
    for part, arr in parts:
        meta = manifest["parts"][part]
        want = _block_shape(arr)
        if meta["shape"] != want or meta["dtype"] != _dtype_name(arr):
            raise CheckpointReshardError(
                f"{dir_path}: handoff part {part!r} is "
                f"{meta['shape']}/{meta['dtype']}, destination pool "
                f"block is {want}/{_dtype_name(arr)} — pools must share "
                f"geometry (layers/heads/block_size/head_dim/dtype)")
    new_ids = list(new_ids)
    if len(new_ids) != manifest["n_blocks"]:
        raise CheckpointReshardError(
            f"{dir_path}: handoff carries {manifest['n_blocks']} "
            f"blocks, caller allocated {len(new_ids)}")
    peak = 0
    for logical, entry in enumerate(manifest["blocks"]):
        nid = int(new_ids[logical])
        for part, arr in parts:
            meta = entry[part]
            path = os.path.join(dir_path, meta["file"])
            try:
                with open(path, "rb") as f:
                    buf = f.read()
            except FileNotFoundError as e:
                raise CheckpointCorruptError(
                    f"{dir_path}: missing handoff block file "
                    f"{meta['file']!r} (partial handoff "
                    f"directory?)") from e
            if len(buf) != meta["nbytes"] or \
                    zlib.crc32(buf) != meta["crc32"]:
                raise CheckpointCorruptError(
                    f"{dir_path}: handoff block file {meta['file']!r} "
                    f"failed checksum validation")
            peak = max(peak, len(buf))
            block = torch.frombuffer(bytearray(buf), dtype=torch.uint8) \
                .view(arr.dtype).reshape(_block_shape(arr))
            arr[:, :, nid].copy_(block)
    return pool, peak


def discard_kv_handoff(dir_path: str) -> None:
    """Remove a handoff directory: after a successful ingest, or to
    clear partial debris before a retry."""
    shutil.rmtree(dir_path, ignore_errors=True)


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------


def serialize_checkpoint(components: dict, *, to_host: bool = True,
                         layouts: Optional[dict] = None,
                         plan=None, streamed: Optional[dict] = None,
                         extra_manifest: Optional[dict] = None) -> bytes:
    """Pickle ``components`` into the container: ``{_MAGIC: schema,
    "manifest": {...}, "payload": {name: bytes}}``, each component pickled
    apart so the manifest carries its CRC32.  ``streamed`` maps components
    to their shard-file layout (schema 3).  ``extra_manifest`` adds
    top-level manifest keys (this package's train-step call count), which
    the JAX reader ignores."""
    if layouts is None:
        layouts = {k: capture_layout(v) for k, v in components.items()}
    if to_host:
        components = {k: _to_host(v) for k, v in components.items()}
    payload = {k: _dumps(v) for k, v in components.items()}
    comp_meta = {}
    for k, b in payload.items():
        comp_meta[k] = {"crc32": zlib.crc32(b), "nbytes": len(b)}
        if layouts.get(k) is not None:
            comp_meta[k]["layout"] = layouts[k]
        if streamed and streamed.get(k) is not None:
            comp_meta[k]["streamed"] = streamed[k]
    manifest = {"schema": SCHEMA_VERSION, "components": comp_meta}
    plan_meta = _plan_meta(plan)
    if plan_meta is not None:
        manifest["plan"] = plan_meta
    if extra_manifest:
        manifest.update(extra_manifest)
    return _dumps({_MAGIC: SCHEMA_VERSION, "manifest": manifest,
                   "payload": payload})


def deserialize_checkpoint(blob, *, source: str = "<bytes>",
                           return_manifest: bool = False,
                           base_dir: Optional[str] = None,
                           assemble_streamed: bool = True):
    """Validate and unpickle a container (or a legacy manifest-less
    pickle, with a warning), through the reader's allow-list.  As the JAX
    function: ``return_manifest`` returns ``(components, manifest)``,
    streamed components resolve their shard files under ``base_dir``, and
    ``assemble_streamed=False`` keeps the placeholder skeletons."""
    if isinstance(blob, (bytes, bytearray, memoryview)):
        try:
            obj = _loads(bytes(blob), source)
        except (CheckpointCorruptError, CheckpointReshardError):
            raise
        except Exception as e:
            raise CheckpointCorruptError(
                f"{source}: not a readable pickle "
                f"(partial write?): {e}") from e
    else:
        obj = blob
    if not (isinstance(obj, dict) and _MAGIC in obj):
        warnings.warn(
            f"{source}: legacy manifest-less checkpoint — loaded without "
            f"checksum validation (re-save with save_checkpoint / "
            f"CheckpointManager to get integrity checking)",
            stacklevel=2)
        return (obj, None) if return_manifest else obj
    schema = obj[_MAGIC]
    if not isinstance(schema, int) or schema > SCHEMA_VERSION:
        raise CheckpointCorruptError(
            f"{source}: checkpoint schema {schema!r} is newer than this "
            f"library supports (<= {SCHEMA_VERSION})")
    manifest = obj.get("manifest")
    payload = obj.get("payload")
    if not isinstance(manifest, dict) or not isinstance(payload, dict):
        raise CheckpointCorruptError(
            f"{source}: container missing manifest/payload")
    declared = manifest.get("components", {})
    if set(declared) != set(payload):
        raise CheckpointCorruptError(
            f"{source}: manifest names components "
            f"{sorted(declared)} but payload holds {sorted(payload)}")
    out = {}
    for name, blob_i in payload.items():
        meta = declared[name]
        if len(blob_i) != meta["nbytes"] or \
                zlib.crc32(blob_i) != meta["crc32"]:
            raise CheckpointCorruptError(
                f"{source}: component {name!r} failed checksum validation "
                f"(expected crc32={meta['crc32']:#010x} over "
                f"{meta['nbytes']} bytes)")
        out[name] = _loads(blob_i, source, name)
        if assemble_streamed and meta.get("streamed") is not None:
            if base_dir is None:
                raise CheckpointCorruptError(
                    f"{source}: component {name!r} is shard-streamed but "
                    f"no base directory is known to resolve its shard "
                    f"files (load via read_checkpoint_file)")
            out[name] = _assemble_tree(out[name], meta["streamed"],
                                       base_dir, source)
    return (out, manifest) if return_manifest else out


def write_checkpoint_file(path: str, components: dict, *,
                          to_host: bool = True,
                          layouts: Optional[dict] = None,
                          plan=None, streamed: Optional[dict] = None,
                          extra_manifest: Optional[dict] = None) -> str:
    """Atomically write ``components`` to ``path``: serialize, write a
    sibling tmp file, flush and fsync, one ``os.rename``, fsync the
    directory.  A crash anywhere leaves ``path`` absent or the previous
    complete file.  Chaos hooks ``ckpt.mid_write`` (half the bytes in the
    tmp file), ``ckpt.pre_rename`` and ``ckpt.post_rename``.  For a
    schema-3 save this is the commit: the shard files are durable
    already."""
    blob = serialize_checkpoint(components, to_host=to_host,
                                layouts=layouts, plan=plan,
                                streamed=streamed,
                                extra_manifest=extra_manifest)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            mid = len(blob) // 2
            f.write(blob[:mid])
            if _chaos.active():
                _chaos.hook("ckpt.mid_write", path=path, tmp=tmp)
            f.write(blob[mid:])
            f.flush()
            os.fsync(f.fileno())
        if _chaos.active():
            _chaos.hook("ckpt.pre_rename", path=path, tmp=tmp)
        os.rename(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
        if _chaos.active():
            _chaos.hook("ckpt.post_rename", path=path)
    except _chaos.ChaosKilled:
        # simulated process death: leave the debris a real SIGKILL would
        # (a partial tmp file, the final path untouched); the next
        # manager save sweeps it
        raise
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def read_checkpoint_file(path: str, *, return_manifest: bool = False,
                         assemble_streamed: bool = True):
    """Read and validate a checkpoint file (legacy pickles load with a
    warning).  :class:`CheckpointCorruptError` on any validation failure,
    ``FileNotFoundError`` when ``path`` does not exist; schema-3 shard
    files resolve next to ``path``."""
    with open(path, "rb") as f:
        blob = f.read()
    return deserialize_checkpoint(blob, source=path,
                                  return_manifest=return_manifest,
                                  base_dir=os.path.dirname(
                                      os.path.abspath(path)),
                                  assemble_streamed=assemble_streamed)


# ---------------------------------------------------------------------------
# restore into a live state, in place
# ---------------------------------------------------------------------------


def _check_structure(src, tgt, component, source):
    if _structure(src) != _structure(tgt):
        raise CheckpointReshardError(
            f"{source}: component {component!r}: checkpoint pytree "
            f"structure does not match the target step "
            f"({len(_flatten(src))} vs {len(_flatten(tgt))} leaves) — "
            f"different model/optimizer config")


def _check_leaf(name, shape, dtype, tgt, component, source):
    if tuple(shape) != tuple(tgt.shape):
        raise CheckpointReshardError(
            f"{source}: component {component!r} leaf {name}: saved "
            f"shape {tuple(shape)} cannot be resharded into target shape "
            f"{tuple(tgt.shape)}")
    if dtype != _dtype_name(tgt):
        raise CheckpointReshardError(
            f"{source}: component {component!r} leaf {name}: saved "
            f"dtype {dtype} != target dtype {_dtype_name(tgt)} "
            f"(reshard never casts — masters must stay bit-exact)")


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x)


def reshard_state(host_state, target_state, *, component: str = "state",
                  source: str = "<checkpoint>", stats_out=None):
    """Copy a host checkpoint tree into ``target_state``'s own tensors
    (``copy_``; nothing is rebound, so a captured graph goes on reading
    and writing the same memory) and return ``target_state``.  The
    structure, each leaf's shape and dtype are checked first, as the JAX
    function checks them (:class:`CheckpointReshardError` naming the leaf;
    nothing is cast).  Chaos hook ``ckpt.reshard`` fires once first.
    ``stats_out`` gets the JAX function's counts (every leaf a copy)."""
    if _chaos.active():
        _chaos.hook("ckpt.reshard", component=component, source=source)
    _check_structure(host_state, target_state, component, source)
    pairs = list(zip(_flatten(target_state), _flatten(host_state)))
    for (name, tgt), (_, src) in pairs:
        if isinstance(tgt, torch.Tensor):
            if not hasattr(src, "shape"):
                raise CheckpointReshardError(
                    f"{source}: component {component!r} leaf {name}: "
                    f"saved {type(src).__name__} has no array to restore")
            _check_leaf(name, src.shape, _dtype_name(src), tgt, component,
                        source)
    moved = 0
    with torch.no_grad():
        for (name, tgt), (_, src) in pairs:
            if isinstance(tgt, torch.Tensor):
                tgt.copy_(_as_tensor(src))
                moved += tgt.numel() * tgt.element_size()
    if stats_out is not None:
        n = sum(isinstance(t, torch.Tensor) for (_, t), _ in pairs)
        stats_out.update(leaves=n, zero_copy=0, copied=n,
                         bytes_moved=moved,
                         per_leaf=[(name, "host") for (name, t), _ in pairs
                                   if isinstance(t, torch.Tensor)])
    return target_state


def reshard_streamed(skeleton, streamed_meta: dict, target_state, *,
                     base_dir: str, component: str = "state",
                     source: str = "<checkpoint>"):
    """Copy a schema-3 component from its shard files into
    ``target_state``'s own tensors, each shard into the slice its index
    names (so a state that the JAX package wrote on a mesh of any shape
    lands whole), through one pinned host buffer for a card target.
    Validation and the chaos hook as :func:`reshard_state`.  Returns
    ``(target_state, stats)``, ``stats["peak_host_bytes"]`` the largest
    host buffer held."""
    if _chaos.active():
        _chaos.hook("ckpt.reshard", component=component, source=source)
    _check_structure(skeleton, target_state, component, source)
    pairs = list(zip(_flatten(target_state), _flatten(skeleton)))
    leaves_meta = streamed_meta["leaves"]
    for (name, tgt), (_, src) in pairs:
        if not isinstance(src, _StreamedLeaf):
            continue
        if not isinstance(tgt, torch.Tensor):
            raise CheckpointReshardError(
                f"{source}: component {component!r} leaf {name}: saved "
                f"array has no array counterpart in the target step")
        meta = leaves_meta[src.idx]
        _check_leaf(name, meta["shape"], meta["dtype"], tgt, component,
                    source)
    stats = {"peak_host_bytes": 0, "shard_reads": 0}
    staging = _Staging()
    with torch.no_grad():
        for (name, tgt), (_, src) in pairs:
            if not isinstance(src, _StreamedLeaf):
                if isinstance(tgt, torch.Tensor):
                    tgt.copy_(_as_tensor(src))
                continue
            meta = leaves_meta[src.idx]
            for sh in meta["shards"]:
                n = sh["nbytes"]
                if tgt.is_cuda:
                    host = staging(n)
                    raw = _read_into(base_dir, streamed_meta["dir"], sh,
                                     host.numpy(), source)
                    block = host[:n]
                else:
                    raw = _read_into(base_dir, streamed_meta["dir"], sh,
                                     np.empty(n, np.uint8), source)
                    block = torch.from_numpy(raw)
                stats["shard_reads"] += 1
                stats["peak_host_bytes"] = max(stats["peak_host_bytes"], n)
                shape = tuple(b - a for a, b in sh["index"])
                dst = tgt[tuple(slice(a, b) for a, b in sh["index"])]
                val = block.view(tgt.dtype).reshape(shape) if n else \
                    torch.empty(shape, dtype=tgt.dtype)
                dst.copy_(val)
    return target_state, stats


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


class SaveHandle:
    """Error-surfacing handle for one (possibly async) save: ``wait()``
    blocks until the write is durable and re-raises what the worker
    hit."""

    def __init__(self, step: int, path: str):
        self.step = step
        self.path = path
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None

    def _finish(self, exc: Optional[BaseException] = None):
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"checkpoint save for step {self.step} still in flight "
                f"after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self.path


def _calls_meta(train_step) -> Optional[dict]:
    calls = getattr(train_step, "calls", None)
    return {"train_step_calls": int(calls)} if isinstance(calls, int) \
        else None


def _restore_calls(train_step, manifest) -> None:
    """Set the step's call count (which seeds its dropout generators) back
    from a manifest's ``train_step_calls``; a manifest without it (the
    JAX package's) leaves the count as it is."""
    calls = (manifest or {}).get("train_step_calls")
    if calls is not None and hasattr(train_step, "calls"):
        train_step.calls = int(calls)


def state_to_save(train_step):
    """``(state, writes)``: the state a checkpoint of ``train_step`` holds,
    and whether this process writes it.  A ZeRO step
    (``parallel.zero.ZeroTrainStep``) gathers its sharded leaves whole (a
    collective: every rank calls it), as the JAX package's saved arrays
    are, and only its rank 0 writes; any other step writes its own
    state."""
    gather = getattr(train_step, "_checkpoint_state", None)
    if gather is None:
        return train_step.state, True
    return gather(), bool(train_step._writes_checkpoint)


def saved_barrier(train_step):
    """After a checkpoint write: the ranks of a ZeRO step wait for the
    writer, so none reads the files before they exist."""
    barrier = getattr(train_step, "_checkpoint_barrier", None)
    if barrier is not None:
        barrier()


def restore_target(train_step):
    """What a restore copies into: ``train_step`` itself, or for a ZeRO
    step an object whose ``state`` has the whole leaves on the host (the
    checkpoint's shapes), which the step's ``load_state`` then cuts into
    this rank's rows."""
    make = getattr(train_step, "_restore_target", None)
    if make is None:
        return train_step
    import types
    return types.SimpleNamespace(state=make())


class CheckpointManager:
    """Atomic, rolling, optionally async checkpoints under one directory,
    as the JAX class: ``<directory>/ckpt_<step>.pkl`` (and
    ``ckpt_<step>.shards/`` for :meth:`save_sharded`), the ``keep_n``
    newest kept after each save, :meth:`restore_or_initialize` scanning
    newest to oldest past corrupt checkpoints.

    :meth:`save_sharded` records the step's call count
    (``train_step.calls``, which seeds its dropout generators) in the
    manifest as ``train_step_calls``, and :meth:`restore_resharded` sets
    it back, so a resumed run draws the masks the uninterrupted run
    draws; a checkpoint without it (the JAX package's, whose dropout
    keys on the step count) leaves ``calls`` as it is."""

    def __init__(self, directory: str, keep_n: int = 3):
        if keep_n < 1:
            raise ValueError(f"keep_n must be >= 1, got {keep_n}")
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._queue: collections.deque = collections.deque()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        #: filled by save_sharded / restore_resharded
        self.last_save_stats: dict = {}
        self.last_restore_stats: dict = {}

    # -- paths -------------------------------------------------------------
    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.pkl")

    def shard_dir_for(self, step: int) -> str:
        """Schema-3 shard-file directory for ``step``."""
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.shards")

    def all_steps(self) -> list:
        """Step numbers with a final-path checkpoint file, ascending
        (presence only; validity is decided at restore)."""
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for name in names:
            m = _CKPT_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _sweep_tmp(self):
        # debris of killed writers: partial container tmp files, partial
        # shard tmp files, and shard directories whose manifest never
        # committed
        names = os.listdir(self.directory)
        final = set(names)
        for name in names:
            path = os.path.join(self.directory, name)
            if ".pkl.tmp." in name:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            m = _SHARD_DIR_RE.match(name)
            if m:
                if f"ckpt_{m.group(1)}.pkl" not in final:
                    shutil.rmtree(path, ignore_errors=True)
                    continue
                try:
                    for sub in os.listdir(path):
                        if ".bin.tmp." in sub:
                            os.unlink(os.path.join(path, sub))
                except OSError:
                    pass

    def _retain(self, just_wrote: int):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if len(steps) > self.keep_n else []:
            if s == just_wrote:
                continue
            try:
                os.unlink(self.path_for(s))
            except OSError:
                pass
            shutil.rmtree(self.shard_dir_for(s), ignore_errors=True)

    # -- save --------------------------------------------------------------
    def _write(self, step: int, host_components: dict,
               layouts: Optional[dict] = None, plan=None,
               streamed: Optional[dict] = None, sweep: bool = True,
               extra_manifest: Optional[dict] = None) -> str:
        if sweep:
            self._sweep_tmp()
        path = write_checkpoint_file(self.path_for(step), host_components,
                                     to_host=False, layouts=layouts,
                                     plan=plan, streamed=streamed,
                                     extra_manifest=extra_manifest)
        self._retain(step)
        return path

    def save(self, step: int, /, **components) -> str:
        """Blocking atomic save (one synchronize for the host copy);
        returns the final path."""
        handle = SaveHandle(step, self.path_for(step))
        try:
            with _spans.span("ckpt.save", step=step, mode="sync"):
                self._write(step, _to_host(components))
        except BaseException as e:
            handle._finish(e)
            raise
        handle._finish()
        return handle.path

    def save_sharded(self, step: int, train_step, /, **extra) -> str:
        """Blocking atomic schema-3 save of a live train step: component
        ``"state"`` is ``train_step.state``, each tensor streamed to its
        own shard file under :meth:`shard_dir_for` (per-file CRC, atomic
        per-file writes, ``ckpt.shard_write`` chaos hook per file), the
        manifest container committed last.  Extra components ride along.
        ``last_save_stats`` gets ``shard_bytes_peak_host`` (the largest
        host buffer the save touched) and ``bytes`` (all shard bytes)."""
        if "state" in extra:
            raise ValueError("save_sharded owns the 'state' component; "
                             "pass other data under different names")
        state, writes = state_to_save(train_step)
        components = {"state": state, **extra}
        handle = SaveHandle(step, self.path_for(step))
        try:
            with _spans.span("ckpt.save", step=step, mode="sharded"):
                if writes:
                    self._save_sharded(step, train_step, components)
        except BaseException as e:
            handle._finish(e)
            raise
        finally:
            saved_barrier(train_step)
        handle._finish()
        return handle.path

    def _save_sharded(self, step, train_step, components):
        self._sweep_tmp()
        sdir = self.shard_dir_for(step)
        if os.path.isdir(sdir):   # same-step re-save: fresh dir
            shutil.rmtree(sdir, ignore_errors=True)
        skeletons, streamed, peak = stream_components_to_dir(sdir,
                                                             components)
        self.last_save_stats = {
            "shard_bytes_peak_host": peak,
            "bytes": sum(sh["nbytes"] for m in streamed.values()
                         for leaf in m["leaves"] if leaf
                         for sh in leaf["shards"])}
        self._write(step, skeletons, plan=getattr(train_step, "plan", None),
                    streamed=streamed, sweep=False,
                    extra_manifest=_calls_meta(train_step))

    def save_async(self, step: int, /, **components) -> SaveHandle:
        """Async atomic save.  The host copy is taken here, on the caller
        thread (see :func:`snapshot_state`: complete before this returns, so the
        loop may update the tensors in place at once); pickling and IO run
        on the manager's worker thread.  Errors surface on the handle's
        ``wait()`` (and on :meth:`wait` / :meth:`close`)."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        # the caller-thread cost of an async save is this copy: spanned
        # apart from the worker's write
        with _spans.span("ckpt.save.submit", step=step):
            host = snapshot_state(components)
        handle = SaveHandle(step, self.path_for(step))
        with self._lock:
            self._queue.append((step, host, handle))
            if self._worker is None:
                # not a daemon: the interpreter's exit waits for the
                # queued saves to land (a daemon killed at exit would
                # abort the process inside torch)
                self._worker = threading.Thread(
                    target=self._drain, name="apex-tpu-torch-ckpt-writer")
                self._worker.start()
        return handle

    def _drain(self):
        while True:
            with self._lock:
                if not self._queue:
                    # cleared under the lock: a save queued from here on
                    # starts a new worker
                    self._worker = None
                    return
                step, host, handle = self._queue.popleft()
            try:
                with _spans.span("ckpt.save", step=step, mode="async"):
                    self._write(step, _map_leaves(host, _host_leaf))
            except BaseException as e:  # surfaced via handle.wait()
                handle._finish(e)
            else:
                handle._finish()

    def wait(self):
        """Block until every queued save is durable; re-raise the first
        error (each handle also carries its own)."""
        while True:
            with self._lock:
                pending = list(self._queue)
                worker = self._worker
            if worker is not None:
                worker.join()
            with self._lock:
                if not self._queue and self._worker is None:
                    break
        for *_, handle in pending:
            if handle.done() and handle._exc is not None:
                raise handle._exc

    def close(self):
        self.wait()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- restore -----------------------------------------------------------
    def restore(self, step: Optional[int] = None, *,
                return_manifest: bool = False):
        """Load and validate one checkpoint (the latest when ``step`` is
        None): host numpy arrays (CPU bf16 tensors for bf16)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory!r}")
        with _spans.span("ckpt.restore", step=step):
            return read_checkpoint_file(self.path_for(step),
                                        return_manifest=return_manifest)

    def restore_resharded(self, train_step, step: Optional[int] = None):
        """Restore one checkpoint (the latest when ``step`` is None) into
        ``train_step.state``'s own tensors, whatever mesh wrote it, and
        return ``(step_no, extras)``, the components other than
        ``"state"``.  Schema-3 files stream shard by shard through one
        pinned buffer (:func:`reshard_streamed`); older ones restore their
        gathered arrays with a warning.  A recorded call count is set back
        on ``train_step``.  :class:`CheckpointReshardError` when the
        checkpoint does not fit the step, :class:`CheckpointCorruptError`
        when it fails validation."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory!r}")
        with _spans.span("ckpt.restore", step=step, mode="resharded"):
            return self._restore_resharded(train_step, step)

    def _restore_resharded(self, train_step, step):
        target = restore_target(train_step)
        self._restore_into(train_step, target.state, step)
        if target is not train_step:
            train_step.load_state(target.state)
        extras = self._last_extras
        del self._last_extras
        return step, extras

    def _restore_into(self, train_step, state, step):
        path = self.path_for(step)
        comps, manifest = read_checkpoint_file(
            path, return_manifest=True, assemble_streamed=False)
        if "state" not in comps:
            raise CheckpointReshardError(
                f"{path}: no 'state' component to reshard "
                f"(components: {sorted(comps)}) — written by "
                f"save_sharded / ElasticTrainer.save?")
        schema = (manifest or {}).get("schema", 0)
        comp_meta = (manifest or {}).get("components", {})
        streamed = (comp_meta.get("state") or {}).get("streamed")
        if schema < 2:
            warnings.warn(
                f"{path}: schema-{schema or 'legacy'} checkpoint "
                f"predates sharding metadata — restoring its "
                f"(gathered, full) arrays into the target layout "
                f"without save-side validation", stacklevel=2)
        elif streamed is None:
            warnings.warn(
                f"{path}: schema-{schema} checkpoint predates shard "
                f"streaming — gathered restore (re-save to upgrade "
                f"it to the schema-3 per-shard layout)", stacklevel=2)
        if streamed is not None:
            _, stats = reshard_streamed(
                comps["state"], streamed, state,
                base_dir=self.directory, component="state", source=path)
            self.last_restore_stats = {"mode": "streamed",
                                       "schema": schema, **stats}
        else:
            host_state = comps["state"]
            gathered = sum(getattr(x, "nbytes", 0) for _, x in
                           _flatten(host_state))
            rs: dict = {}
            reshard_state(host_state, state, component="state",
                          source=path, stats_out=rs)
            self.last_restore_stats = {
                "mode": "gathered", "schema": schema,
                "peak_host_bytes": gathered,
                "zero_copy_leaves": rs.get("zero_copy", 0),
                "copied_leaves": rs.get("copied", 0),
                "reshard_bytes_moved": rs.get("bytes_moved", 0)}
        _restore_calls(train_step, manifest)
        extras = {}
        for k, v in comps.items():
            if k == "state":
                continue
            k_streamed = (comp_meta.get(k) or {}).get("streamed")
            if k_streamed is not None:   # small ride-along arrays
                v = _assemble_tree(v, k_streamed, self.directory, path)
            extras[k] = v
        self._last_extras = extras

    def restore_or_initialize(self, initialize: Optional[Callable] = None):
        """Auto-resume: ``(step, components)`` from the newest checkpoint
        that validates, scanning past corrupt ones with a warning;
        ``(None, initialize())`` (or ``(None, None)``) when none does."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step)
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"skipping corrupt checkpoint for step {step}: {e}",
                    stacklevel=2)
            except FileNotFoundError:
                continue
        return None, (initialize() if initialize is not None else None)


# ---------------------------------------------------------------------------
# snapshots and BadStepGuard
# ---------------------------------------------------------------------------


class _Snapshot:
    """Host copies of a state's tensors in pinned buffers (reused from
    one take to the next), taken by non-blocking copies on the current
    stream and complete when ``event`` has (None on the CPU)."""

    def __init__(self):
        self.tree = None
        self.event = None

    def take(self, state):
        bufs = [] if self.tree is None else [
            t for _, t in _flatten(self.tree) if isinstance(t, torch.Tensor)]
        it = iter(bufs)
        devs = set()

        def conv(x):
            if not isinstance(x, torch.Tensor):
                return x
            x = x.detach()
            h = next(it, None)
            if h is None or h.shape != x.shape or h.dtype != x.dtype:
                h = torch.empty(x.shape, dtype=x.dtype,
                                pin_memory=x.is_cuda)
            h.copy_(x, non_blocking=x.is_cuda)
            if x.is_cuda:
                devs.add(x.device)
            return h
        self.tree = _map_leaves(state, conv)
        self.event = None
        if devs:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(devs.pop()))
        return self

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.tree


def snapshot_state(state):
    """Host copy of a state tree (pinned CPU tensors for the card's, CPU
    tensors cloned, everything else passed through), the rollback anchor
    of :class:`BadStepGuard` and the host copy every save takes; returns
    once the copy is complete, so an in-place replay that follows cannot
    reach it."""
    return _Snapshot().take(state).wait()


def restore_state(host_state, into=None, device=None):
    """Put a :func:`snapshot_state` copy (or any host tree) back.  With
    ``into``, copy each leaf into that state's own tensors with ``copy_``
    (never rebinding them) and return ``into``; else return new tensors
    on ``device`` (the card unless ``"cpu"``)."""
    if into is not None:
        _check_structure(host_state, into, "state", "<snapshot>")
        with torch.no_grad():
            for (_, dst), (_, src) in zip(_flatten(into),
                                          _flatten(host_state)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(_as_tensor(src))
        return into
    from ..kernels.dispatch import resolve_device
    dev = resolve_device(device)
    return _map_leaves(host_state, lambda x: _as_tensor(x).to(dev)
                       if isinstance(x, (np.ndarray, torch.Tensor)) else x)


class _HostView:
    """``__cuda_array_interface__`` of a pinned host tensor, so that
    ``torch.as_tensor`` makes a card tensor over the same memory (pinned
    memory is mapped into the card's address space)."""

    def __init__(self, t):
        self.__cuda_array_interface__ = {
            "shape": tuple(t.shape), "typestr": "<i4",
            "data": (t.data_ptr(), False), "version": 3, "strides": None}


class _FlagRing:
    """The guard's slots for device flags: int32 pinned host memory that
    the card writes through a mapped view (an elementwise kernel, no
    device-to-host copy), each write followed by a recorded event."""

    def __init__(self, n, device):
        self.host = torch.zeros(n, dtype=torch.int32, pin_memory=True)
        with torch.cuda.device(device):
            self.dev = torch.as_tensor(_HostView(self.host), device=device)
        self.next = 0

    def put(self, flag):
        i = self.next
        self.next = (i + 1) % self.host.numel()
        torch.bitwise_or(flag.reshape(()).to(torch.int32), 0,
                         out=self.dev[i])
        ev = torch.cuda.Event()
        ev.record()
        return (self, i, ev)


def _is_ready(item):
    return not isinstance(item, tuple) or item[2].query()


def _value(item):
    if not isinstance(item, tuple):
        return int(item)
    ring, i, ev = item
    if not ev.query():      # a consumed-when-ready flag waits for nothing
        ev.synchronize()
    return int(ring.host[i])


class BadStepGuard:
    """Escalation above the scaler's silent skip loop, as the JAX class:
    after ``patience`` consecutive overflow-skipped steps it escalates
    through ``policy``, one stage an escalation, the last stage sticky:
    ``"warn"``; ``"rollback"`` (the last snapshot copied into the live
    tensors, keeping the current, already halved, loss scale);
    ``"raise"`` (:class:`TrainingDivergedError`).

    The clean path adds no host sync: a device flag is copied into a slot
    of a ring of mapped pinned memory and an event recorded after it;
    flags are consumed once their events have completed, and read
    blocking only past ``max_pending`` (default ``4 * patience``) or in
    :meth:`flush`.  A snapshot (at :meth:`attach` and after each
    ``snapshot_interval`` clean steps, with ``"rollback"`` in the policy)
    is a set of non-blocking device-to-host copies into pinned buffers
    behind an event, waited for only by a rollback."""

    def __init__(self, patience: int = 5,
                 policy: Sequence[str] | str = ("warn", "rollback", "raise"),
                 snapshot_interval: int = 100,
                 max_pending: Optional[int] = None,
                 on_event: Optional[Callable] = None):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if isinstance(policy, str):
            policy = (policy,)
        policy = tuple(policy)
        for stage in policy:
            if stage not in ("warn", "rollback", "raise"):
                raise ValueError(f"unknown guard policy stage {stage!r}")
        if not policy:
            raise ValueError("policy must name at least one stage")
        self.patience = patience
        self.policy = policy
        self.snapshot_interval = snapshot_interval
        self.max_pending = (4 * patience if max_pending is None
                            else max_pending)
        self.on_event = on_event
        self._pending: collections.deque = collections.deque()
        self._ring = None
        self._streak = 0
        self._escalations = 0
        self._clean_since_snapshot = 0
        self._snapshot: Optional[_Snapshot] = None
        self._step = None       # attached TrainStep (fused path)
        self.stats = {"observed": 0, "skipped": 0, "escalations": 0,
                      "rollbacks": 0}

    # -- wiring ------------------------------------------------------------
    def attach(self, train_step):
        """Attach to a fused ``TrainStep`` (or any object with a ``.state``
        carrying ``scaler.overflow``): the step notifies the guard after
        each call; the first rollback snapshot is taken now."""
        self._step = train_step
        train_step._guard = self
        if "rollback" in self.policy:
            self._snapshot = _Snapshot().take(train_step.state)
        return train_step

    def attach_optimizer(self, optimizer):
        """Attach to an amp-processed optimizer of the eager loop.  Under
        ``defer_scale_update=True`` each ``step()`` observes the deferred
        scaler's device overflow flag (read before the step takes it);
        on the ordinary path a skipped step never reaches this wrapper
        (``scale_loss``'s one-shot patch replaces it) and notifies
        ``stash._guard`` itself.  The eager loop owns no state to
        snapshot, so ``"rollback"`` degrades to a warning here."""
        guard = self
        stash = getattr(optimizer, "_amp_stash", None)
        if stash is not None:
            stash._guard = self
        orig_step = optimizer.step

        def guarded_step(closure=None):
            flag = 0
            if stash is not None:
                deferred = getattr(stash, "_deferred_scaler", None)
                if deferred is not None:
                    flag = deferred.state.overflow
            ret = orig_step() if closure is None else orig_step(closure)
            guard.observe(flag)
            return ret

        optimizer.step = guarded_step
        return optimizer

    # -- observation -------------------------------------------------------
    def _hold(self, flag):
        if not isinstance(flag, torch.Tensor):
            return flag
        if not flag.is_cuda:
            return int(flag)        # a host value: read now, no sync
        if self._ring is None:
            self._ring = _FlagRing(self.max_pending + 2, flag.device)
        return self._ring.put(flag)

    def observe(self, skip_flag):
        """Record one step's skip flag (a device int32 scalar, a Python
        int or a bool); device flags are consumed lazily."""
        self.stats["observed"] += 1
        self._pending.append(self._hold(skip_flag))
        self._drain(block=False)
        while len(self._pending) > self.max_pending:
            self._consume(self._pending.popleft())

    def flush(self):
        """Consume every pending flag (blocking)."""
        self._drain(block=True)

    def _drain(self, block: bool):
        while self._pending:
            if not block and not _is_ready(self._pending[0]):
                return
            self._consume(self._pending.popleft())

    def _consume(self, item):
        skipped = bool(_value(item))
        if skipped:
            self.stats["skipped"] += 1
            self._streak += 1
            self._clean_since_snapshot = 0
            if self._streak >= self.patience:
                self._streak = 0
                self._escalate()
        else:
            self._streak = 0
            self._clean_since_snapshot += 1
            if (self._step is not None and "rollback" in self.policy
                    and self._clean_since_snapshot
                    >= self.snapshot_interval):
                self._refresh_snapshot()

    def _refresh_snapshot(self):
        self._snapshot.take(self._step.state)
        self._clean_since_snapshot = 0

    # -- escalation --------------------------------------------------------
    def _escalate(self):
        stage = self.policy[min(self._escalations, len(self.policy) - 1)]
        self._escalations += 1
        self.stats["escalations"] += 1
        event = {"stage": stage, "escalation": self._escalations,
                 "patience": self.patience}
        if self.on_event is not None:
            self.on_event(event)
        msg = (f"BadStepGuard: {self.patience} consecutive overflow-skipped "
               f"steps (escalation #{self._escalations}, stage {stage!r})")
        if stage == "raise":
            raise TrainingDivergedError(
                msg + " — loss scale has collapsed; training is diverging")
        warnings.warn(msg, stacklevel=3)
        if stage == "rollback":
            self._rollback()

    def _rollback(self):
        if self._step is None or self._snapshot is None:
            warnings.warn(
                "BadStepGuard: rollback requested but no snapshot is "
                "available (eager surface, or attach() not called) — "
                "degrading to warn", stacklevel=4)
            return
        state = self._step.state
        snap = self._snapshot.wait()
        keep = state.scaler.loss_scale.clone()
        restore_state(snap, into=state)
        # keep the CURRENT (post-halving) loss scale: restoring the
        # snapshot's larger scale would walk straight back into the storm
        with torch.no_grad():
            state.scaler.loss_scale.copy_(keep)
            state.scaler.unskipped.zero_()
            state.scaler.overflow.zero_()
        self.stats["rollbacks"] += 1
