"""Checkpoint save and load, the PyTorch counterpart of
``apex_tpu/utils/checkpoint.py``: the ``torch.save``/``torch.load`` role for
the three-part {model, optimizer, amp} checkpoint of the reference's
documented workflow, and a fused step's whole state.

``save_checkpoint`` and ``load_checkpoint`` go through the one write path
of :mod:`apex_tpu_torch.runtime.resilience` (an atomic write, a manifest
with a CRC32 a component, the JAX package's container); arrays come back
as CPU tensors, which ``load_state_dict`` takes (the JAX package's
``load_checkpoint`` gives host numpy, which its ``load_state_dict``
takes).

``save_train_state`` / ``restore_train_state`` / ``AsyncTrainStateSaver``
keep the JAX names and the atomic directory contract: the write lands in a
sibling tmp directory, which replaces ``path`` by a rename aside and a
rename in, so a kill mid-save leaves the previous directory readable.  The
JAX versions write through orbax, which this package does not use: the
directory here holds the schema-3 shard files of
``resilience.stream_components_to_dir`` (one file a tensor, raw bytes, a
CRC32 each) and their manifest container, ``checkpoint.pkl``.  Orbax
directories (the JAX package's ``save_train_state``) are not read: restore
raises :class:`~apex_tpu_torch.runtime.resilience.CheckpointCorruptError`
on one.  ``restore_train_state`` copies into the step's own tensors, so a
captured step replays the restored state with no recapture.
"""
from __future__ import annotations

import os
import shutil
import threading

import numpy as np

from ..runtime.resilience import (  # noqa: F401 — re-exported surface
    CheckpointCorruptError, _as_tensor, _calls_meta, _map_leaves,
    _restore_calls, read_checkpoint_file, reshard_streamed, snapshot_state,
    stream_components_to_dir, write_checkpoint_file)

#: the manifest container inside a train-state directory
STATE_FILE = "checkpoint.pkl"


def save_checkpoint(path: str, **components):
    """``save_checkpoint(path, model=model.state_dict(), optimizer=
    opt.state_dict(), amp=amp.state_dict(), epoch=...)``: any picklable
    values; tensors anywhere in the trees are fetched to the host first.
    Atomic (tmp + fsync + rename) and manifested, as
    :class:`~apex_tpu_torch.runtime.resilience.CheckpointManager`'s."""
    write_checkpoint_file(path, dict(components))


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint written by :func:`save_checkpoint` (or by the JAX
    package's), validating its manifest first:
    :class:`CheckpointCorruptError` on a checksum or schema mismatch;
    manifest-less legacy pickles load with a warning.  Arrays come back as
    CPU tensors; feed the sub-dicts to the matching ``load_state_dict``."""
    return _map_leaves(read_checkpoint_file(path), lambda x: _as_tensor(x)
                       if isinstance(x, np.ndarray) else x)


def _write_state_dir(path: str, state, meta) -> None:
    """The atomic directory write of a (host or device) state tree."""
    final = os.path.abspath(path)
    tmp = f"{final}.tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    skeletons, streamed, _ = stream_components_to_dir(tmp, {"state": state})
    # the shard files resolve beside the manifest, whatever the
    # directory's final name
    for m in streamed.values():
        m["dir"] = "."
    write_checkpoint_file(os.path.join(tmp, STATE_FILE), skeletons,
                          to_host=False, streamed=streamed,
                          extra_manifest=meta)
    old = None
    if os.path.exists(final):
        # rename aside + rename in: never a moment where `final` is a
        # partial tree (os.rename cannot replace a non-empty directory)
        old = f"{final}.old.{os.getpid()}"
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def save_train_state(path: str, step) -> None:
    """Checkpoint a fused step's whole state (masters, half copies,
    optimizer slots, scaler, buffers, step count) and its call count into
    the directory ``path``, atomically (see the module docstring).  Resume
    is exact: the fp32 masters round-trip bit for bit."""
    _write_state_dir(path, step.state, _calls_meta(step))


class AsyncTrainStateSaver:
    """Asynchronous :func:`save_train_state`: ``save`` returns once the
    state's host copy is complete (non-blocking copies into pinned
    buffers, then one synchronize of the current stream, so the next
    in-place step cannot reach it); the files are written on a worker
    thread.  A second ``save`` waits for the first (one write in flight).
    Call ``wait`` (or close the saver) before reading the checkpoint::

        with AsyncTrainStateSaver() as saver:
            for i, batch in enumerate(loader):
                loss = step(*batch)
                if i % 1000 == 0:
                    saver.save(f"ckpt/step_{i}", step)

    Restore with :func:`restore_train_state`."""

    def __init__(self):
        self._thread = None
        self._exc = None

    def save(self, path: str, step) -> None:
        self.wait()
        host = snapshot_state(step.state)
        meta = _calls_meta(step)

        def write():
            try:
                _write_state_dir(path, host, meta)
            except BaseException as e:  # surfaced on wait()
                self._exc = e
        # not a daemon: the interpreter's exit waits for the write
        self._thread = threading.Thread(
            target=write, name="apex-tpu-torch-train-state-writer")
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight (if any) is durable; re-raise
        its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def restore_train_state(path: str, step) -> None:
    """Restore a :func:`save_train_state` directory into ``step.state``'s
    own tensors (and its call count).  The step must be built from the
    same model and optimizer config (a typed ``CheckpointReshardError``
    names the first leaf that differs).  An orbax directory raises
    :class:`CheckpointCorruptError`."""
    manifest_path = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.isfile(manifest_path):
        raise CheckpointCorruptError(
            f"{path}: no {STATE_FILE}: not a directory written by "
            f"save_train_state (orbax directories, which the JAX package's "
            f"save_train_state writes, are not read)")
    comps, manifest = read_checkpoint_file(
        manifest_path, return_manifest=True, assemble_streamed=False)
    streamed = manifest["components"]["state"]["streamed"]
    reshard_streamed(comps["state"], streamed, step.state,
                     base_dir=os.path.dirname(manifest_path),
                     source=manifest_path)
    _restore_calls(step, manifest)
