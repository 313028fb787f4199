"""Coordinator KV stores, the PyTorch counterpart of
``apex_tpu/cluster/kvstore.py``: the substrate the cluster membership
protocol runs on.

Every piece of cluster state (member registrations, heartbeat
timestamps, the epoch counter, membership views, acks) is a string
value under a string key in ONE logical store, so the same protocol
code runs against three backends:

* :class:`MemoryKV`: an in-process dict, the deterministic test
  substrate (multi-member simulation with a fake clock).
* :class:`FileKV`: a directory of one-file-per-key entries with atomic
  writes; it crosses REAL process boundaries with no server, which is
  how :func:`~apex_tpu_torch.cluster.runtime.spawn_member_process`'s
  children heartbeat and how a shared filesystem can stand in for a
  coordinator.
* :class:`JaxCoordinatorKV` (the JAX package's name, kept): the
  ``torch.distributed`` default store of the live process group (the
  rendezvous ``TCPStore``), for real multi-process runs;
  ``parallel.distributed``'s presence registry goes through it.

Keys are flat strings with ``/`` separators by convention
(``apex_tpu/cluster/<namespace>/...``); ``scan(prefix)`` is the only
query primitive the protocol needs.
"""
from __future__ import annotations

import os
import threading
import urllib.parse
from typing import Dict, Optional


class KVStore:
    """Protocol: the four operations the membership layer uses."""

    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def set(self, key: str, value: str) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def scan(self, prefix: str) -> Dict[str, str]:
        """Every ``key: value`` whose key starts with ``prefix``."""
        raise NotImplementedError


class MemoryKV(KVStore):
    """Dict-backed store for in-process multi-member simulation."""

    def __init__(self):
        self._data: Dict[str, str] = {}
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            return self._data.get(key)

    def set(self, key, value):
        with self._lock:
            self._data[key] = str(value)

    def delete(self, key):
        with self._lock:
            self._data.pop(key, None)

    def scan(self, prefix):
        with self._lock:
            return {k: v for k, v in self._data.items()
                    if k.startswith(prefix)}


class FileKV(KVStore):
    """One-file-per-key store under a directory: crosses process
    boundaries through the filesystem.

    Writes are atomic (tmp + rename, the checkpoint writer's durability
    idiom) so a reader never sees a torn value; keys are percent-encoded
    into filenames, so any string key works, and a writer's tmp debris
    never scans."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory,
                            urllib.parse.quote(key, safe=""))

    def get(self, key):
        try:
            with open(self._path(key), "r") as f:
                return f.read()
        except (FileNotFoundError, OSError):
            return None

    def set(self, key, value):
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(str(value))
        os.replace(tmp, path)

    def delete(self, key):
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def scan(self, prefix):
        out = {}
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for name in names:
            if ".tmp." in name:
                continue
            key = urllib.parse.unquote(name)
            if key.startswith(prefix):
                v = self.get(key)
                if v is not None:
                    out[key] = v
        return out


class JaxCoordinatorKV(KVStore):
    """The process group's store (``torch.distributed``'s default store,
    the rendezvous every rank shares), adapted to the protocol.  Only
    constructible once a process group is up (:func:`client` returns None
    otherwise).  A ``Store`` has no scan and no delete, as the JAX
    coordinator service has none: :meth:`scan` walks an index key the
    setters maintain (each addition one ``compare_set``, so ranks that
    register at once lose no entry), and :meth:`delete` writes the JAX
    tombstone ``""``, which :meth:`scan` skips.  A key this instance has
    indexed once is set with no further round trip (a heartbeat is one
    ``set``); :meth:`scan` reads its keys in one ``multi_get``; and
    :meth:`prune`, which the coordinator calls at each new epoch, takes
    older epochs' views and acks out of the index, so the index holds
    what one epoch writes rather than every key ever set."""

    _INDEX = "apex_tpu/cluster/__index__"

    def __init__(self, client=None):
        if client is None:
            client = self.client()
        if client is None:
            raise RuntimeError(
                "no torch.distributed process group store: call "
                "apex_tpu_torch.parallel.init_distributed() first, or use "
                "FileKV/MemoryKV")
        self._client = client
        #: keys seen in the index: it loses entries only through
        #: :meth:`prune`, whose keys nobody sets again
        self._indexed = set()

    @staticmethod
    def client():
        """The live process group's default store, or None (no process
        group)."""
        try:
            import torch.distributed as dist
            if not dist.is_available() or not dist.is_initialized():
                return None
            return dist.distributed_c10d._get_default_store()
        except Exception:       # noqa: BLE001: no store, no client
            return None

    def _raw(self, key: str) -> Optional[str]:
        try:
            if not self._client.check([key]):
                return None
            return self._client.get(key).decode()
        except Exception:       # noqa: BLE001: the store cannot tell
            return None

    def _index(self):
        return [k for k in (self._raw(self._INDEX) or "").split("\n") if k]

    def get(self, key):
        return self._raw(key)

    def set(self, key, value):
        self._client.set(key, str(value))
        if key in self._indexed:
            return
        while True:
            raw = self._raw(self._INDEX) or ""
            idx = [k for k in raw.split("\n") if k]
            if key in idx:
                break
            want = "\n".join(idx + [key])
            if self._client.compare_set(self._INDEX, raw,
                                        want).decode() == want:
                break
        self._indexed.add(key)

    def prune(self, drop) -> int:
        """Take the keys ``drop(key)`` names out of the index (one
        ``compare_set`` round; the keys stay in the store, readable by
        :meth:`get`).  Only for keys nobody sets again: a later ``set``
        from an instance that indexed the key would not index it anew.
        Returns how many entries went."""
        while True:
            raw = self._raw(self._INDEX) or ""
            idx = [k for k in raw.split("\n") if k]
            keep = [k for k in idx if not drop(k)]
            if len(keep) == len(idx):
                return 0
            want = "\n".join(keep)
            if self._client.compare_set(self._INDEX, raw,
                                        want).decode() == want:
                self._indexed.difference_update(idx)
                self._indexed.update(keep)
                return len(idx) - len(keep)

    def delete(self, key):
        # the store keeps the key (the JAX service has no delete): a
        # tombstone, which scan skips
        try:
            self._client.set(key, "")
        except Exception:       # noqa: BLE001: best-effort, as the JAX one
            pass

    def scan(self, prefix):
        keys = [k for k in self._index() if k.startswith(prefix)]
        try:
            # a setter writes the value before it indexes the key, so
            # every indexed key exists; check first all the same, since a
            # multi_get of a missing key waits out the store's timeout
            if keys and self._client.check(keys):
                values = [v.decode() for v in self._client.multi_get(keys)]
            else:
                values = [self._raw(k) for k in keys]
        except Exception:       # noqa: BLE001: no multi_get, key by key
            values = [self._raw(k) for k in keys]
        return {k: v for k, v in zip(keys, values) if v}


def default_kv() -> KVStore:
    """Resolve the ambient coordination store, strongest first: the live
    process group's store when one is up; else the :class:`FileKV`
    directory a launcher exported (``APEX_TPU_CLUSTER_KV``); else a fresh
    private :class:`MemoryKV` (one process)."""
    client = JaxCoordinatorKV.client()
    if client is not None:
        return JaxCoordinatorKV(client)
    directory = os.environ.get("APEX_TPU_CLUSTER_KV")
    if directory:
        return FileKV(directory)
    return MemoryKV()
