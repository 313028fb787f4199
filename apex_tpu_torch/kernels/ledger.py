"""On-disk calibration ledger: measured kernel A/Bs and plan trials,
keyed by ``(chip, fingerprint)``, the port's copy of
``apex_tpu/kernels/ledger.py`` (the same file, ``default_path``, format
version 1 and record fields, so either package reads the other's file).

A kernel record holds a hand kernel's time and its yardstick's: the keys
keep the JAX names, and on the card ``pallas_us`` is the hand-written
CUDA kernel's time and ``xla_us`` the time of the library call (or the
plain PyTorch version) that computes the same function; ``win`` is
``xla_us / pallas_us``.  Entries are keyed by :func:`chip_name`, the card's
name for a CUDA device, so a TPU's entry never prices the card and one
card's never prices another.  :mod:`apex_tpu_torch.kernels.dispatch`
reads the entries: for ``spec_verify`` the entry decides, for the hand
kernels it is shown beside the decision (see that module).

File format::

    {"version": 1,
     "kernels": {chip: {kernel: {shape_fp: {pallas_us, xla_us, win,
                                            threshold, source, runs}}}},
     "plans":   {chip: {model_fp: {plan_key: {measured_ms, predicted_ms,
                                              plan, source, runs}}}}}

Writes are atomic (tmp + ``os.replace``) and loads are defensive: a
corrupt file or a corrupt entry is skipped, never fatal.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

_ENV_PATH = "APEX_TPU_LEDGER"
_VERSION = 1


def default_path() -> str:
    """``$APEX_TPU_LEDGER`` or ``~/.cache/apex_tpu/kernel_ledger.json``."""
    env = os.environ.get(_ENV_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "apex_tpu",
                        "kernel_ledger.json")


def chip_name(devices=None) -> str:
    """The ledger's chip key: ``torch.cuda.get_device_name()`` of a CUDA
    device ("NVIDIA H100 80GB HBM3", ...), else ``"cpu"``.  ``devices``:
    a device, a tensor or a list of either (the first one counts); None
    means the current CUDA device where CUDA is present.  Entries
    measured on one chip never price another."""
    import torch
    if devices is None:
        if not torch.cuda.is_available():
            return "cpu"
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        ds = list(devices) if isinstance(devices, (list, tuple)) \
            else [devices]
        if not ds:
            return "cpu"
        d = ds[0]
        dev = d.device if isinstance(d, torch.Tensor) else torch.device(d)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    name = _CHIP_NAMES.get(index)
    if name is None:
        name = _CHIP_NAMES[index] = torch.cuda.get_device_name(index)
    return name


#: device index -> name, read once a device
_CHIP_NAMES: dict = {}


def _win(pallas_us, xla_us) -> Optional[float]:
    if not pallas_us or not xla_us or pallas_us <= 0:
        return None
    return xla_us / pallas_us


def _plan_key_str(plan_key) -> str:
    """Normalize a ``Plan.key()`` tuple (or a string) to the ledger's
    string key — JSON object keys must be strings."""
    if isinstance(plan_key, str):
        return plan_key

    def seg(x):
        if isinstance(x, bool):
            return "1" if x else "0"
        if isinstance(x, str):      # tagged v3 segments ("pp4", "remat=…")
            return x
        return str(int(x))

    return "/".join(seg(x) for x in plan_key)


class Ledger:
    """One calibration document, loaded lazily and written atomically.

    Thread-safe; every mutation persists immediately (probe records are
    rare — bench stages and auto-tune trials, never per-step paths).
    """

    _KERNEL_FIELDS = ("pallas_us", "xla_us", "win", "threshold",
                      "source", "runs")

    def __init__(self, path: Optional[str] = None):
        self._path = path or default_path()
        self._lock = threading.RLock()
        self._doc = None                 # loaded lazily

    @property
    def path(self) -> str:
        return self._path

    # -- load / save -------------------------------------------------------

    def _empty(self) -> dict:
        return {"version": _VERSION, "kernels": {}, "plans": {}}

    def _load(self) -> dict:
        if self._doc is not None:
            return self._doc
        doc = self._empty()
        try:
            with open(self._path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            # missing or corrupt file: start empty (never fatal — the
            # ledger is a cache of measurements, not a source of truth)
            raw = None
        if isinstance(raw, dict):
            for section in ("kernels", "plans"):
                sec = raw.get(section)
                if isinstance(sec, dict):
                    doc[section] = self._sanitize(sec)
        self._doc = doc
        return doc

    @staticmethod
    def _sanitize(section: dict) -> dict:
        """Keep only well-formed chip -> key -> fp -> dict(record)
        entries; a corrupt entry is dropped, not propagated."""
        out = {}
        for chip, by_name in section.items():
            if not isinstance(by_name, dict):
                continue
            for name, by_fp in by_name.items():
                if not isinstance(by_fp, dict):
                    continue
                for fp, rec in by_fp.items():
                    if not isinstance(rec, dict):
                        continue
                    out.setdefault(str(chip), {}).setdefault(
                        str(name), {})[str(fp)] = rec
        return out

    def _save(self) -> None:
        doc = self._load()
        d = os.path.dirname(self._path)
        try:
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self._path)
        except OSError:
            # unwritable ledger path: keep the in-memory doc, stay quiet
            # (read-only containers run the same code)
            pass

    def reload(self) -> None:
        with self._lock:
            self._doc = None
            self._load()

    # -- kernel entries ----------------------------------------------------

    def record_kernel(self, chip: str, kernel: str, shape_fp: str, *,
                      pallas_us=None, xla_us=None, threshold=None,
                      source: str = "bench") -> dict:
        """Insert/refresh one kernel probe record; returns the record."""
        with self._lock:
            doc = self._load()
            by_fp = doc["kernels"].setdefault(str(chip), {}).setdefault(
                str(kernel), {})
            prev = by_fp.get(str(shape_fp), {})
            rec = {
                "pallas_us": pallas_us, "xla_us": xla_us,
                "win": _win(pallas_us, xla_us),
                "threshold": threshold, "source": source,
                "runs": int(prev.get("runs", 0)) + 1,
            }
            by_fp[str(shape_fp)] = rec
            self._save()
            return rec

    def lookup_kernel(self, chip: str, kernel: str,
                      shape_fp: str) -> Optional[dict]:
        with self._lock:
            rec = self._load()["kernels"].get(str(chip), {}).get(
                str(kernel), {}).get(str(shape_fp))
            # a record without a usable win ratio cannot decide dispatch
            if rec is None or _win(rec.get("pallas_us"),
                                   rec.get("xla_us")) is None:
                return None
            return dict(rec, win=_win(rec["pallas_us"], rec["xla_us"]),
                        shape_fp=str(shape_fp), kernel=str(kernel),
                        chip=str(chip))

    def kernel_entries(self, chip: str, kernel: str) -> dict:
        """``{shape_fp: record}`` snapshot for one (chip, kernel)."""
        with self._lock:
            by_fp = self._load()["kernels"].get(str(chip), {}).get(
                str(kernel), {})
            return {fp: dict(rec) for fp, rec in by_fp.items()}

    # -- plan entries ------------------------------------------------------

    def record_plan(self, chip: str, model_fp: str, plan_key, *,
                    measured_ms=None, predicted_ms=None, plan=None,
                    source: str = "auto_tune") -> dict:
        with self._lock:
            doc = self._load()
            by_key = doc["plans"].setdefault(str(chip), {}).setdefault(
                str(model_fp), {})
            key = _plan_key_str(plan_key)
            prev = by_key.get(key, {})
            rec = {
                "measured_ms": measured_ms,
                "predicted_ms": predicted_ms,
                "plan": plan, "source": source,
                "runs": int(prev.get("runs", 0)) + 1,
            }
            if measured_ms is None and prev.get("measured_ms") is not None:
                rec["measured_ms"] = prev["measured_ms"]   # keep the data
            by_key[key] = rec
            self._save()
            return rec

    def plan_measurements(self, chip: str, model_fp: str) -> dict:
        """``{plan_key_str: record}`` with a measured_ms, for re-ranking."""
        with self._lock:
            by_key = self._load()["plans"].get(str(chip), {}).get(
                str(model_fp), {})
            return {k: dict(r) for k, r in by_key.items()
                    if isinstance(r.get("measured_ms"), (int, float))}

    # -- event ingestion ---------------------------------------------------

    def ingest_events(self, events) -> int:
        """Fold observe event records into the ledger.

        Consumes ``bench.kernel_probe`` records (kernel timings) and
        ``plan.auto_tune`` / ``plan.decision`` events that carry
        ``chip`` + ``model_fp`` (the planner stamps both).  Returns the
        number of entries absorbed; unknown or incomplete events are
        skipped — the event log is append-only telemetry, not a schema
        contract.
        """
        n = 0
        for ev in events:
            if not isinstance(ev, dict):
                continue
            name = ev.get("event") or ev.get("name") or ev.get("metric")
            if name in ("bench.kernel_probe", "kernel_probe"):
                if ev.get("kernel") and ev.get("shape_fp"):
                    self.record_kernel(
                        ev.get("chip") or chip_name(),
                        ev["kernel"], ev["shape_fp"],
                        pallas_us=ev.get("pallas_us"),
                        xla_us=ev.get("xla_us"),
                        threshold=ev.get("threshold"),
                        source="bench")
                    n += 1
            elif name in ("plan.auto_tune", "plan.decision"):
                if ev.get("chip") and ev.get("model_fp") and \
                        ev.get("plan_key") is not None and \
                        ev.get("measured_ms") is not None:
                    self.record_plan(
                        ev["chip"], ev["model_fp"], tuple(ev["plan_key"]),
                        measured_ms=ev.get("measured_ms"),
                        predicted_ms=ev.get("predicted_ms"),
                        plan=ev.get("plan"), source=name)
                    n += 1
        return n


# -- process-global ledger ---------------------------------------------------

_global = [None]
_global_lock = threading.Lock()


def get_ledger() -> Ledger:
    """The process ledger at :func:`default_path` (override with
    :func:`set_path`: tests and ``chip_smoke.py`` point it at a file of
    their own)."""
    with _global_lock:
        if _global[0] is None:
            _global[0] = Ledger()
        return _global[0]


def set_path(path: Optional[str]) -> Ledger:
    """Re-point the process ledger (None restores the default path).
    Returns the fresh ledger."""
    with _global_lock:
        _global[0] = Ledger(path)
        return _global[0]
