"""Device rule, launch counters, masking constants and the tier decision
for the kernels: the counterpart of ``apex_tpu/kernels/dispatch.py``.

**The device rule.**  A tensor on the card launches the hand-written
kernel (or the wrapper raises), and a tensor that the caller put on the
CPU takes the kernel's plain PyTorch version (:func:`use_kernel`).  Each
wrapper counts its launches (:data:`LAUNCHES`) and picks its route before
the launch.

**The tier decision** (:func:`register_kernel`, :func:`decide`): the JAX
package's measured-threshold policy, with the port's rule in it.  Every
kernel registers with its plain fallback and a threshold probe;
``decide(name, fp, device)`` gives a :class:`Decision` whose ``tier`` keeps
the JAX names: ``"pallas"`` is the hand-written kernel (on the card, a
CUDA kernel), ``"xla"`` the fallback.  The rule
(:func:`decision_for`, a pure function of the entry):

* a CPU tensor's decision is ``"xla"``, the plain version, with source
  ``"mode"``, as the JAX package decides with no Pallas backend;
* for a hand kernel (B1-B12) a CUDA tensor's decision is ``"pallas"``
  whatever the ledger says, source ``"mode"``: a switch that sent a card's
  tensor to the plain version would be the fallback the port forbids.  The
  decision carries this card's measured ``win`` (library or plain time
  over the kernel's) from the ledger's entry for the shape where there is
  one, so a kernel slower than its library call shows in
  :func:`decisions`;
* for a kernel whose two tiers are both the port's own programs
  (``spec_verify``: same greedy tokens either way) the ledger decides on
  the card, as in the JAX package: this card's entry for the shape (win
  >= 1 speculates), else the kernel's probe (a prior of "no" until this
  card has a winning entry, see ``kernels/spec_verify.py``).

The first decision per ``(kernel, shape, device kind, chip)`` emits one
``kernels.dispatch`` event (with the ledger entry that was read) and bumps
``kernels.dispatch.<kernel>.<tier>``.  ``observe`` and ``pyprof`` never
switch an arm.  The JAX package's backend switches (``pallas_mode``,
``force_mode``, ``norm_kernel_mode``) have no counterpart: the tensor's
device picks the arm.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional

import torch

from . import ledger as _ledger

# the masked-vocabulary convention of the JAX package: a logit at
# MASKED_FILL means "this column does not exist"; consumers treat anything
# at or below MASKED_LOGIT_THR as masked
MASKED_FILL = -1e30
MASKED_LOGIT_THR = -1e29

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


# launches per kernel: each wrapper registers its kernel's name when its
# module is imported and adds one where it launches the kernel, nowhere else
LAUNCHES: dict = {}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def counts() -> dict:
    return dict(LAUNCHES)


# the list that keeps, for the CUDA graph being captured on this thread,
# the cached device tensors it reads (see hold)
_holder = threading.local()


@contextlib.contextmanager
def holding(keep: list):
    """While the block runs, :func:`hold` appends to ``keep``: a graph's
    capture, whose owner holds ``keep`` as long as the graph lives."""
    prev = getattr(_holder, "keep", None)
    _holder.keep = keep
    try:
        yield keep
    finally:
        _holder.keep = prev


def hold(t):
    """``t``, a device tensor a wrapper keeps in a cache of its own and
    hands to a kernel, kept alive for as long as the CUDA graph being
    captured lives (inside :func:`holding`; elsewhere nothing is kept): a
    graph bakes in the addresses it read, and a cache that drops ``t``
    later must not free memory the graph still reads."""
    keep = getattr(_holder, "keep", None)
    if keep is not None:
        keep.append(t)
    return t


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Without CUDA and without ``device="cpu"`` this raises
    instead of carrying on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device


def use_kernel(*tensors) -> bool:
    """The device rule: True when every given tensor lies on one CUDA
    device (launch the kernel), False when all lie on the CPU (take the
    plain version).  Anything else raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devs}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def is_dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill ``t.numel()`` consecutive places of its
    storage, each once, in some order of its dims: a contiguous tensor, a
    ``torch.channels_last`` one, any permutation of a contiguous one."""
    if t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last):
        return True
    order = sorted(range(t.dim()), key=t.stride, reverse=True)
    return t.permute(order).is_contiguous()


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` have one shape and put each element at the
    same place of their storage (strides equal along every dim longer than
    1: a size-1 dim's stride places nothing)."""
    if a.stride() == b.stride():
        return a.shape == b.shape
    return a.shape == b.shape and all(
        x == y for x, y, n in zip(a.stride(), b.stride(), a.shape) if n > 1)


def check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32, "
                        f"bfloat16 or float16)")


def dtype_code(dtype: torch.dtype) -> int:
    """The dtype code the C entry points take."""
    return KERNEL_DTYPES.index(dtype)


def dtype_name(dtype) -> str:
    """``"bfloat16"`` for ``torch.bfloat16``: the dtype as the JAX
    package's fingerprints spell it."""
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Shape fingerprints: the ledger key half the chip doesn't supply
# ---------------------------------------------------------------------------


def shape_fp(**dims) -> str:
    """Canonical fingerprint: sorted ``k=v`` pairs joined by ','.  The same
    helper builds the key where a time is recorded and where a decision
    reads it."""
    return ",".join(f"{k}={dims[k]}" for k in sorted(dims))


def parse_fp(fp: str) -> dict:
    """Inverse of :func:`shape_fp`; int-valued where possible."""
    out = {}
    for part in str(fp).split(","):
        k, _, v = part.partition("=")
        if not k:
            continue
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v
    return out


def attention_fp(b, h, sq, sk, d, dtype="float32", causal=False) -> str:
    """The flash kernels' key.  The port's kernels see ``(B·H, S, D)``
    operands and key them as ``b=1, h=B·H``."""
    return shape_fp(b=int(b), h=int(h), sq=int(sq), sk=int(sk), d=int(d),
                    dtype=dtype_name(dtype), causal=int(bool(causal)))


def multi_tensor_fp(op: str, n_elements: int, n_tensors: int,
                    dtype="float32") -> str:
    return shape_fp(op=str(op), n=int(n_elements), t=int(n_tensors),
                    dtype=dtype_name(dtype))


def vocab_chain_fp(n, v, e, dtype="float32") -> str:
    return shape_fp(n=int(n), v=int(v), e=int(e), dtype=dtype_name(dtype))


def rows_fp(rows, n, dtype="float32") -> str:
    """The row kernels' key (the norms and the cross-entropy): ``rows``
    rows of ``n`` elements in ``dtype``."""
    return shape_fp(rows=int(rows), n=int(n), dtype=dtype_name(dtype))


# ---------------------------------------------------------------------------
# Kernel registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: its declared plain fallback (the JAX
    ``xla_fallback`` key, a dotted path) and the threshold probe that
    decides where the ledger has no measurement.  ``ledger_decides``: the
    ledger picks the tier on the card (both tiers are the port's own
    programs); False for a hand kernel, which the device rule places."""
    name: str
    xla_fallback: str
    threshold_probe: Callable    # (dims: dict) -> (threshold, use_pallas)
    doc: str = ""
    audit_programs: Optional[Callable] = None
    ledger_decides: bool = False


KERNELS: dict = {}


def register_kernel(name: str, *, xla_fallback: str,
                    threshold_probe: Callable, doc: str = "",
                    audit_programs: Optional[Callable] = None,
                    ledger_decides: bool = False) -> KernelSpec:
    """Register a kernel with the dispatch policy; ``xla_fallback`` and
    ``threshold_probe`` are both required.  ``audit_programs`` (the JAX
    jaxpr verifier's tiers) is kept for the API and not read here."""
    if not xla_fallback or threshold_probe is None:
        raise ValueError(
            f"kernel {name!r} must declare a plain fallback and a "
            f"threshold probe")
    spec = KernelSpec(name=name, xla_fallback=xla_fallback,
                      threshold_probe=threshold_probe, doc=doc,
                      audit_programs=audit_programs,
                      ledger_decides=ledger_decides)
    KERNELS[name] = spec
    return spec


def catalog() -> dict:
    """Snapshot of the registered kernels (name -> KernelSpec)."""
    return dict(KERNELS)


def kernel_probe(dims):
    """The probe of a hand kernel: no threshold; the card launches it."""
    return None, True


# ---------------------------------------------------------------------------
# The tier decision
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Decision:
    """One dispatch decision: ``tier`` "pallas" (the hand kernel) or
    "xla" (the fallback); ``source`` "ledger" | "probe" | "mode"."""
    kernel: str
    tier: str
    shape_fp: str
    chip: str
    source: str
    threshold: Optional[float] = None
    win: Optional[float] = None


def decision_for(name: str, fp: str, chip: str, *, on_card: bool,
                 entry: Optional[dict],
                 spec: Optional[KernelSpec]) -> Decision:
    """The decision for ``(name, fp)`` from what :func:`decide` read: the
    device (``on_card``), this chip's ledger ``entry`` for the shape (None
    when there is none) and the kernel's spec.  Pure: the module
    docstring's rule, reachable without a card."""
    if not on_card:
        return Decision(name, "xla", fp, chip, "mode")
    thr = entry.get("threshold") if entry else None
    win = entry.get("win") if entry else None
    if spec is None or not spec.ledger_decides:
        return Decision(name, "pallas", fp, chip, "mode", threshold=thr,
                        win=win)
    if entry is not None:
        return Decision(name, "pallas" if win >= 1.0 else "xla", fp, chip,
                        "ledger", threshold=thr, win=win)
    threshold, use = spec.threshold_probe(parse_fp(fp))
    return Decision(name, "pallas" if use else "xla", fp, chip, "probe",
                    threshold=threshold)


_decisions_lock = threading.Lock()
_decisions: dict = {}            # (kernel, fp, on_card, chip) -> Decision


def decide(name: str, fp: str, device=None) -> Decision:
    """The tier for ``(kernel, shape)`` on ``device`` (a device or a
    tensor; None: the current CUDA device where CUDA is present, else the
    CPU), by :func:`decision_for` over this chip's ledger entry.  Cached
    per key; the first decision per key emits a ``kernels.dispatch`` event
    carrying the entry that made it."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    chip = _ledger.chip_name(device) if on_card else "cpu"
    key = (name, fp, on_card, chip)
    hit = _decisions.get(key)
    if hit is not None:
        return hit
    entry = _ledger.get_ledger().lookup_kernel(chip, name, fp) \
        if on_card else None
    d = decision_for(name, fp, chip, on_card=on_card, entry=entry,
                     spec=KERNELS.get(name))
    with _decisions_lock:
        first = key not in _decisions
        _decisions[key] = d
    if first:
        from ..observe import registry as _obs
        _obs.event("kernels.dispatch", kernel=d.kernel, tier=d.tier,
                   shape_fp=d.shape_fp, chip=d.chip, source=d.source,
                   threshold=d.threshold, win=d.win, ledger_entry=entry)
        _obs.counter(f"kernels.dispatch.{d.kernel}.{d.tier}").inc()
    return d


def decisions() -> list:
    """Snapshot of every decision taken so far."""
    with _decisions_lock:
        return [dataclasses.asdict(d) for d in _decisions.values()]


def reset_decisions() -> None:
    """Forget cached decisions (needed after the ledger is re-pointed:
    decisions carry ledger verdicts)."""
    with _decisions_lock:
        _decisions.clear()


def measured_threshold(name: str, dim: str, default):
    """A measured dispatch threshold for ``name`` along fingerprint
    dimension ``dim``: the smallest probed value of ``dim`` whose entry on
    this chip wins (xla_us / pallas_us >= 1); ``default`` where the ledger
    has no winning entry for this chip."""
    entries = _ledger.get_ledger().kernel_entries(_ledger.chip_name(), name)
    winners = []
    for fp, rec in entries.items():
        win = rec.get("win")
        val = parse_fp(fp).get(dim)
        if isinstance(val, int) and isinstance(win, (int, float)) \
                and win >= 1.0:
            winners.append(val)
    return min(winners) if winners else default
