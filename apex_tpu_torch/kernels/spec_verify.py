"""spec_verify: the serve engine's batched draft/verify decode tick as a
dispatch decision, the PyTorch counterpart of
``apex_tpu/kernels/spec_verify.py``.

The two tiers of the JAX package: ``"pallas"``, the fused draft-propose +
target-verify program (:func:`apex_tpu_torch.serve.kernels.
build_spec_verify_fn`, committing 1..k+1 tokens per dispatch), and
``"xla"``, the plain one-token decode program
(:func:`apex_tpu_torch.serve.kernels.build_decode_fn`).  Both are the
port's own programs and emit the same greedy tokens, so the choice is a
pure tokens/s question, and here, unlike for the hand kernels, the ledger
decides (``ledger_decides``): on the card, this card's entry for the
shape (:func:`spec_verify_fp`), measured as the JAX bench measures it (one
verify dispatch against the k + 1 chained decode dispatches it replaces,
on a self-draft).  With no entry the prior is "no": on the H100 the port's
speculative ticks measured below plain decoding (PERF.md), so the JAX
prior of ``k >= 2`` is not taken over; a winning entry's ``k`` for this
card moves the threshold (:func:`~.dispatch.measured_threshold`).  On the
CPU the answer is ``"xla"``, as in the JAX package with no Pallas
backend; ``spec_policy="on"`` speculates on any device.
"""
from __future__ import annotations

from .dispatch import decide, measured_threshold, register_kernel, shape_fp


def spec_verify_fp(*, b, k, s_t, s_d, dtype) -> str:
    """The fingerprint of one spec-verify dispatch shape, the JAX
    package's ``shape_fp`` string: batch bucket ``b``, draft depth ``k``,
    gathered target/draft linear cache widths ``s_t``/``s_d``, pool
    dtype."""
    return shape_fp(b=int(b), k=int(k), s_t=int(s_t), s_d=int(s_d),
                    dtype=str(dtype))


def _spec_verify_probe(dims):
    """No-ledger prior: no, unless this card has a winning entry at some
    draft depth, which then is the threshold on ``k``."""
    thr = measured_threshold("spec_verify", "k", None)
    if thr is None:
        return None, False
    return float(thr), dims.get("k", 0) >= thr


register_kernel(
    "spec_verify",
    xla_fallback="apex_tpu_torch.serve.kernels.build_decode_fn",
    threshold_probe=_spec_verify_probe,
    doc="Batched speculative draft/verify decode tick: fused k-step draft "
        "propose + (k+1)-wide target verify against the plain one-token "
        "decode program it replaces; both tiers emit the same greedy "
        "tokens, so win is pure tokens/s",
    ledger_decides=True)


def spec_verify_pays(fp: str, device=None) -> bool:
    """Whether the verify tick beats plain decode ticks at the shape
    ``fp`` on ``device``: ``decide("spec_verify", fp).tier == "pallas"``."""
    return decide("spec_verify", fp, device).tier == "pallas"
