"""spec_verify: the serve engine's batched draft/verify decode tick as a
dispatch decision, the PyTorch counterpart of
``apex_tpu/kernels/spec_verify.py``.

The two tiers of the JAX package: the fused draft-propose + target-verify
program (:func:`apex_tpu_torch.serve.kernels.build_spec_verify_fn`,
committing 1..k+1 tokens per dispatch) and the plain one-token decode
program (:func:`apex_tpu_torch.serve.kernels.build_decode_fn`).  Both emit
the same greedy tokens, so the choice is a pure tokens/s question, which
the JAX package answers from a measured ledger per shape
(:func:`spec_verify_fp`).  The port has no ledger yet (ROADMAP A8), and no
TPU verdict decides anything on the card: :func:`spec_verify_pays` says
no for every shape, so ``ServeEngine(spec_policy="auto")`` runs plain
decode ticks on every device (which is also what the JAX package's
``"auto"`` does with no Pallas backend), and ``spec_policy="on"``
speculates.
"""
from __future__ import annotations


def spec_verify_fp(*, b, k, s_t, s_d, dtype) -> str:
    """The fingerprint of one spec-verify dispatch shape, the JAX
    package's ``shape_fp`` string: batch bucket ``b``, draft depth ``k``,
    gathered target/draft linear cache widths ``s_t``/``s_d``, pool
    dtype."""
    dims = dict(b=int(b), k=int(k), s_t=int(s_t), s_d=int(s_d),
                dtype=str(dtype))
    return ",".join(f"{key}={dims[key]}" for key in sorted(dims))


def spec_verify_pays(fp: str) -> bool:
    """Whether the verify tick beats plain decode ticks at the shape
    ``fp``: no measured verdict exists in the port, so never."""
    return False
