"""The port's RMSNorm (apex_tpu_torch.kernels.rms_norm and
apex_tpu_torch.normalization.FusedRMSNorm) against the JAX package's.

``rms_forward`` / ``rms_backward`` (the plain versions, which CPU tensors
take) against the Pallas kernels in interpret mode; the port's autograd
``FusedRMSNorm`` against ``jax.grad`` of the JAX package's
``fused_rms_norm_affine`` / ``fused_rms_norm`` under
``force_mode("interpret")``.  Inputs are made with numpy from a seed and
handed to both.  Tolerances: 1e-5 in fp32 (sums in another order); in bf16
the outputs are rounded to bf16 on both sides from fp32 values that agree
to 1e-5, so they may land one bf16 step apart: rtol 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import rms_norm as jax_k
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.nn.modules import Ctx
from apex_tpu.normalization import FusedRMSNorm as JaxFusedRMSNorm

from apex_tpu_torch.kernels import counts, reset_counts
from apex_tpu_torch.kernels import rms_norm as k
from apex_tpu_torch.normalization import (FusedRMSNorm, fused_rms_norm,
                                          fused_rms_norm_affine)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _inputs(rows, n, dtype, seed):
    """x (rows, n) and g as fp32 numpy holding values of ``dtype``, and a
    weight near 1."""
    r = np.random.default_rng(seed)
    jd = DTYPES[dtype][0]
    x = np.array(jnp.asarray(r.normal(0.5, 2.0, (rows, n)), jd)
                 .astype(jnp.float32))
    g = np.array(jnp.asarray(r.normal(0, 1, (rows, n)), jd)
                 .astype(jnp.float32))
    w = (1 + 0.3 * r.normal(size=n)).astype(np.float32)
    return x, g, w


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# rows not a multiple of the Pallas kernel's row block, and one that is
@pytest.mark.parametrize("rows,n", [(37, 64), (64, 96), (5, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_plain_versions_match_pallas_kernels(rows, n, dtype, affine):
    jd, td, tol = DTYPES[dtype]
    x, g, w = _inputs(rows, n, dtype, seed=rows * n)
    jx, jg = jnp.asarray(x, jd), jnp.asarray(g, jd)
    jw = jnp.asarray(w) if affine else None
    tx, tg = torch.from_numpy(x).to(td), torch.from_numpy(g).to(td)
    tw = torch.from_numpy(w) if affine else None

    jy, jrstd = jax_k.rms_forward(jx, jw, 1e-6, interpret=True)
    reset_counts()
    ty, trstd = k.rms_forward(tx, tw, 1e-6)
    assert ty.dtype == td and trstd.dtype == torch.float32
    assert tuple(trstd.shape) == (rows, 1)
    _close(trstd, jrstd, 1e-5)
    _close(ty.float(), np.asarray(jy, np.float32), tol)

    jout = jax_k.rms_backward(jg, jx, jrstd, jw, interpret=True)
    tout = k.rms_backward(tg, tx, torch.from_numpy(np.array(jrstd)), tw)
    assert len(tout) == (2 if affine else 1)
    assert tout[0].dtype == td
    _close(tout[0].float(), np.asarray(jout[0], np.float32), tol)
    if affine:
        assert tout[1].dtype == torch.float32
        # an fp32 sum over the rows in both: relative to the largest entry
        scale = float(np.abs(np.asarray(jout[1])).max())
        _close(tout[1] / scale, np.asarray(jout[1]) / scale, 1e-5)
    # CPU tensors take the plain versions: no launch is counted
    assert not any(counts().values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_autograd_matches_jax_grad(dtype, affine):
    """The port's FusedRMSNorm forward and backward against jax.grad of
    the JAX package's FusedRMSNorm module (its Pallas kernels in interpret
    mode) on a (2, 7, 48) input normalised over its last dim."""
    jd, td, tol = DTYPES[dtype]
    x, g, w = _inputs(14, 48, dtype, seed=3)
    x, g = x.reshape(2, 7, 48), g.reshape(2, 7, 48)
    jm = JaxFusedRMSNorm(48, elementwise_affine=affine)

    def jax_fn(xx, ww):
        env = {id(jm.weight): ww} if affine else {}
        y = jm.forward(Ctx(env=env), xx)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g)), y

    with force_mode("interpret"):
        (_, jy), (jdx, jdw) = jax.value_and_grad(
            jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(x, jd),
                                                  jnp.asarray(w))

    m = FusedRMSNorm(48, elementwise_affine=affine, device="cpu")
    assert m.eps == 1e-6
    if affine:
        assert m.weight.dtype == torch.float32
        assert torch.equal(m.weight, torch.ones(48))
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w))
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    ty = m(tx)
    (ty.float() * torch.from_numpy(g)).sum().backward()
    assert ty.dtype == td and tx.grad.dtype == td
    _close(ty.detach().float(), np.asarray(jy, np.float32), tol)
    _close(tx.grad.float(), np.asarray(jdx, np.float32), tol)
    if affine:
        assert m.weight.grad.dtype == torch.float32
        scale = float(np.abs(np.asarray(jdw)).max())
        _close(m.weight.grad / scale, np.asarray(jdw) / scale, 1e-5)


def test_functional_forms_and_weight_dtype():
    """The functional forms equal the module; a bf16 weight gets a bf16
    gradient (the fp32 sum cast to the weight's dtype, as the JAX package's
    ``_affine_bwd`` does); a wrong trailing shape raises."""
    x, _, w = _inputs(6, 32, "float32", seed=4)
    tx = torch.from_numpy(x).reshape(2, 3, 32)
    tw = torch.from_numpy(w)
    y = fused_rms_norm_affine(tx, tw, (32,))
    ref, _ = k.rms_forward_reference(tx.reshape(6, 32), tw, 1e-6)
    torch.testing.assert_close(y, ref.reshape(2, 3, 32), rtol=0, atol=0)
    torch.testing.assert_close(fused_rms_norm(tx, (32,)).reshape(6, 32),
                               k.rms_forward_reference(tx.reshape(6, 32),
                                                       None, 1e-6)[0],
                               rtol=0, atol=0)
    wb = tw.bfloat16().requires_grad_(True)
    fused_rms_norm_affine(tx.bfloat16(), wb, (32,)).float().sum().backward()
    assert wb.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="trailing dims"):
        fused_rms_norm(tx, (16,))


def test_wrappers_refuse_what_the_kernels_cannot_take():
    x = torch.zeros(4, 8)
    rstd = torch.ones(4, 1)
    with pytest.raises(ValueError, match="x2d"):
        k.rms_forward(torch.zeros(2, 4, 8), None, 1e-6)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        k.rms_forward(torch.zeros(2, k.MAX_N + 1), None, 1e-6)
    with pytest.raises(ValueError, match="weight shape"):
        k.rms_forward(x, torch.ones(7), 1e-6)
    with pytest.raises(TypeError, match="not supported"):
        k.rms_forward(x.double(), None, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        k.rms_forward(torch.zeros(8, 4).t(), None, 1e-6)
    with pytest.raises(ValueError, match="g shape"):
        k.rms_backward(torch.zeros(4, 7), x, rstd, None)
    with pytest.raises(ValueError, match="rstd"):
        k.rms_backward(x, x, torch.ones(4, 1, dtype=torch.float64), None)
