"""The port's reparameterizations (``reparameterization``: WeightNorm and
LoRA, applied and removed by name or by the bulk ``''`` sweep) against the
JAX package's.

The weights travel by ``from_jax_state_dict``, which needs equal key sets:
the reparameterized models carry the JAX package's source names
(``<name>_g`` / ``<name>_v``, ``<name>_w0`` / ``<name>_lora_b`` /
``<name>_lora_a``) and no ``<name>`` entry.  The computed weight is read
on every access, so models that read a weight without calling its module
(the Llama blocks) and the fused train step (``functional_call`` over the
sources, with half copies) see it too.  Tolerances: 1e-5 for fp32
forwards, gradients and three train steps (sums in other orders), 1e-6 for
a merge (one rounding of the same fp32 sum), greedy tokens exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.models import LlamaModel as JaxLlama
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.nn import functional as jax_F
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.reparameterization import LoRA as JaxLoRA
from apex_tpu.reparameterization import WeightNorm as JaxWeightNorm
from apex_tpu.reparameterization import apply_lora as jax_apply_lora
from apex_tpu.reparameterization import \
    apply_reparameterization as jax_apply_reparameterization
from apex_tpu.reparameterization import apply_weight_norm as jax_apply_wn
from apex_tpu.reparameterization import \
    lora_parameters as jax_lora_parameters
from apex_tpu.reparameterization import \
    remove_reparameterization as jax_remove_reparameterization
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.inference import quantize_int8
from apex_tpu_torch.models import LlamaModel, from_jax_state_dict, generate
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.reparameterization import (
    LoRA, Reparameterization, WeightNorm, apply_lora,
    apply_reparameterization, apply_weight_norm, lora_parameters,
    remove_reparameterization, remove_weight_norm)
from apex_tpu_torch.training import make_train_step

torch.set_num_threads(2)


def _sd(m):
    return {k: np.asarray(v, np.float32) for k, v in m.state_dict().items()}


def _mlps(seed, sizes=(16, 32, 8)):
    """A JAX Linear-ReLU-Linear and an empty port twin (same names)."""
    jnn.manual_seed(seed)
    jm = jnn.Sequential(jnn.Linear(sizes[0], sizes[1]), jnn.ReLU(),
                        jnn.Linear(sizes[1], sizes[2]))
    tm = torch.nn.Sequential(torch.nn.Linear(sizes[0], sizes[1]),
                             torch.nn.ReLU(),
                             torch.nn.Linear(sizes[1], sizes[2]))
    return jm, tm


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(
        a, torch.Tensor) else a, np.float32), np.asarray(b, np.float32),
        rtol=tol, atol=tol)


# -- WeightNorm --------------------------------------------------------------

@pytest.mark.parametrize("dim", [0, None], ids=["dim0", "dimNone"])
def test_weight_norm_matches_jax_forward_and_gradients(dim):
    jm, tm = _mlps(1)
    from_jax_state_dict(tm, _sd(jm))
    jax_apply_wn(jm, name="0.weight", dim=dim)
    apply_weight_norm(tm, name="0.weight", dim=dim)
    names = [n for n, _ in tm.named_parameters()]
    assert names == [n for n, _ in jm.named_parameters()]
    assert "0.weight" not in tm.state_dict() and "0.weight_g" in names
    assert tuple(tm[0].weight_g.shape) == ((32, 1) if dim == 0 else ())
    sd = _sd(jm)
    for k, v in tm.state_dict().items():
        _close(v, sd[k], 1e-6)
    x = _x(2, 5, 16)
    jout = jm(jnp.asarray(x))
    jloss = (jout * jout).mean()
    jloss.backward()
    out = tm(torch.from_numpy(x))
    _close(out, np.asarray(jout.value))
    (out * out).mean().backward()
    for (n, p), (_, jp) in zip(tm.named_parameters(),
                               jm.named_parameters()):
        _close(p.grad, np.asarray(jp.grad), 1e-5)
    # the computed weight is g v / |v| on every read
    v = tm[0].weight_v.detach()
    norm = v.norm(dim=1, keepdim=True) if dim == 0 else v.norm()
    _close(tm[0].weight, tm[0].weight_g.detach() * v / norm, 1e-6)
    # the state dict carries into a fresh twin with the same reparameterization
    _, fresh = _mlps(1)
    apply_weight_norm(fresh, name="0.weight", dim=dim)
    from_jax_state_dict(fresh, sd)
    _close(fresh(torch.from_numpy(x)), np.asarray(jout.value))


def test_remove_weight_norm_bakes_the_weight():
    jm, tm = _mlps(3)
    from_jax_state_dict(tm, _sd(jm))
    apply_weight_norm(tm)            # every >1-d parameter; biases kept
    assert {n for n, _ in tm.named_parameters()} == {
        "0.bias", "0.weight_g", "0.weight_v", "2.bias", "2.weight_g",
        "2.weight_v"}
    x = torch.from_numpy(_x(4, 3, 16))
    before = tm(x).detach()
    remove_weight_norm(tm, name="0.weight")
    assert type(tm[0]) is torch.nn.Linear
    assert isinstance(tm[0].weight, torch.nn.Parameter)
    assert "0.weight" in tm.state_dict() and "2.weight_g" in tm.state_dict()
    remove_weight_norm(tm, remove_all=True)
    assert type(tm[2]) is torch.nn.Linear
    assert {n for n, _ in tm.named_parameters()} == {
        "0.bias", "0.weight", "2.bias", "2.weight"}
    _close(tm(x), before, 1e-6)


def test_strict_names_raise_where_jax_raises_and_hook_child_false():
    _, tm = _mlps(5)
    with pytest.raises(AttributeError):
        apply_weight_norm(tm, name="0.wieght")
    apply_weight_norm(tm, name="0.weight")
    with pytest.raises(ValueError, match="already"):
        apply_weight_norm(tm, name="0.weight")
    with pytest.raises(ValueError, match="1-d"):
        apply_weight_norm(tm, name="0.bias")
    with pytest.raises(ValueError, match="not found"):
        remove_weight_norm(tm, name="2.weight")
    emb = torch.nn.Sequential(torch.nn.Embedding(10, 4), torch.nn.Linear(4, 4))
    with pytest.raises(ValueError, match="Embedding"):
        apply_weight_norm(emb, name="0.weight")
    apply_weight_norm(emb)           # the sweep skips the embedding
    assert "0.weight" in emb.state_dict() and "1.weight_g" in emb.state_dict()
    # hook_child=False: the instance lives on the root under the full name
    _, tm = _mlps(6)
    x = torch.from_numpy(_x(7, 3, 16))
    fn = Reparameterization.apply(tm, "2.weight", 0, WeightNorm,
                                  hook_child=False)
    assert fn.name == "2.weight" and fn.module is tm
    before = tm(x).detach()
    remove_reparameterization(tm, WeightNorm, remove_all=True)
    assert "2.weight" in tm.state_dict()
    _close(tm(x), before, 1e-6)
    # an int8-quantized weight is refused with the JAX package's error
    q = torch.nn.Linear(4, 4)
    quantize_int8(q, min_size=1)
    with pytest.raises(ValueError, match="int8-quantized weight"):
        apply_lora(q, "weight", r=2)
    apply_lora(q, r=2)               # the sweep skips it
    assert "weight_q" in q.state_dict()


# -- LoRA ----------------------------------------------------------------

def test_lora_starts_at_the_base_model_with_the_jax_names():
    jm, tm = _mlps(8)
    from_jax_state_dict(tm, _sd(jm))
    x = torch.from_numpy(_x(9, 4, 16))
    base = tm(x).detach()
    apply_lora(tm, r=4, generator=torch.Generator().manual_seed(0))
    jax_apply_lora(jm, r=4)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    _close(tm(x), base, 1e-6)
    a = tm[0].weight_lora_a
    assert a.shape == (4, 16) and a.dtype == torch.float32
    assert abs(float(a.detach().std()) - 0.02) < 0.01
    assert not tm[0].weight_w0.requires_grad
    assert [p.shape for p in lora_parameters(tm)] == [
        (32, 4), (4, 16), (8, 4), (4, 32)]
    # the same generator draws the same factors
    _, again = _mlps(8)
    apply_lora(again, r=4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again[0].weight_lora_a, a)


def test_lora_forward_and_merge_match_jax():
    """Nonzero factors carried from the JAX model: the adapted forward,
    then the merged weight, against the JAX package's."""
    jm, tm = _mlps(10)
    jax_apply_lora(jm, "0.weight", r=2, alpha=6.0)
    for n, p in jm.named_parameters():
        if n.endswith("_lora_b"):
            p.data = jnp.asarray(_x(11, *p.data.shape))
    apply_lora(tm, "0.weight", r=2, alpha=6.0)
    assert tm[0]._reparameterizations["weight"].scale == 3.0
    from_jax_state_dict(tm, _sd(jm))
    x = _x(12, 4, 16)
    _close(tm(torch.from_numpy(x)), np.asarray(jm(jnp.asarray(x)).value))
    adapted = tm(torch.from_numpy(x)).detach()
    jax_remove_reparameterization(jm, JaxLoRA, remove_all=True)
    remove_reparameterization(tm, LoRA, remove_all=True)
    assert set(tm.state_dict()) == set(_sd(jm)) == {
        "0.weight", "0.bias", "2.weight", "2.bias"}
    _close(tm[0].weight, np.asarray(jm[0].weight.data), 1e-6)
    _close(tm(torch.from_numpy(x)), adapted, 1e-6)


def test_lora_value_is_fp32_then_w0s_dtype():
    lin = torch.nn.Linear(8, 6).to(torch.bfloat16)
    apply_lora(lin, "weight", r=2)
    with torch.no_grad():
        lin.weight_lora_b.fill_(0.5)
    w = lin.weight
    assert w.dtype == torch.bfloat16
    want = (lin.weight_w0.float() + 1.0 * 2 * 0.5
            * lin.weight_lora_a.sum(0)[None, :]).to(torch.bfloat16)
    # (alpha / r) = 2 by default; B A with B = 0.5 sums A's rows
    assert torch.equal(w, want)


def test_lora_on_conv_weights_matches_jax():
    jnn.manual_seed(13)
    jconv = jnn.Conv2d(3, 8, 3, padding=1)
    tconv = torch.nn.Conv2d(3, 8, 3, padding=1)
    jax_apply_lora(jconv, "weight", r=2)
    apply_lora(tconv, "weight", r=2)
    assert tconv.weight_lora_b.shape == (8, 2)
    assert tconv.weight_lora_a.shape == (2, 27)
    jconv.weight_lora_b.data = jnp.asarray(_x(14, 8, 2))
    from_jax_state_dict(tconv, _sd(jconv))
    x = _x(15, 2, 3, 8, 8)
    _close(tconv(torch.from_numpy(x)), np.asarray(jconv(jnp.asarray(x)).value))


def test_lora_rank_bound_and_bulk_sweep():
    _, tm = _mlps(16)
    with pytest.raises(ValueError, match="rank"):
        apply_lora(tm, "0.weight", r=0)
    with pytest.raises(ValueError, match="exceeds"):
        apply_lora(tm, "2.weight", r=64)     # Linear(32, 8): min dim 8
    # a rejected apply leaves the model intact
    assert set(tm.state_dict()) == {"0.weight", "0.bias", "2.weight",
                                    "2.bias"}
    assert type(tm[2]) is torch.nn.Linear
    _, wide = _mlps(17, sizes=(16, 32, 2))
    apply_lora(wide, r=8)            # Linear(32, 2): min dim 2 < 8, skipped
    names = set(wide.state_dict())
    assert "0.weight_lora_a" in names and "2.weight" in names
    assert not any(n.startswith("2.weight_lora") for n in names)


def _lora_step_pair(half):
    jm, tm = _mlps(18)
    jax_apply_lora(jm, r=4)
    apply_lora(tm, r=4)
    from_jax_state_dict(tm, _sd(jm))
    jstep = jax_make_train_step(
        jm, JaxFusedAdam(jax_lora_parameters(jm), lr=5e-2),
        lambda out, y: jnp.mean((out.astype(jnp.float32) - y) ** 2),
        half_dtype=jnp.bfloat16 if half else None, loss_scale=1.0)
    tstep = make_train_step(
        tm, FusedAdam(lora_parameters(tm), lr=5e-2),
        lambda out, y: torch.mean((out.float() - y) ** 2),
        half_dtype=torch.bfloat16 if half else None, loss_scale=1.0)
    return jm, tm, jstep, tstep


@pytest.mark.parametrize("half", [False, True], ids=["fp32", "bf16"])
def test_lora_trains_the_factors_only_under_make_train_step(half):
    """The step's ``functional_call`` swaps in the sources (half copies
    with bf16), and the computed weight reads them: the losses are the JAX
    step's, the frozen weights do not move, the factors do."""
    jm, tm, jstep, tstep = _lora_step_pair(half)
    x, y = _x(19, 32, 16), _x(20, 32, 8)
    want = [float(jstep(jnp.asarray(x), jnp.asarray(y))) for _ in range(3)]
    got = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-2 if half else 1e-5)
    assert got[-1] < got[0]
    names = [n for n, _ in tm.named_parameters()]
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for n, m in zip(names, tstep.state.master_params):
        if n.endswith("_lora_b"):
            assert m.abs().sum() > 0, n
        elif not n.endswith("_lora_a"):
            assert torch.equal(m, before[n].float()), n
    tstep.sync_to_objects()
    if half:
        assert tm[0].weight_w0.dtype == torch.bfloat16
        assert tm[0].weight.dtype == torch.bfloat16


def test_llama_lora_train_merge_and_generate_match_jax():
    """A 2-layer Llama with LoRA on every q_proj and v_proj: 3 fp32 train
    steps of the factors, the merge, and greedy generation, against the
    JAX package's tokens."""
    cfg = dict(vocab_size=97, hidden=32, layers=2, heads=4, kv_heads=2,
               intermediate=64, max_positions=24)
    jnn.manual_seed(21)
    jm = JaxLlama(**cfg)
    tm = LlamaModel(**cfg, device="cpu")
    for jb, tb in zip(jm.blocks, tm.blocks):
        for proj in ("q_proj", "v_proj"):
            jax_apply_lora(jb, f"{proj}.weight", r=4)
            apply_lora(tb, f"{proj}.weight", r=4)
    from_jax_state_dict(tm, _sd(jm))
    assert len(lora_parameters(tm)) == 8

    def jloss(logits, ids):
        return jnp.mean(jax_F.cross_entropy(
            logits[:, :-1].reshape((-1, 97)), ids[:, 1:].reshape((-1,))))

    def tloss(logits, ids):
        return F.cross_entropy(logits[:, :-1].reshape(-1, 97),
                               ids[:, 1:].reshape(-1))
    jstep = jax_make_train_step(
        jm, JaxFusedAdam(jax_lora_parameters(jm), lr=2e-2), jloss,
        loss_scale=1.0)
    tstep = make_train_step(tm, FusedAdam(lora_parameters(tm), lr=2e-2),
                            tloss, loss_scale=1.0)
    ids = np.random.default_rng(22).integers(0, 97, (4, 16))
    with force_mode("interpret"):
        want = [float(jstep(jnp.asarray(ids), jnp.asarray(ids)))
                for _ in range(3)]
    got = [float(tstep(torch.from_numpy(ids), torch.from_numpy(ids)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    jstep.sync_to_objects()
    tstep.sync_to_objects()
    jm.eval()
    tm.eval()
    prompt = ids[:2, :6]
    with torch.no_grad():
        adapted = tm(torch.from_numpy(prompt))
    jax_remove_reparameterization(jm, JaxLoRA, remove_all=True)
    remove_reparameterization(tm, LoRA, remove_all=True)
    assert not any("lora" in n or n.endswith("_w0")
                   for n in tm.state_dict())
    with torch.no_grad():
        merged = tm(torch.from_numpy(prompt))
    _close(merged, adapted, 1e-5)
    with force_mode("interpret"):
        jtok = np.asarray(jax_gpt.generate(jm, jnp.asarray(prompt), 8))
    ttok = generate(tm, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(ttok.numpy(), jtok)


def test_apply_reparameterization_by_class_and_jax_weight_norm_names():
    """``apply_reparameterization(module, WeightNorm, ...)`` is
    ``apply_weight_norm``; the JAX and port sweeps name the same
    sources."""
    jm, tm = _mlps(23)
    jax_apply_reparameterization(jm, JaxWeightNorm, dim=0)
    apply_reparameterization(tm, WeightNorm, dim=0)
    assert set(tm.state_dict()) == set(_sd(jm))
    with pytest.raises(AssertionError):
        apply_reparameterization(tm)
