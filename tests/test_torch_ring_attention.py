"""Sequence-parallel attention (``apex_tpu_torch.parallel.ring_attention``:
ring and Ulysses) against the JAX package's, on the CPU.

Gloo ranks run once for the file at world 2 and once at world 4 through
the port's launcher (``tests/torch_ranks.py``), under a one-dim
``DeviceMesh`` named ``"sp"``; each rank holds its rows of the sequence
(rank-contiguous, as the JAX shard_map's ``P(None, None, "sp")``), and the
shards it returns are held here against the JAX ``ring_attention`` /
``ulysses_attention`` mapped over ``jax.devices()[:n]`` and the JAX
``attention_reference`` on the whole sequence, from the same numpy inputs:
forward and gradients, causal and not, uneven Sq/Sk, GQA's KVH-wide ring
against the expanded one, bf16, dropout (the ring's mask the one-device
kernel's: its result equals the port's one-device flash attention and the
JAX reference under the same seed), the Ulysses cases, and the seed folds.
The JAX tests' tolerances: 2e-5 forward, (3e-4, 3e-5) gradients, (2e-4,
2e-4) dropped gradients, 0.05 for bf16 against fp32.
"""
import functools
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.contrib.multihead_attn.attn_funcs import (
    _dropout_seed as jax_tp_seed, attention_reference as jax_ref)
from apex_tpu.parallel import (ring_attention as jax_ring,
                               ulysses_attention as jax_uly)
from apex_tpu.parallel.ring_attention import _sp_seed_fold as jax_sp_fold
from apex_tpu.runtime import step_cache as jax_step_cache

from apex_tpu_torch.contrib.multihead_attn.attn_funcs import (
    _dropout_seed as port_tp_seed)
port_ring = importlib.import_module("apex_tpu_torch.parallel.ring_attention")

from torch_ranks import run_ranks

B, H, S, D = 2, 4, 64, 16
SQ, SK = 32, 64
GH, GKV = 8, 2
SEED, RATE = 90210, 0.3

WORKER = r'''
import importlib
from torch.distributed.device_mesh import init_device_mesh
from apex_tpu_torch.contrib.multihead_attn.attn_funcs import flash_attention
from apex_tpu_torch.parallel import use_mesh
ring = importlib.import_module("apex_tpu_torch.parallel.ring_attention")

D = {k: torch.from_numpy(v) for k, v in np.load(
    os.path.join(OUT, "data.npz")).items()}
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("sp",))
res = {}


def mine(t):
    n = t.shape[2] // WORLD
    return t[:, :, RANK * n:(RANK + 1) * n].clone()


def grads_of(fn, q, k, v, w):
    q, k, v = (mine(t).requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    (out.float() * mine(w)).sum().backward()
    return out.detach(), [t.grad for t in (q, k, v)]


with use_mesh(mesh):
    q, k, v, w = D["q"], D["k"], D["v"], D["w"]
    for causal in (False, True):
        f = lambda a, b, c: ring.ring_attention(a, b, c, "sp", causal=causal)
        res[f"ring_{causal}"] = grads_of(f, q, k, v, w)
        f = lambda a, b, c: ring.ulysses_attention(a, b, c, "sp",
                                                   causal=causal)
        res[f"uly_{causal}"] = grads_of(f, q, k, v, w)
        res[f"uneven_{causal}"] = ring.ring_attention(
            mine(D["qx"]), mine(D["kx"]), mine(D["vx"]), "sp",
            causal=causal)
        seed = torch.tensor(90210, dtype=torch.int32)
        f = lambda a, b, c: ring.ring_attention(
            a, b, c, "sp", causal=causal, dropout_p=0.3, dropout_seed=seed)
        res[f"ring_drop_{causal}"] = grads_of(f, q, k, v, w)
    res["bf16"] = ring.ring_attention(mine(q).bfloat16(), mine(k).bfloat16(),
                                      mine(v).bfloat16(), "sp", causal=True)
    f = lambda a, b, c: ring.ring_attention(a, b, c, "sp", causal=True)
    res["gqa"] = grads_of(f, D["gq"], D["gk"], D["gv"], D["gw"])
    res["gqa_expanded"] = grads_of(
        lambda a, b, c: ring.ring_attention(
            a, b.repeat_interleave(4, 1), c.repeat_interleave(4, 1), "sp",
            causal=True), D["gq"], D["gk"], D["gv"], D["gw"])
    uly = {}
    for name, p, s in (("clean", 0.0, None), ("a", 0.4, 7), ("b", 0.4, 7),
                       ("c", 0.4, 8)):
        uly[name] = ring.ulysses_attention(
            mine(q), mine(k), mine(v), "sp", dropout_p=p,
            dropout_seed=None if s is None else torch.tensor(
                s, dtype=torch.int32))
    res["uly_drop"] = uly
finish(res)
'''


def _data():
    rng = np.random.default_rng(1234)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(B, H, S, D), k=f(B, H, S, D), v=f(B, H, S, D),
                w=f(B, H, S, D), qx=f(B, H, SQ, D), kx=f(B, H, SK, D),
                vx=f(B, H, SK, D), gq=f(2, GH, 32, D), gk=f(2, GKV, 32, D),
                gv=f(2, GKV, 32, D), gw=f(2, GH, 32, D))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = _data()
    out = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"sp{n}")
        np.savez(path / "data.npz", **d)
        out[n] = run_ranks(WORKER, n, str(path))
    yield dict(res=out, d={k: jnp.asarray(v) for k, v in d.items()})
    jax_step_cache.clear()


def _cat(shards):
    """The ranks' shards along the sequence, as numpy."""
    return np.concatenate([np.asarray(s.float()) for s in shards], axis=2)


def _sharded(fn, n, *args):
    spec = P(None, None, "sp", None)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                 out_specs=spec, check_vma=False))(*args)


def _jax_grads(fn, n, q, k, v, w):
    spec = P(None, None, "sp", None)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    shard = jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                          check_vma=False)
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        shard(q, k, v).astype(jnp.float32) * w), argnums=(0, 1, 2)))(q, k, v)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring_and_reference(ranks, n, causal):
    """The ring's forward: the JAX ring on n devices and the whole-sequence
    reference within 2e-5; its gradients (the dK/dV accumulators riding
    the ring home) the JAX ring's and the reference's within (3e-4,
    3e-5)."""
    d = ranks["d"]
    q, k, v, w = d["q"], d["k"], d["v"], d["w"]
    res = ranks["res"][n]
    out = _cat([r[f"ring_{causal}"][0] for r in res])
    fn = functools.partial(jax_ring, axis_name="sp", causal=causal)
    _close(out, _sharded(fn, n, q, k, v), 2e-5, 2e-5)
    _close(out, jax_ref(q, k, v, None, causal, D ** -0.5), 2e-5, 2e-5)
    g_ring = _jax_grads(fn, n, q, k, v, w)
    g_ref = jax.grad(lambda q, k, v: jnp.sum(
        jax_ref(q, k, v, None, causal, D ** -0.5) * w),
        argnums=(0, 1, 2))(q, k, v)
    for i in range(3):
        got = _cat([r[f"ring_{causal}"][1][i] for r in res])
        _close(got, g_ring[i], 3e-4, 3e-5)
        _close(got, g_ref[i], 3e-4, 3e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_and_reference(ranks, n, causal):
    """Ulysses (two all-to-alls around a whole-sequence attention on H/n
    heads): the JAX function on n devices and the reference within 2e-5,
    its gradients within (3e-4, 3e-5)."""
    d = ranks["d"]
    q, k, v, w = d["q"], d["k"], d["v"], d["w"]
    res = ranks["res"][n]
    out = _cat([r[f"uly_{causal}"][0] for r in res])
    fn = functools.partial(jax_uly, axis_name="sp", causal=causal)
    _close(out, _sharded(fn, n, q, k, v), 2e-5, 2e-5)
    _close(out, jax_ref(q, k, v, None, causal, D ** -0.5), 2e-5, 2e-5)
    g_uly = _jax_grads(fn, n, q, k, v, w)
    for i in range(3):
        _close(_cat([r[f"uly_{causal}"][1][i] for r in res]), g_uly[i],
               3e-4, 3e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_cross_attention_uneven_sq_sk(ranks, n, causal):
    """Sq_local != Sk_local: the chunk bias and dropout offsets take
    idx * sq and src * sk; the JAX ring and the reference within 2e-5."""
    d = ranks["d"]
    out = _cat([r[f"uneven_{causal}"] for r in ranks["res"][n]])
    fn = functools.partial(jax_ring, axis_name="sp", causal=causal)
    _close(out, _sharded(fn, n, d["qx"], d["kx"], d["vx"]), 2e-5, 2e-5)
    _close(out, jax_ref(d["qx"], d["kx"], d["vx"], None, causal,
                        D ** -0.5), 2e-5, 2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_bf16_tolerance(ranks, n):
    """bf16 inputs: the output stays bf16 and within 0.05 of the fp32
    reference (the JAX test's bound)."""
    d = ranks["d"]
    res = ranks["res"][n]
    assert all(r["bf16"].dtype == torch.bfloat16 for r in res)
    _close(_cat([r["bf16"] for r in res]),
           jax_ref(d["q"], d["k"], d["v"], None, True, D ** -0.5),
           0.05, 0.05)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_gqa_matches_expanded_and_jax(ranks, n):
    """The GQA ring carries KVH-wide chunks and expands them at the point
    of use: values and gradients equal the ring over K/V repeated before
    it (``repeat_interleave``, autograd summing each group back) within
    2e-5, and the
    JAX GQA ring's (gradients within (3e-4, 3e-5))."""
    d = ranks["d"]
    res = ranks["res"][n]
    out = _cat([r["gqa"][0] for r in res])
    _close(out, _cat([r["gqa_expanded"][0] for r in res]), 2e-5, 2e-5)
    fn = functools.partial(jax_ring, axis_name="sp", causal=True)
    _close(out, _sharded(fn, n, d["gq"], d["gk"], d["gv"]), 2e-5, 2e-5)
    g_jax = _jax_grads(fn, n, d["gq"], d["gk"], d["gv"], d["gw"])
    for i in range(3):
        got = _cat([r["gqa"][1][i] for r in res])
        _close(got, _cat([r["gqa_expanded"][1][i] for r in res]), 2e-5,
               2e-5)
        _close(got, g_jax[i], 3e-4, 3e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_dropout_bit_consistent_with_single_device(ranks, n, causal):
    """Dropout in the ring hashes GLOBAL (seed, head, row, column) under
    the shared seed: the sharded result equals the one-device flash
    attention of the port (the kernels' plain versions here) and the JAX
    reference under the same seed within 2e-5, so the same positions drop
    (a different mask would move entries by O(1)); the dropped gradients
    within (2e-4, 2e-4)."""
    from apex_tpu_torch.contrib.multihead_attn.attn_funcs import (
        flash_attention)
    d = ranks["d"]
    q, k, v, w = d["q"], d["k"], d["v"], d["w"]
    res = ranks["res"][n]
    out = _cat([r[f"ring_drop_{causal}"][0] for r in res])
    tq, tk, tv = (torch.tensor(np.asarray(t)).requires_grad_(True)
                  for t in (q, k, v))
    one = flash_attention(tq, tk, tv, causal=causal, dropout_p=RATE,
                          dropout_seed=SEED)
    _close(out, one.detach().numpy(), 2e-5, 2e-5)
    _close(out, jax_ref(q, k, v, None, causal, D ** -0.5, dropout_p=RATE,
                        dropout_seed=jnp.int32(SEED)), 2e-5, 2e-5)
    (one * torch.from_numpy(np.asarray(w))).sum().backward()
    for i, t in enumerate((tq, tk, tv)):
        _close(_cat([r[f"ring_drop_{causal}"][1][i] for r in res]),
               t.grad.numpy(), 2e-4, 2e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_dropout_runs_and_decorrelates(ranks, n):
    """Ulysses dropout folds the shard index (per-head-shard streams):
    finite, other than the clean output, the same for the same seed, and
    another for another seed."""
    for r in ranks["res"][n]:
        u = r["uly_drop"]
        assert torch.isfinite(u["a"]).all()
        assert not torch.allclose(u["a"], u["clean"])
        assert torch.equal(u["a"], u["b"])
        assert not torch.equal(u["a"], u["c"])


def test_ring_dropout_requires_seed():
    q = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="dropout_seed"):
        port_ring.ring_attention(q, q, q, axis_name="sp", dropout_p=0.1)


def test_sp_seed_fold_not_symmetric_with_tp_fold():
    """The SP fold is multiply-then-avalanche, not the TP fold's linear xor
    with one constant: over an 8 x 8 TP x SP mesh no two (tp, sp) pairs,
    swapped ones included, draw one seed, and each fold gives the JAX
    package's int32 seed bit for bit (int and tensor seeds)."""
    base = 0x12345678
    seen = {}
    for tp_i in range(8):
        tp_seed = port_ring._xor_seed(base, (tp_i * 0x9E3779B1)
                                      & 0xFFFFFFFF)
        jax_tp = int(jnp.asarray((jnp.uint32(base) ^ (
            jnp.uint32(tp_i) * jnp.uint32(0x9E3779B1))).astype(jnp.int32)))
        assert tp_seed == jax_tp
        for sp_i in range(8):
            s = port_ring._sp_seed_fold(tp_seed, sp_i)
            assert s == int(jax_sp_fold(jnp.int32(tp_seed),
                                        jnp.uint32(sp_i)))
            t = port_ring._sp_seed_fold(torch.tensor(tp_seed,
                                                     dtype=torch.int32),
                                        sp_i)
            assert int(t) == s
            assert s not in seen.values(), (tp_i, sp_i)
            seen[(tp_i, sp_i)] = s


def test_tp_dropout_seed_fold_matches_jax():
    """attn_funcs._dropout_seed folds the rank's index on the TP axis as
    ``seed ^ (idx * 0x9E3779B1)``, the JAX fold of the same int32 seed;
    without an axis it is the seed itself."""
    seed = torch.tensor(-123456789, dtype=torch.int32)
    assert port_tp_seed(seed) is seed
    key = jax.random.PRNGKey(3)
    jax_seed = int(jax_tp_seed(key))
    assert int(port_tp_seed(torch.tensor(jax_seed, dtype=torch.int32))) \
        == jax_seed
