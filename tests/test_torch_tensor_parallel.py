"""Megatron tensor parallelism (``apex_tpu_torch.parallel.tensor_parallel``)
against the JAX package's ``shard_map`` programs, on the CPU.

Gloo ranks run once for the file at world 2 and once at world 4 through
the port's launcher (``tests/torch_ranks.py``), under a one-dim
``DeviceMesh`` named ``"tp"`` entered with ``parallel.use_mesh``; each
rank returns its results, and they are held here against the JAX
functions mapped over ``jax.devices()[:n]`` on the same numpy inputs:
the column -> row MLP of the module forms (each rank holding its shard of
the JAX layers' whole weights) forward and gradients, ``gather_output``,
the functional forms with explicit shards, ``vocab_parallel_cross_entropy``
against the dense loss and the JAX function, the vocab-parallel embedding
and logits, ``tp_ffn`` and ``tp_attn_begin``, and the divisibility errors.
The JAX tests' tolerances: 2e-5 for the forwards, 3e-5 for the gradients,
1e-6 / (1e-5, 1e-6) for the cross entropy's loss / gradient.  In this
process: a world of one needs no mesh only for ``"data"``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import apex_tpu.nn as jnn
from apex_tpu.nn import functional as jF
from apex_tpu.nn.modules import Ctx
from apex_tpu.parallel import (ColumnParallelLinear as JaxColumn,
                               RowParallelLinear as JaxRow)
from apex_tpu.parallel import tensor_parallel as jtp
from apex_tpu.runtime import step_cache as jax_step_cache

from apex_tpu_torch.parallel import mesh as port_mesh
from apex_tpu_torch.parallel import tensor_parallel as tp

from torch_ranks import run_ranks

IN, HID, OUT, B = 16, 64, 24, 8
V_G, T = 32, 24

WORKER = r'''
from torch.distributed.device_mesh import init_device_mesh
from apex_tpu_torch.parallel import (ColumnParallelLinear,
                                     RowParallelLinear, use_mesh,
                                     column_parallel_linear,
                                     row_parallel_linear,
                                     vocab_parallel_cross_entropy,
                                     vocab_parallel_embedding,
                                     vocab_parallel_logits)
from apex_tpu_torch.parallel import tensor_parallel as tp

D = {k: torch.from_numpy(v) for k, v in np.load(
    os.path.join(OUT, "data.npz")).items()}
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("tp",))
res = {}


def block(t, dim):
    n = t.shape[dim] // WORLD
    return t.narrow(dim, RANK * n, n).clone()


with use_mesh(mesh):
    torch.manual_seed(0)
    col = ColumnParallelLinear(16, 64, "tp", device="cpu")
    row = RowParallelLinear(64, 24, "tp", device="cpu")
    res["shard_shapes"] = [tuple(p.shape) for p in (col.weight, col.bias,
                                                    row.weight, row.bias)]
    with torch.no_grad():
        col.weight.copy_(block(D["cw"], 0))
        col.bias.copy_(block(D["cb"], 0))
        row.weight.copy_(block(D["rw"], 1))
        row.bias.copy_(D["rb"])
    x = D["x"].clone().requires_grad_(True)
    y = row(torch.relu(col(tp.copy_to_tp_region(x, "tp"))))
    res["mlp"] = y.detach()
    (y * D["w_out"]).sum().backward()
    res["mlp_grads"] = [col.weight.grad, col.bias.grad, row.weight.grad,
                        row.bias.grad, x.grad]

    gcol = ColumnParallelLinear(16, 64, "tp", gather_output=True,
                                device="cpu")
    with torch.no_grad():
        gcol.weight.copy_(block(D["cw"], 0))
        gcol.bias.copy_(block(D["cb"], 0))
    xg = D["x"].clone().requires_grad_(True)
    out = gcol(xg)
    res["gather"] = out.detach()
    (out * D["w_gather"]).sum().backward()
    res["gather_grads"] = [gcol.weight.grad, xg.grad]

    # the functional forms with explicit shards
    h = torch.relu(column_parallel_linear(D["x"], block(D["w1"], 0),
                                          block(D["b1"], 0), "tp"))
    res["functional"] = row_parallel_linear(h, block(D["w2"], 1), None,
                                            "tp") + D["b2"]
    res["functional_gather"] = column_parallel_linear(
        D["x"], block(D["w1"], 0), block(D["b1"], 0), "tp",
        gather_output=True)

    # vocab-parallel cross entropy over this rank's logits columns
    lg = block(D["logits"], 1).requires_grad_(True)
    loss = vocab_parallel_cross_entropy(lg, D["tgt"], "tp")
    loss.backward()
    res["vce"] = (float(loss), lg.grad)
    res["vce_none"] = vocab_parallel_cross_entropy(
        block(D["logits"], 1), D["tgt"], "tp", reduction="none")

    # the vocab-parallel embedding and logits over the whole table
    emb = D["emb"].clone().requires_grad_(True)
    xe = vocab_parallel_embedding(D["ids"], emb, "tp")
    (xe * D["w_emb"]).sum().backward()
    res["vemb"] = (xe.detach(), emb.grad)
    hh = D["hidden"].clone().requires_grad_(True)
    emb2 = D["emb"].clone().requires_grad_(True)
    lo = vocab_parallel_logits(hh, emb2, "tp")
    (lo * block(D["w_logits"], -1)).sum().backward()
    res["vlogits"] = (lo.detach(), hh.grad, emb2.grad)

    # tp_ffn over whole weights and tp_attn_begin's blocks
    xf = D["x"].clone().requires_grad_(True)
    w1, b1, w2, b2 = (D[k].clone().requires_grad_(True)
                      for k in ("w1", "b1", "w2", "b2"))
    yf = tp.tp_ffn(xf, w1, b1, w2, b2, "tp", activation=torch.relu)
    (yf * D["w_out"]).sum().backward()
    res["ffn"] = (yf.detach(), [t.grad for t in (xf, w1, b1, w2, b2)])
    (xa,), heads, rows, cols = tp.tp_attn_begin(
        "tp", 8, [D["x"]], [D["w1"]], [D["w2"]])
    res["attn_begin"] = (heads, rows[0], cols[0])

    errs = []
    for fn in (lambda: ColumnParallelLinear(16, 63, "tp", device="cpu"),
               lambda: tp.tp_attn_begin("tp", 6, [D["x"]], [], [])):
        try:
            fn()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    res["errors"] = errs
finish(res)
'''


def _data():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    jnn.manual_seed(31)
    col, row = JaxColumn(IN, HID, "tp"), JaxRow(HID, OUT, "tp")
    return dict(
        cw=np.asarray(col.weight.data), cb=np.asarray(col.bias.data),
        rw=np.asarray(row.weight.data), rb=np.asarray(row.bias.data),
        x=f(B, IN), w_out=f(B, OUT), w_gather=f(B, HID),
        w1=f(HID, IN), b1=f(HID), w2=f(OUT, HID), b2=f(OUT),
        logits=f(T, V_G), tgt=rng.integers(0, V_G, (T,)),
        emb=f(V_G, IN), ids=rng.integers(0, V_G, (2, 5)),
        w_emb=f(2, 5, IN), hidden=f(2, 5, IN), w_logits=f(2, 5, V_G))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = _data()
    out = {}
    for n in (2, 4):
        path = tmp_path_factory.mktemp(f"tp{n}")
        np.savez(path / "data.npz", **d)
        out[n] = run_ranks(WORKER, n, str(path))
    yield dict(res=out, d=d)
    jax_step_cache.clear()


def _smap(f, n, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices()[:n]), ("tp",))
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _blocks(full, n, dim):
    return np.split(np.asarray(full), n, axis=dim)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _jax_mlp(d, n):
    """The JAX module forms' forward and their assembled gradients (the
    column weight, column bias and row weight psum'd, the row bias whole,
    and the input's) under shard_map."""
    x, w_out = jnp.asarray(d["x"]), jnp.asarray(d["w_out"])
    jnn.manual_seed(31)
    col, row = JaxColumn(IN, HID, "tp"), JaxRow(HID, OUT, "tp")

    def f(cw, cb, rw, rb, x):
        def loss(cw, cb, rw, rb, x):
            ctx = Ctx(env={id(col.weight): cw, id(col.bias): cb,
                           id(row.weight): rw, id(row.bias): rb})
            h = jF.relu(col.forward(ctx, jtp.copy_to_tp_region(x, "tp")))
            y = row.forward(ctx, h)
            return jnp.sum(y * w_out), y
        (_, y), gs = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(cw, cb, rw, rb, x)
        gcw, gcb, grw, grb, gx = gs
        return y, (jax.lax.psum(gcw, "tp"), jax.lax.psum(gcb, "tp"),
                   jax.lax.psum(grw, "tp"), grb, gx)
    return _smap(f, n, (P(),) * 5, P())(
        jnp.asarray(d["cw"]), jnp.asarray(d["cb"]), jnp.asarray(d["rw"]),
        jnp.asarray(d["rb"]), x)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_mlp_matches_jax_shard_map(ranks, n):
    """Column -> ReLU -> row with the module forms, each rank holding its
    shard of the JAX layers' whole weights: the output equals the JAX
    module forms' under shard_map on n devices within 2e-5 on every rank,
    and the module forms hold shards of (HID/n, IN), (HID/n,), (OUT,
    HID/n), (OUT,)."""
    y, _ = _jax_mlp(ranks["d"], n)
    for r in ranks["res"][n]:
        assert r["shard_shapes"] == [(HID // n, IN), (HID // n,),
                                     (OUT, HID // n), (OUT,)]
        _close(r["mlp"], y, 2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_grads_match_jax_shard_map(ranks, n):
    """The f/g pair's gradients: each rank's column weight / bias and row
    weight gradients are its blocks of the JAX step's psum-assembled ones,
    the row bias and the input gradient whole on every rank, within
    3e-5."""
    _, (gcw, gcb, grw, grb, gx) = _jax_mlp(ranks["d"], n)
    for i, r in enumerate(ranks["res"][n]):
        g = r["mlp_grads"]
        _close(g[0], _blocks(gcw, n, 0)[i], 3e-5)
        _close(g[1], _blocks(gcb, n, 0)[i], 3e-5)
        _close(g[2], _blocks(grw, n, 1)[i], 3e-5)
        _close(g[3], grb, 3e-5)
        _close(g[4], gx, 3e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_column_gather_output_matches_jax(ranks, n):
    """gather_output: the whole feature dim in rank order, as the JAX
    module's all_gather gives it, within 2e-5; its backward takes this
    rank's slice of the output gradient."""
    d = ranks["d"]
    jnn.manual_seed(31)
    col = JaxColumn(IN, HID, "tp", gather_output=True)

    def f(cw, cb, x):
        return col.forward(Ctx(env={id(col.weight): cw, id(col.bias): cb}),
                           x)
    want = _smap(f, n, (P(),) * 3, P())(
        jnp.asarray(d["cw"]), jnp.asarray(d["cb"]), jnp.asarray(d["x"]))
    for i, r in enumerate(ranks["res"][n]):
        _close(r["gather"], want, 2e-5)
        gw = _blocks(d["w_gather"], n, 1)[i]
        _close(r["gather_grads"][0], gw.T @ d["x"], 3e-5)
        _close(r["gather_grads"][1], gw @ _blocks(d["cw"], n, 0)[i], 3e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_functional_forms_with_explicit_shards_match_jax(ranks, n):
    """column_parallel_linear / row_parallel_linear over hand-cut shards:
    the JAX functions under shard_map within 2e-5, and gather_output in
    shard order."""
    d = ranks["d"]

    def f(x, w1, b1, w2, b2):
        h = jnp.maximum(jtp.column_parallel_linear(x, w1, b1, "tp"), 0)
        return jtp.row_parallel_linear(h, w2, None, "tp") + b2

    args = [jnp.asarray(d[k]) for k in ("x", "w1", "b1", "w2", "b2")]
    want = _smap(f, n, (P(), P("tp"), P("tp"), P(None, "tp"), P()),
                 P())(*args)

    def g(x, w1, b1):
        return jtp.column_parallel_linear(x, w1, b1, "tp",
                                          gather_output=True)
    full = _smap(g, n, (P(), P("tp"), P("tp")), P())(*args[:3])
    for r in ranks["res"][n]:
        _close(r["functional"], want, 2e-5)
        _close(r["functional_gather"], full, 2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_cross_entropy_matches_dense_and_jax(ranks, n):
    """Megatron's parallel cross entropy over vocab-sharded logits: the
    loss equals the dense loss within 1e-6 relative and the JAX function's
    under shard_map; each rank's logits gradient is its columns of the
    dense gradient within (1e-5, 1e-6); reduction="none" gives every
    row's loss."""
    from apex_tpu.parallel import vocab_parallel_cross_entropy as jvce
    d = ranks["d"]
    logits, tgt = jnp.asarray(d["logits"]), jnp.asarray(d["tgt"])

    def dense(lg):
        return jF.cross_entropy(lg, tgt)
    ref_l = float(dense(logits))
    ref_g = np.asarray(jax.grad(dense)(logits))

    def f(lg):
        return jax.value_and_grad(lambda s: jvce(s, tgt, "tp"))(lg)
    jl, jg = _smap(f, n, P(None, "tp"), (P(), P(None, "tp")))(logits)
    per_row = np.asarray(jax.vmap(lambda lg, t: jF.cross_entropy(
        lg[None], t[None]))(logits, tgt))
    for i, r in enumerate(ranks["res"][n]):
        loss, grad = r["vce"]
        np.testing.assert_allclose(loss, ref_l, rtol=1e-6)
        np.testing.assert_allclose(loss, float(jl), rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(),
                                   _blocks(ref_g, n, 1)[i],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grad.numpy(), _blocks(jg, n, 1)[i],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["vce_none"].numpy(), per_row,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_embedding_and_logits_match_jax(ranks, n):
    """The vocab-parallel lookup (partial rows combined by the g operator)
    and the tied head's vocab-sharded logits: the JAX functions under
    shard_map within 2e-5; the table's gradient lands in the rank's own
    vocab rows (block-sparse), summing over the ranks to the JAX psum."""
    d = ranks["d"]
    ids = jnp.asarray(d["ids"])
    w_emb, w_lo = jnp.asarray(d["w_emb"]), jnp.asarray(d["w_logits"])

    def f(emb):
        def loss(emb):
            x = jtp.vocab_parallel_embedding(ids, emb, "tp")
            return jnp.sum(x * w_emb), x
        (_, x), g = jax.value_and_grad(loss, has_aux=True)(emb)
        return x, jax.lax.psum(g, "tp")
    x, g = _smap(f, n, P(), P())(jnp.asarray(d["emb"]))

    def h(hidden, emb, w):
        def loss(hidden, emb):
            lo = jtp.vocab_parallel_logits(hidden, emb, "tp")
            return jnp.sum(lo * w), lo
        (_, lo), (gh, ge) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(hidden, emb)
        return lo, gh, jax.lax.psum(ge, "tp")
    lo, gh, ge = _smap(h, n, (P(), P(), P(None, None, "tp")),
                       (P(None, None, "tp"), P(), P()))(
        jnp.asarray(d["hidden"]), jnp.asarray(d["emb"]), w_lo)
    res = ranks["res"][n]
    for i, r in enumerate(res):
        _close(r["vemb"][0], x, 2e-5)
        _close(r["vlogits"][0], _blocks(lo, n, -1)[i], 2e-5)
        _close(r["vlogits"][1], gh, 3e-5)
        rows = V_G // n
        grad = r["vemb"][1].numpy()
        assert not grad[:i * rows].any() and not grad[(i + 1) * rows:].any()
    _close(sum(r["vemb"][1] for r in res), g, 3e-5)
    _close(sum(r["vlogits"][2] for r in res), ge, 3e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_ffn_and_attn_begin_match_jax(ranks, n):
    """tp_ffn over whole weights: its output and the input gradient equal
    the JAX function's under shard_map, the weights' gradients summed over
    the ranks the JAX psum-assembled ones (3e-5); tp_attn_begin gives the
    local head count and the rank's row / column blocks."""
    d = ranks["d"]
    w_out = jnp.asarray(d["w_out"])

    def f(x, w1, b1, w2, b2):
        def loss(*a):
            y = jtp.tp_ffn(*a, "tp", activation=jax.nn.relu)
            return jnp.sum(y * w_out), y
        (_, y), gs = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(x, w1, b1, w2, b2)
        gx, gw1, gb1, gw2, gb2 = gs
        return y, gx, [jax.lax.psum(g, "tp") for g in (gw1, gb1, gw2)], gb2
    y, gx, psums, gb2 = _smap(f, n, (P(),) * 5, P())(
        *[jnp.asarray(d[k]) for k in ("x", "w1", "b1", "w2", "b2")])
    res = ranks["res"][n]
    for i, r in enumerate(res):
        out, grads = r["ffn"]
        _close(out, y, 2e-5)
        _close(grads[0], gx, 3e-5)
        _close(grads[4], gb2, 3e-5)
        heads, rows, cols = r["attn_begin"]
        assert heads == 8 // n
        _close(rows, _blocks(d["w1"], n, 0)[i], 0)
        _close(cols, _blocks(d["w2"], n, 1)[i], 0)
    for k, want in zip((1, 2, 3), psums):
        _close(sum(r["ffn"][1][k] for r in res), want, 3e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_divisibility_errors(ranks, n):
    """A dimension the axis does not divide raises the JAX package's
    ValueError (63 output features over 2 or 4 ranks; 6 heads over 4)
    rather than dropping features."""
    col_err, heads_err = ranks["res"][n][0]["errors"]
    assert "not divisible by the 'tp' axis size" in col_err
    if n == 4:
        assert "heads (6) not divisible" in heads_err
    else:
        assert heads_err is None


def test_axis_resolution_without_a_mesh():
    """In a process without torch.distributed the data axis is a world of
    one; any other name raises NotImplementedError naming ROADMAP A9 (no
    mesh names it), so tensor parallelism never runs quietly as one
    rank."""
    assert tuple(port_mesh.resolve("data")) == (None, 1, 0)
    assert tuple(port_mesh.resolve(("data",))) == (None, 1, 0)
    for axis in ("tp", ("data", "tp")):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            port_mesh.resolve(axis)
    with pytest.raises(NotImplementedError, match="no entered mesh"):
        tp.copy_to_tp_region(torch.ones(2), "tp")
