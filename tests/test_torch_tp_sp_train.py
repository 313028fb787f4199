"""Tensor and sequence parallelism in training: the model families'
``tp_axis`` / ``sp_axis`` / ``tp_vocab`` forwards and
``make_train_step(tp_axis=, axis_name=<batch axes>)`` against the JAX
package's ``shard_map`` programs, on the CPU.

Gloo ranks run once for the file at world 4 and once at world 2 through
the port's launcher (``tests/torch_ranks.py``), each under the
``DeviceMesh`` a case names (``("tp",)``, ``("sp",)``, ``("data", "tp")``,
``("sp", "tp")``, ``("data", "sp")``) entered with ``parallel.use_mesh``;
the weights are the JAX models' (their state dicts carried by name), the
inputs numpy's.  What each rank returns is held here against the JAX
models under ``shard_map`` on a CPU mesh of the same shape and against the
unsharded JAX model, at the JAX tests' tolerances (``test_tp_models.py``,
``test_gpt.py``, ``test_llama.py``, ``test_bert.py``): forwards 2e-4 (3e-4
where SP and TP compose), gradients 3e-4 (Llama SP 4e-4), train-step
losses 2e-3 (TP), 3e-3 (DP x TP) and 2e-4 (SP, Llama).  The port's own
properties beside them: the ring's dropout and the SP models' elementwise
dropout draw what the unsharded step draws (the SP step with dropout
equals it within 2e-4), a TP x DP step's ranks of one data index compute
the same loss, and telemetry averages the loss over the product of the
batch axes.  In this process: the construction checks and the refusals.
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
from apex_tpu.models import BertModel as JaxBert, GptModel as JaxGpt
from apex_tpu.models.llama import LlamaModel as JaxLlama
from apex_tpu.models.seq2seq import TransformerSeq2Seq as JaxS2S
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.parallel import vocab_parallel_cross_entropy as jax_vce
from apex_tpu.runtime import step_cache as jax_step_cache
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.contrib.multihead_attn import attn_funcs
from apex_tpu_torch.models import GptModel
from apex_tpu_torch.models.llama import LlamaModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step

from torch_ranks import run_ranks

V, H, HEADS, S, B = 96, 32, 4, 16, 4
STEPS = 4
GPT = dict(vocab_size=V, hidden=H, layers=1, heads=HEADS, max_positions=64,
           dropout=0.0, attn_dropout=0.0)
LLAMA = dict(vocab_size=V, hidden=H, layers=1, heads=4, kv_heads=2,
             max_positions=64)
BERT = dict(vocab_size=V, hidden=H, layers=1, heads=HEADS, intermediate=64,
            max_positions=64, dropout=0.0, attn_dropout=0.0)
S2S = dict(vocab_size=V, hidden=H, enc_layers=1, dec_layers=1, heads=HEADS,
           max_positions=64, dropout=0.0, attn_dropout=0.0)

WORKER = r'''
from torch.distributed.device_mesh import init_device_mesh
from apex_tpu_torch.contrib.multihead_attn import attn_funcs
from apex_tpu_torch.models import BertModel, GptModel
from apex_tpu_torch.models.llama import LlamaModel
from apex_tpu_torch.models.seq2seq import TransformerSeq2Seq
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import mesh as pm
from apex_tpu_torch.parallel import use_mesh, vocab_parallel_cross_entropy
from apex_tpu_torch.training import make_train_step

Z = dict(np.load(os.path.join(OUT, "data.npz")))
CFG = eval(Z.pop("cfg").item())
V = CFG["gpt"]["vocab_size"]
res = {}


def T(name):
    return torch.from_numpy(Z[name])


def build(cls, cfg, name, **kw):
    m = cls(**{**CFG[cfg], **kw}, device="cpu")
    m.load_state_dict({k[len(name) + 1:]: T(k) for k in Z
                       if k.startswith(name + "/")})
    return m


def split(t, axis, dim):
    ax = pm.resolve(axis)
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n).contiguous()


def lm_loss(logits, tgt):
    return F.cross_entropy(logits.reshape(-1, V).float(), tgt.reshape(-1))


def assemble(model, tp=None, sp=None):
    """Each parameter's whole gradient: the TP blocks summed over tp, the
    SP partials over sp (the JAX tests' psums)."""
    tp_ids = {id(p) for p in model.tp_sharded_params()} if tp else set()
    out = []
    for p in model.parameters():
        g = p.grad.clone()
        if id(p) in tp_ids:
            dist.all_reduce(g, group=pm.resolve(tp).group)
        if sp:
            dist.all_reduce(g, group=pm.resolve(sp).group)
        out.append(g)
    return out


def fwd_grads(model, ids, w, tp=None, sp=None, **kw):
    out = model(ids, **kw)
    (out.float() * w).sum().backward()
    return out.detach(), assemble(model, tp, sp)


def steps(model, loss, ids, tgt, **kw):
    s = make_train_step(model, FusedAdam(list(model.parameters()), lr=1e-2),
                        loss, half_dtype=None, loss_scale=1.0, **kw)
    out = [float(s(ids, tgt)) for _ in range(STEPS)]
    return out, s


STEPS = CFG["steps"]
ids, tgt, ids2 = T("ids"), T("tgt"), T("ids2")
mesh1 = lambda name: init_device_mesh("cpu", (WORLD,),  # noqa: E731
                                      mesh_dim_names=(name,))
with use_mesh(mesh1("tp")):
    res["gpt_tp_fwd"] = fwd_grads(build(GptModel, "gpt", "gpt",
                                        tp_axis="tp"), ids, T("w"), tp="tp")
    res["llama_tp_fwd"] = fwd_grads(
        build(LlamaModel, "llama", "llama", tp_axis="tp"), ids, T("w"),
        tp="tp") if WORLD == 2 else None
with use_mesh(mesh1("sp")):
    res["gpt_sp_fwd"] = fwd_grads(build(GptModel, "gpt", "gpt",
                                        sp_axis="sp"), split(ids, "sp", 1),
                                  split(T("w"), "sp", 1), sp="sp")
if WORLD == 4:
    with use_mesh(mesh1("tp")):
        res["gpt_tp_step"], _ = steps(build(GptModel, "gpt", "gpt",
                                            tp_axis="tp"), lm_loss, ids,
                                      tgt, tp_axis="tp")
        m = build(GptModel, "gpt", "gpt", tp_axis="tp", tp_vocab=True)
        res["tpv_fwd"] = m(ids).detach()
        res["tpv_step"], _ = steps(
            m, lambda lo, t: vocab_parallel_cross_entropy(lo, t, "tp"), ids,
            tgt, tp_axis="tp")
        res["bert_tp_fwd"] = build(BertModel, "bert", "bert", tp_axis="tp")(
            ids, attention_mask=T("amask")).detach()
        m = build(TransformerSeq2Seq, "s2s", "s2s", tp_axis="tp")
        res["s2s_tp_fwd"] = m(ids, ids2).detach()
        res["s2s_tp_step"], _ = steps(
            m, lm_loss, (ids, ids2), tgt, tp_axis="tp")
        # a TP step drops alike on every rank of the axis: the residual
        # stream is replicated; the attention folds the TP index in
        m = build(GptModel, "gpt", "gpt", tp_axis="tp", dropout=0.1,
                  attn_dropout=0.1)
        res["tp_dropout"], _ = steps(m, lm_loss, ids, tgt, tp_axis="tp")
        errs, lin = [], torch.nn.Linear(2, 2)
        for fn in (lambda: LlamaModel(**CFG["llama"], tp_axis="tp",
                                      device="cpu")(ids),
                   lambda: make_train_step(
                       lin, FusedAdam(list(lin.parameters())), lm_loss,
                       tp_axis="tp"),
                   lambda: attn_funcs.self_attn_func(
                       False, True, 4, 0.25, torch.randn(4, 2, 16),
                       torch.randn(48, 16), torch.randn(16, 16),
                       dropout_prob=0.1, generator=torch.Generator(),
                       tensor_parallel_axis="tp")):
            try:
                fn()
                errs.append(None)
            except (ValueError, NotImplementedError) as e:
                errs.append(str(e))
        res["tp_errors"] = errs
    with use_mesh(mesh1("sp")):
        sp_ids, sp_tgt = split(ids, "sp", 1), split(tgt, "sp", 1)
        res["gpt_sp_step"], _ = steps(build(GptModel, "gpt", "gpt",
                                            sp_axis="sp"), lm_loss, sp_ids,
                                      sp_tgt, axis_name="sp")
        # dropout under SP: the ring's seed and the elementwise masks are
        # the unsharded step's, so the losses are too
        for arm, kw in (("sp", dict(sp_axis="sp")), ("plain", {})):
            m = build(GptModel, "gpt", "gpt", dropout=0.1, attn_dropout=0.3,
                      **kw)
            x, y = (sp_ids, sp_tgt) if arm == "sp" else (ids, tgt)
            res[f"sp_dropout_{arm}"], _ = steps(
                m, lm_loss, x, y, axis_name="sp" if arm == "sp" else None)
        res["llama_sp_fwd"] = fwd_grads(
            build(LlamaModel, "llama", "llama", sp_axis="sp"), sp_ids,
            split(T("w"), "sp", 1), sp="sp")
        res["bert_sp_fwd"] = fwd_grads(
            build(BertModel, "bert", "bert", sp_axis="sp"), sp_ids,
            split(T("wb"), "sp", 1), sp="sp", attention_mask=T("amask"))
        try:
            build(LlamaModel, "llama", "llama", sp_axis="sp")(
                torch.cat([ids, ids], 1))
            res["llama_sp_oversized"] = None
        except ValueError as e:
            res["llama_sp_oversized"] = str(e)
    m2 = lambda names: init_device_mesh(  # noqa: E731
        "cpu", (2, 2), mesh_dim_names=names)
    with use_mesh(m2(("data", "tp"))):
        d_ids, d_tgt = split(ids, "data", 0), split(tgt, "data", 0)
        res["gpt_dptp_step"], _ = steps(
            build(GptModel, "gpt", "gpt", tp_axis="tp"), lm_loss, d_ids,
            d_tgt, axis_name="data", tp_axis="tp")
        res["llama_dptp_step"], _ = steps(
            build(LlamaModel, "llama", "llama", tp_axis="tp"), lm_loss,
            d_ids, d_tgt, axis_name="data", tp_axis="tp")
        m = build(GptModel, "gpt", "gpt", tp_axis="tp", dropout=0.1,
                  attn_dropout=0.1)
        res["dptp_dropout"], _ = steps(m, lm_loss, d_ids, d_tgt,
                                       axis_name="data", tp_axis="tp")
        res["dptp_index"] = (pm.resolve("data").index,
                             pm.resolve("tp").index)
    with use_mesh(m2(("sp", "tp"))):
        res["gpt_sptp_fwd"] = build(GptModel, "gpt", "gpt", sp_axis="sp",
                                    tp_axis="tp")(split(ids, "sp", 1)).detach()
        res["bert_sptp_fwd"] = build(BertModel, "bert", "bert", sp_axis="sp",
                                     tp_axis="tp")(
            split(ids, "sp", 1), attention_mask=T("amask")).detach()
    with use_mesh(m2(("data", "sp"))):
        x, y = split(split(ids, "data", 0), "sp", 1), \
            split(split(tgt, "data", 0), "sp", 1)
        res["gpt_dpsp_step"], s = steps(
            build(GptModel, "gpt", "gpt", sp_axis="sp"), lm_loss, x, y,
            axis_name=("data", "sp"), telemetry=True, drain_every=100)
        res["dpsp_telemetry"] = s.drain_telemetry()
        res["llama_dpsp_step"], _ = steps(
            build(LlamaModel, "llama", "llama", sp_axis="sp"), lm_loss, x, y,
            axis_name=("data", "sp"))
        res["dpsp_size"] = pm.resolve(("data", "sp")).size
res = {k: ([t.detach() if isinstance(t, torch.Tensor) else t for t in v]
           if isinstance(v, list) else v) for k, v in res.items()}
finish(res)
'''


def _jax_models():
    """The JAX models whose weights every rank loads (state dicts by
    name), each drawn from seed 5 as the references below draw theirs."""
    out = {}
    for name, cls, cfg in (("gpt", JaxGpt, GPT), ("llama", JaxLlama, LLAMA),
                           ("bert", JaxBert, BERT), ("s2s", JaxS2S, S2S)):
        jnn.manual_seed(5)
        out[name] = cls(**cfg)
    return out


def _data():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, V, (B, S))
    amask = np.ones((B, S), np.int64)
    amask[1, -5:] = 0
    d = dict(ids=ids, tgt=np.roll(ids, -1, axis=1),
             ids2=rng.integers(0, V, (B, S)),
             w=rng.standard_normal((B, S, V)).astype(np.float32),
             wb=rng.standard_normal((B, S, H)).astype(np.float32),
             amask=amask)
    return d


def _cfg():
    return dict(gpt=GPT, llama=LLAMA, bert=BERT, s2s=S2S, steps=STEPS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = _data()
    models = _jax_models()
    flat = dict(d, cfg=np.array(repr(_cfg())))
    for name, m in models.items():
        for k, v in m.state_dict().items():
            flat[f"{name}/{k}"] = np.asarray(v)
    out = {}
    for n in (4, 2):
        path = tmp_path_factory.mktemp(f"train{n}")
        np.savez(path / "data.npz", **flat)
        out[n] = run_ranks(WORKER, n, str(path), timeout=400)
    yield dict(res=out, d=d)
    jax_step_cache.clear()


def _lm_loss(logits, tgt):
    return jF.cross_entropy(logits.reshape((-1, V)), tgt.reshape((-1,)))


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _env(m, vals):
    return Ctx(env={id(p): v for p, v in zip(m.parameters(), vals)},
               training=False)


def _unsharded(cls, cfg, ids, w, **fkw):
    """The unsharded JAX model's output and the gradients of sum(out *
    w), the JAX tests' oracle."""
    jnn.manual_seed(5)
    m = cls(**cfg)
    vals = [p.data for p in m.parameters()]

    def loss(vals):
        return jnp.sum(m.forward(_env(m, vals), jnp.asarray(ids), **fkw)
                       * jnp.asarray(w))
    out = m.forward(_env(m, vals), jnp.asarray(ids), **fkw)
    return out, jax.grad(loss)(vals)


def _sharded_fwd(cls, cfg, ids, n_or_shape, names, ids_spec, out_spec,
                 **kw):
    """The JAX model built with ``kw``'s axes, its forward under
    shard_map."""
    jnn.manual_seed(5)
    m = cls(**cfg, **kw)
    vals = [p.data for p in m.parameters()]
    devs = np.array(jax.devices()[:int(np.prod(n_or_shape))]).reshape(
        n_or_shape)
    mesh = Mesh(devs, names)
    return jax.jit(jax.shard_map(
        lambda vals, x: m.forward(_env(m, vals), x), mesh=mesh,
        in_specs=(P(), ids_spec), out_specs=out_spec,
        check_vma=False))(vals, jnp.asarray(ids))


def _sharded_steps(cls, cfg, loss, shape, names, specs, batch, model_kw,
                   step_kw, reduce_loss=None):
    """STEPS losses of the JAX step under shard_map (the local loss
    pmean'd over ``reduce_loss`` where the shards' losses differ)."""
    jnn.manual_seed(5)
    m = cls(**cfg, **model_kw)
    step = jax_make_train_step(m, JaxAdam(list(m.parameters()), lr=1e-2),
                               loss, half_dtype=None, loss_scale=1.0,
                               **step_kw)
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), names)

    def fn(state, *b):
        state, l = step._step_fn(state, *b)
        return state, l if reduce_loss is None else jax.lax.pmean(
            l, reduce_loss)
    sh = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(),) + specs,
                               out_specs=(P(), P()), check_vma=False))
    state, losses = step.state, []
    for _ in range(STEPS):
        state, l = sh(state, *[jnp.asarray(x) if not isinstance(x, tuple)
                               else tuple(map(jnp.asarray, x))
                               for x in batch])
        losses.append(float(l))
    return losses


def _cat(shards, dim):
    return np.concatenate([_np(s) for s in shards], axis=dim)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_gpt_forward_and_grads_match_jax(ranks, n):
    """GptModel(tp_axis="tp") on n ranks: the logits equal the JAX TP
    forward under shard_map and the unsharded model within 2e-4, and after
    the TP blocks' sum every rank holds the unsharded gradients within
    3e-4 (the step's contract)."""
    d = ranks["d"]
    want, grads = _unsharded(JaxGpt, GPT, d["ids"], d["w"])
    sharded = _sharded_fwd(JaxGpt, GPT, d["ids"], n, ("tp",), P(), P(),
                           tp_axis="tp")
    for r in ranks["res"][n]:
        out, g = r["gpt_tp_fwd"]
        _close(out, sharded, 2e-4)
        _close(out, want, 2e-4)
        for a, b in zip(g, grads):
            _close(a, b, 3e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_gpt_forward_and_grads_match_jax(ranks, n):
    """GptModel(sp_axis="sp"): each rank's logits are its rows of the JAX
    SP forward under shard_map and of the unsharded model (global
    positions, the ring's causal offsets) within 2e-4; the gradients
    summed over the ranks the unsharded ones within 3e-4."""
    d = ranks["d"]
    want, grads = _unsharded(JaxGpt, GPT, d["ids"], d["w"])
    sharded = _sharded_fwd(JaxGpt, GPT, d["ids"], n, ("sp",), P(None, "sp"),
                           P(None, "sp", None), sp_axis="sp")
    res = ranks["res"][n]
    got = _cat([r["gpt_sp_fwd"][0] for r in res], 1)
    _close(got, sharded, 2e-4)
    _close(got, want, 2e-4)
    for r in res:
        for a, b in zip(r["gpt_sp_fwd"][1], grads):
            _close(a, b, 3e-4)


@pytest.fixture(scope="module")
def r4(ranks):
    return ranks["res"][4]


def test_tp_gpt_step_matches_jax_shard_map(ranks, r4):
    """make_train_step(tp_axis="tp") at world 4: the losses of 4 Adam steps
    equal the JAX TP step's under shard_map on 4 devices within 2e-3 on
    every rank, and fall."""
    d = ranks["d"]
    want = _sharded_steps(JaxGpt, GPT, _lm_loss, (4,), ("tp",), (P(), P()),
                          (d["ids"], d["tgt"]), dict(tp_axis="tp"),
                          dict(tp_axis="tp"))
    for r in r4:
        np.testing.assert_allclose(r["gpt_tp_step"], want, rtol=2e-3,
                                   atol=2e-3)
        assert r["gpt_tp_step"][-1] < r["gpt_tp_step"][0]


def test_tp_vocab_gpt_matches_jax(ranks, r4):
    """tp_vocab: each rank's vocab-sharded logits are its columns of the
    JAX forward's under shard_map within 2e-4, and 4 steps with
    vocab_parallel_cross_entropy track the JAX step's within 2e-3."""
    d = ranks["d"]
    sharded = _sharded_fwd(JaxGpt, GPT, d["ids"], 4, ("tp",), P(),
                           P(None, None, "tp"), tp_axis="tp", tp_vocab=True)
    _close(_cat([r["tpv_fwd"] for r in r4], 2), sharded, 2e-4)
    want = _sharded_steps(
        JaxGpt, GPT, lambda lo, t: jax_vce(lo, t, "tp"), (4,), ("tp",),
        (P(), P()), (d["ids"], d["tgt"]), dict(tp_axis="tp", tp_vocab=True),
        dict(tp_axis="tp"))
    for r in r4:
        np.testing.assert_allclose(r["tpv_step"], want, rtol=2e-3, atol=2e-3)


def test_dp_x_tp_2d_mesh_training_matches_jax(ranks, r4):
    """A ("data", "tp") mesh of 2 x 2: axis_name="data" with tp_axis="tp",
    each data index on its half of the batch; the losses equal the JAX
    step's on the same 2 x 2 mesh within 3e-3 (GPT) and 2e-4 (Llama, GQA
    heads over TP)."""
    d = ranks["d"]
    specs = (P("data"), P("data"))
    want = _sharded_steps(JaxGpt, GPT, _lm_loss, (2, 2), ("data", "tp"),
                          specs, (d["ids"], d["tgt"]), dict(tp_axis="tp"),
                          dict(axis_name="data", tp_axis="tp"))
    want_l = _sharded_steps(JaxLlama, LLAMA, _lm_loss, (2, 2),
                            ("data", "tp"), specs, (d["ids"], d["tgt"]),
                            dict(tp_axis="tp"),
                            dict(axis_name="data", tp_axis="tp"))
    for r in r4:
        if r["dptp_index"][0] == 0:     # the JAX step returns shard 0's
            np.testing.assert_allclose(r["gpt_dptp_step"], want, rtol=3e-3,
                                       atol=3e-3)
            np.testing.assert_allclose(r["llama_dptp_step"], want_l,
                                       rtol=2e-4, atol=2e-4)


def test_sp_gpt_step_matches_jax(ranks, r4):
    """make_train_step(axis_name="sp") over an SP model at world 4: the
    mean of the ranks' losses equals the JAX SP step's pmean'd loss within
    2e-4."""
    d = ranks["d"]
    want = _sharded_steps(JaxGpt, GPT, _lm_loss, (4,), ("sp",),
                          (P(None, "sp"), P(None, "sp")),
                          (d["ids"], d["tgt"]), dict(sp_axis="sp"),
                          dict(axis_name="sp"), reduce_loss="sp")
    got = np.mean([r["gpt_sp_step"] for r in r4], axis=0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_dp_x_sp_2d_mesh_training_and_telemetry(ranks, r4):
    """axis_name=("data", "sp") on a 2 x 2 mesh: the gradients averaged
    over the product (4 ranks), the mean loss equal to the JAX step's
    pmean over both axes within 2e-4 (GPT and Llama); telemetry's drained
    loss is the mean over all four ranks' losses."""
    d = ranks["d"]
    specs = (P("data", "sp"), P("data", "sp"))
    for key, cls, cfg in (("gpt_dpsp_step", JaxGpt, GPT),
                          ("llama_dpsp_step", JaxLlama, LLAMA)):
        want = _sharded_steps(cls, cfg, _lm_loss, (2, 2), ("data", "sp"),
                              specs, (d["ids"], d["tgt"]),
                              dict(sp_axis="sp"),
                              dict(axis_name=("data", "sp")),
                              reduce_loss=("data", "sp"))
        got = np.mean([r[key] for r in r4], axis=0)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    mean = np.mean([np.mean(r["gpt_dpsp_step"]) for r in r4])
    for r in r4:
        assert r["dpsp_size"] == 4
        np.testing.assert_allclose(r["dpsp_telemetry"]["loss_mean"], mean,
                                   rtol=1e-5)


def test_sp_x_tp_composition_matches_jax(ranks, r4):
    """An ("sp", "tp") mesh of 2 x 2: GPT (ring over sp, heads over tp) and
    BERT (Ulysses over sp, heads over tp, a global key-padding mask) give
    each sp rank its rows of the JAX forward's under shard_map and of the
    unsharded model within 3e-4."""
    d = ranks["d"]
    for key, cls, cfg, kw in (
            ("gpt_sptp_fwd", JaxGpt, GPT, {}),
            ("bert_sptp_fwd", JaxBert, BERT,
             dict(attention_mask=d["amask"]))):
        jnn.manual_seed(5)
        m = cls(**cfg, sp_axis="sp", tp_axis="tp")
        vals = [p.data for p in m.parameters()]
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("sp", "tp"))
        fkw = {k: jnp.asarray(v) for k, v in kw.items()}
        sharded = jax.jit(jax.shard_map(
            lambda vals, x: m.forward(_env(m, vals), x, **fkw), mesh=mesh,
            in_specs=(P(), P(None, "sp")), out_specs=P(None, "sp"),
            check_vma=False))(vals, jnp.asarray(d["ids"]))
        jnn.manual_seed(5)
        ref = cls(**cfg)
        want = ref.forward(_env(ref, [p.data for p in ref.parameters()]),
                           jnp.asarray(d["ids"]), **fkw)
        got = [r[key] for r in r4]
        # ranks (sp 0, tp 0/1), (sp 1, tp 0/1): the two tp ranks agree
        _close(got[0], got[1], 1e-6)
        _close(got[2], got[3], 1e-6)
        full = _cat([got[0], got[2]], 1)
        _close(full, sharded, 3e-4)
        _close(full, want, 3e-4)


def test_sp_dropout_through_fused_step_matches_unsharded(r4):
    """The SP step with attention dropout 0.3 and elementwise dropout 0.1:
    the step folds no index of the model's own sp_axis, the ring's seed is
    drawn from the shared generator (the JAX Ctx.shared_key) and each
    elementwise mask is this rank's rows of the whole sequence's, so the
    mean of the ranks' losses equals the unsharded step's with the same
    rng_seed within 2e-4 (the JAX test's tolerance against its unsharded
    run), and the ranks' losses differ."""
    got = np.mean([r["sp_dropout_sp"] for r in r4], axis=0)
    np.testing.assert_allclose(got, r4[0]["sp_dropout_plain"], rtol=2e-4,
                               atol=2e-4)
    assert len({r["sp_dropout_sp"][0] for r in r4}) == 4


def test_tp_dropout_replicates_the_stream_and_folds_heads(r4):
    """Dropout under TP: the generator is not folded with the TP index
    (the residual stream is replicated, so every rank must drop alike) and
    the attention folds it into its kernel seed (each head shard its own
    mask): the four ranks of a pure-TP step compute one loss, finite and
    falling; on the data x tp mesh the ranks of one data index agree and
    the two data indices differ."""
    losses = [tuple(r["tp_dropout"]) for r in r4]
    assert len(set(losses)) == 1 and np.isfinite(losses[0]).all()
    assert losses[0][-1] < losses[0][0]
    by_data = {}
    for r in r4:
        by_data.setdefault(r["dptp_index"][0], set()).add(
            tuple(r["dptp_dropout"]))
    assert all(len(v) == 1 for v in by_data.values())
    assert by_data[0] != by_data[1]


def test_tp_bert_forward_matches_jax(ranks, r4):
    """BertModel(tp_axis="tp") with a key-padding mask: the JAX TP forward
    under shard_map and the unsharded model within 2e-4."""
    d = ranks["d"]
    am = jnp.asarray(d["amask"])
    jnn.manual_seed(5)
    m = JaxBert(**BERT, tp_axis="tp")
    vals = [p.data for p in m.parameters()]
    mesh = Mesh(np.array(jax.devices()[:4]), ("tp",))
    sharded = jax.jit(jax.shard_map(
        lambda vals, x: m.forward(_env(m, vals), x, attention_mask=am),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))(vals, jnp.asarray(d["ids"]))
    want, _ = _unsharded(JaxBert, BERT, d["ids"], d["wb"],
                         attention_mask=am)
    for r in r4:
        _close(r["bert_tp_fwd"], sharded, 2e-4)
        _close(r["bert_tp_fwd"], want, 2e-4)


def test_sequence_parallel_bert_matches_unsharded(ranks, r4):
    """BertModel(sp_axis="sp"), Ulysses over 4 ranks with the GLOBAL
    key-padding mask: each rank's rows of the unsharded model's output
    within 2e-4, the gradients summed over the ranks within 3e-4."""
    d = ranks["d"]
    want, grads = _unsharded(JaxBert, BERT, d["ids"], d["wb"],
                             attention_mask=jnp.asarray(d["amask"]))
    _close(_cat([r["bert_sp_fwd"][0] for r in r4], 1), want, 2e-4)
    for r in r4:
        for a, b in zip(r["bert_sp_fwd"][1], grads):
            _close(a, b, 3e-4)


def test_tp_seq2seq_matches_jax(ranks, r4):
    """TransformerSeq2Seq(tp_axis="tp"): both stacks' heads and FFNs over
    4 ranks; the logits equal the JAX TP forward's and the unsharded
    model's within 3e-4, and 4 steps track the JAX TP step within
    2e-3."""
    d = ranks["d"]
    src, tgt_in = jnp.asarray(d["ids"]), jnp.asarray(d["ids2"])
    jnn.manual_seed(5)
    m = JaxS2S(**S2S, tp_axis="tp")
    vals = [p.data for p in m.parameters()]
    mesh = Mesh(np.array(jax.devices()[:4]), ("tp",))
    sharded = jax.jit(jax.shard_map(
        lambda vals, a, b: m.forward(_env(m, vals), a, b), mesh=mesh,
        in_specs=(P(), P(), P()), out_specs=P(), check_vma=False))(
        vals, src, tgt_in)
    jnn.manual_seed(5)
    ref = JaxS2S(**S2S)
    want = ref.forward(_env(ref, [p.data for p in ref.parameters()]), src,
                       tgt_in)
    steps = _sharded_steps(JaxS2S, S2S, _lm_loss, (4,), ("tp",),
                           ((P(), P()), P()),
                           ((d["ids"], d["ids2"]), d["tgt"]),
                           dict(tp_axis="tp"), dict(tp_axis="tp"))
    for r in r4:
        _close(r["s2s_tp_fwd"], sharded, 3e-4)
        _close(r["s2s_tp_fwd"], want, 3e-4)
        np.testing.assert_allclose(r["s2s_tp_step"], steps, rtol=2e-3,
                                   atol=2e-3)


def test_tp_llama_forward_and_grads_match_jax(ranks):
    """LlamaModel(tp_axis="tp") at world 2 (4 query and 2 KV heads, each
    rank 2 and 1): the JAX TP forward under shard_map and the unsharded
    model within 2e-4; the gradients after the TP blocks' sum the
    unsharded ones within 3e-4."""
    d = ranks["d"]
    want, grads = _unsharded(JaxLlama, LLAMA, d["ids"], d["w"])
    sharded = _sharded_fwd(JaxLlama, LLAMA, d["ids"], 2, ("tp",), P(), P(),
                           tp_axis="tp")
    for r in ranks["res"][2]:
        out, g = r["llama_tp_fwd"]
        _close(out, sharded, 2e-4)
        _close(out, want, 2e-4)
        for a, b in zip(g, grads):
            _close(a, b, 3e-4)


def test_llama_sp_matches_unsharded(ranks, r4):
    """LlamaModel(sp_axis="sp") over 4 ranks (RoPE at global positions,
    the GQA ring): each rank's rows of the JAX SP forward and of the
    unsharded model within 2e-4, the gradients summed over the ranks
    within 4e-4; a global sequence past max_positions raises."""
    d = ranks["d"]
    want, grads = _unsharded(JaxLlama, LLAMA, d["ids"], d["w"])
    sharded = _sharded_fwd(JaxLlama, LLAMA, d["ids"], 4, ("sp",),
                           P(None, "sp"), P(None, "sp", None), sp_axis="sp")
    got = _cat([r["llama_sp_fwd"][0] for r in r4], 1)
    _close(got, sharded, 2e-4)
    _close(got, want, 2e-4)
    for r in r4:
        for a, b in zip(r["llama_sp_fwd"][1], grads):
            _close(a, b, 4e-4)
        assert "exceeds max_positions" in r["llama_sp_oversized"]


def test_tp_errors_on_the_ranks(r4):
    """Llama's KV heads (2) do not divide over 4 TP ranks: the JAX
    ValueError; a model without tp_sharded_params() under tp_axis: the
    JAX step's ValueError; attention dropout on the materializing impl
    under TP: the JAX NotImplementedError (its one mask would correlate the
    head shards)."""
    kv_err, step_err, impl_err = r4[0]["tp_errors"]
    assert "must both divide by the 'tp' axis size (4)" in kv_err
    assert "tp_sharded_params" in step_err
    assert "requires the flash path" in impl_err


def test_construction_checks_and_refusals():
    """The JAX package's construction checks (tp_vocab needs tp_axis, a
    padded vocab, output_hidden; attn_bias with attention dropout under
    TP; a band with SP), zero_sharding excluding tp_axis, the ring's
    refusal of a mask, and the refusals that stay: MoE, cached decode and
    generate of a TP or SP model, which name A9's later parts."""
    small = dict(GPT, device="cpu")
    with pytest.raises(ValueError, match="tp_vocab requires tp_axis"):
        GptModel(**small, tp_vocab=True)
    with pytest.raises(ValueError, match="pad_vocab_multiple with tp_vocab"):
        GptModel(**dict(small, vocab_size=95), tp_axis="tp", tp_vocab=True,
                 pad_vocab_multiple=8)
    with pytest.raises(ValueError, match="output_hidden with tp_vocab"):
        GptModel(**small, tp_axis="tp", tp_vocab=True, output_hidden=True)
    with pytest.raises(ValueError, match="requires the flash impl"):
        GptModel(**dict(small, attn_dropout=0.1), tp_axis="tp",
                 attn_bias=True)
    with pytest.raises(ValueError, match="sliding_window with sp_axis"):
        LlamaModel(**LLAMA, device="cpu", sp_axis="sp", sliding_window=4)
    m = GptModel(**small, tp_axis="tp")
    assert len(m.tp_sharded_params()) == 5    # in_proj, out_proj, fc1, fc2
    with pytest.raises(ValueError, match="excludes axis_name/tp_axis"):
        make_train_step(m, FusedAdam(list(m.parameters())), _lm_loss,
                        zero_sharding=True, tp_axis="tp")
    x = torch.randn(4, 2, 16)
    with pytest.raises(NotImplementedError, match="ulysses"):
        attn_funcs.self_attn_func(
            False, True, 2, 0.25, x, torch.randn(48, 16), torch.randn(16, 16),
            mask=torch.zeros(2, 4, dtype=torch.bool), use_flash=True,
            seq_parallel_axis="sp", seq_parallel_impl="ring")
    for kw in (dict(tp_axis="tp"), dict(sp_axis="sp")):
        g = GptModel(**small, **kw)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP A9, second part: decode"):
            g.init_caches(1, 8)
    with pytest.raises(NotImplementedError, match="experts"):
        GptModel(**small, moe_axis="data", moe_num_experts=2)
    with pytest.raises(NotImplementedError, match="no entered mesh"):
        m(torch.zeros((1, 4), dtype=torch.long))
