"""The port's training path against the JAX package's, on a tiny GPT whose
weights are carried across by ``from_jax_state_dict``.

``make_train_step`` with ``FusedAdam`` and the plain cross-entropy loss
runs on both sides from the same weights and batch: the JAX step under
``force_mode("interpret")`` (its Pallas kernels in interpret mode), the
port's on CPU tensors (its kernels' plain versions).  Beside it: the
dynamic loss scale's skip, the scaler's state sequence, the loss function,
the eager ``FusedAdam.step``, the dropout generator, and the options the
slice does not port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu.amp import scaler as jax_scaler
from apex_tpu.kernels.dispatch import force_mode
from apex_tpu.models import GptModel as JaxGpt
from apex_tpu.nn import functional as jax_F
from apex_tpu.nn.parameter import Parameter as JaxParameter
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.training import make_train_step as jax_make_train_step

from apex_tpu_torch.amp import LossScaler, ScalerState, update_scale_state
from apex_tpu_torch.models import GptModel, from_jax_state_dict, \
    to_numpy_state_dict
from apex_tpu_torch.models.gpt import dropout
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step
from apex_tpu_torch.training.step import dropout_seed

torch.set_num_threads(2)

V, E, L, HEADS, S, B = 128, 64, 2, 4, 16, 2
CFG = dict(vocab_size=V, hidden=E, layers=L, heads=HEADS, max_positions=S,
           dropout=0.0, attn_dropout=0.0)
LR, WD = 1e-3, 0.1


def _jax_loss(logits, ids, w=None):
    flat = logits[:, :-1].reshape((-1, logits.shape[-1]))
    loss = jax_F.cross_entropy(flat, ids[:, 1:].reshape((-1,)))
    return loss if w is None else loss * w


def _torch_loss(logits, ids, w=None):
    flat = logits[:, :-1].reshape(-1, logits.shape[-1])
    loss = F.cross_entropy(flat, ids[:, 1:].reshape(-1))
    return loss if w is None else loss * w


def _models(seed=5, **kw):
    cfg = {**CFG, **kw}
    jnn.manual_seed(seed)
    jm = JaxGpt(**cfg)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(GptModel(**cfg, device="cpu"), sd)


def _ids(seed=1):
    return np.random.default_rng(seed).integers(0, V, (B, S))


def _masters(step, named):
    return {n: np.asarray(jnp.asarray(m, jnp.float32)) if not isinstance(
        m, torch.Tensor) else m.detach().float().numpy()
        for (n, _), m in zip(named, step.state.master_params)}


@pytest.mark.parametrize("half", ["float32", "bfloat16"])
def test_train_step_matches_jax(half):
    jm, tm = _models()
    jstep = jax_make_train_step(
        jm, JaxFusedAdam(list(jm.parameters()), lr=LR, weight_decay=WD),
        _jax_loss, half_dtype=None if half == "float32" else jnp.bfloat16,
        loss_scale=1.0)
    tstep = make_train_step(
        tm, FusedAdam(list(tm.parameters()), lr=LR, weight_decay=WD),
        _torch_loss, half_dtype=None if half == "float32" else torch.bfloat16,
        loss_scale=1.0)
    ids = _ids()
    with force_mode("interpret"):
        want = [float(jstep(jnp.asarray(ids), jnp.asarray(ids)))
                for _ in range(4)]
    got = [float(tstep(torch.from_numpy(ids), torch.from_numpy(ids)))
           for _ in range(4)]
    # fp32: the same arithmetic up to summation order.  bf16: the two
    # frameworks round the bf16 activations at different places
    rtol = 1e-5 if half == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]
    assert int(tstep.state.step) == int(jstep.state.step) == 4
    # Adam moves a parameter by about lr a step whatever the size of its
    # gradient, so a near-zero gradient whose sign differs between the two
    # (sums in another order) may part the two masters by up to 2 lr a
    # step (8 lr over 4 steps bounds every element); nearly all elements
    # agree to fp32 rounding, and in bf16, whose gradients round
    # differently on the two sides, 99% of them within 1e-3
    jw = _masters(jstep, jm.named_parameters())
    tw = _masters(tstep, tm.named_parameters())
    assert set(jw) == set(tw) == set(to_numpy_state_dict(tm))
    diff = np.concatenate([np.abs(tw[n] - jw[n]).ravel() for n in jw])
    assert diff.max() <= 8 * LR
    close, share = (1e-5, 0.999) if half == "float32" else (1e-3, 0.99)
    assert (diff <= close).mean() >= share, (diff > close).sum()
    # the half copies are the masters rounded, and sync_to_objects hands
    # them to the model
    tstep.sync_to_objects()
    sd = to_numpy_state_dict(tm)
    for name, w in tw.items():
        t = torch.from_numpy(w)
        if half == "bfloat16":
            t = t.bfloat16().float()
        np.testing.assert_array_equal(sd[name], t.numpy())


def test_dynamic_scale_skip_matches_jax():
    """fp16 half copies under the dynamic scale: a loss made non-finite at
    step 2 skips that step on both sides (masters, step count unchanged)
    and halves the scale; the steps around it apply."""
    jm, tm = _models(seed=6)
    kw = dict(loss_scale="dynamic", max_loss_scale=2.0 ** 10)
    jstep = jax_make_train_step(
        jm, JaxFusedAdam(list(jm.parameters()), lr=LR, weight_decay=WD),
        _jax_loss, half_dtype=jnp.float16, **kw)
    tstep = make_train_step(
        tm, FusedAdam(list(tm.parameters()), lr=LR, weight_decay=WD),
        _torch_loss, half_dtype=torch.float16, **kw)
    ids = _ids(2)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    seen = {"jax": [], "port": []}
    before_skip = {}
    for i, w in enumerate((1.0, float("inf"), 1.0, 1.0)):
        if i == 1:
            before_skip = {k: _masters(s, named) for k, s, named in (
                ("jax", jstep, jm.named_parameters()),
                ("port", tstep, tm.named_parameters()))}
        with force_mode("interpret"):
            jstep(jids, jids, jnp.asarray(w, jnp.float32))
        tstep(tids, tids, torch.tensor(w))
        for key, st in (("jax", jstep.state), ("port", tstep.state)):
            seen[key].append((int(st.scaler.overflow),
                              float(st.scaler.loss_scale), int(st.step)))
        if i == 1:
            for key, s, named in (("jax", jstep, jm.named_parameters()),
                                  ("port", tstep, tm.named_parameters())):
                after = _masters(s, named)
                for name, v in before_skip[key].items():
                    np.testing.assert_array_equal(after[name], v)
    assert seen["port"] == seen["jax"] == [
        (0, 1024.0, 1), (1, 512.0, 1), (0, 512.0, 2), (0, 512.0, 3)]
    assert int(tstep.last_step_skipped) == 0
    jw = _masters(jstep, jm.named_parameters())
    tw = _masters(tstep, tm.named_parameters())
    for name in jw:
        np.testing.assert_allclose(tw[name], jw[name], rtol=0, atol=6 * LR,
                                   err_msg=name)


def test_update_scale_state_matches_jax():
    """The scaler's sequence over a scripted overflow pattern: halving,
    the minimum, growth after ``scale_window`` clean steps, the maximum;
    and the static scale."""
    pattern = [0, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    kw = dict(scale_window=3, min_loss_scale=2.0 ** 13,
              max_loss_scale=2.0 ** 17)
    for dynamic in (True, False):
        js = jax_scaler.ScalerState(jnp.asarray(2.0 ** 16, jnp.float32),
                                    jnp.zeros((), jnp.int32),
                                    jnp.zeros((), jnp.int32))
        ts = ScalerState(torch.tensor(2.0 ** 16), torch.tensor(0,
                                                                dtype=torch.int32),
                         torch.tensor(0, dtype=torch.int32))
        for ov in pattern:
            js = js._replace(overflow=jnp.asarray(ov, jnp.int32))
            ts = ts._replace(overflow=torch.tensor(ov, dtype=torch.int32))
            js, jskip = jax_scaler.update_scale_state(js, dynamic=dynamic,
                                                      **kw)
            ts, tskip = update_scale_state(ts, dynamic=dynamic, **kw)
            assert float(ts.loss_scale) == float(js.loss_scale)
            assert int(ts.unskipped) == int(js.unskipped)
            assert bool(tskip) == bool(jskip)
            assert int(ts.overflow) == int(js.overflow) == 0
    scaler = LossScaler("dynamic", device="cpu")
    masters = scaler.unscale([torch.tensor([2.0, float("inf")])],
                             [torch.zeros(2)])
    assert masters[0][0] == 2.0 / 65536
    assert scaler.update_scale() is True and scaler.loss_scale() == 32768.0


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(reduction, smoothing, weighted):
    r = np.random.default_rng(7)
    n, c = 9, 11
    logits = r.normal(0, 2, (n, c)).astype(np.float32)
    logits[2, 7:] = -1e30              # a masked-vocabulary row
    logits[5, 0] = -1e30
    target = r.integers(0, c, n)
    target[[1, 4, 6]] = [-1, c, c + 3]   # out of range: loss 0
    weight = r.uniform(0.5, 2.0, c).astype(np.float32) if weighted else None
    want = jax_F.cross_entropy(
        jnp.asarray(logits), jnp.asarray(target),
        weight=None if weight is None else jnp.asarray(weight),
        reduction=reduction, label_smoothing=smoothing)
    got = F.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(target),
        weight=None if weight is None else torch.from_numpy(weight),
        reduction=reduction, label_smoothing=smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_cross_entropy_extra_dims_and_bf16_logits_match_jax():
    r = np.random.default_rng(8)
    logits = jnp.asarray(r.normal(size=(3, 6, 4)), jnp.bfloat16)
    target = r.integers(0, 6, (3, 4))
    want = jax_F.cross_entropy(logits, jnp.asarray(target),
                               reduction="none")
    got = F.cross_entropy(
        torch.from_numpy(np.array(logits.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(target), reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="reduction"):
        F.cross_entropy(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                        reduction="max")


def test_eager_fused_adam_matches_jax_over_two_groups():
    r = np.random.default_rng(9)
    shapes = [(5, 3), (7,), (4, 4), (6,)]
    init = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[r.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    groups = [dict(lr=1e-2, weight_decay=0.1),
              dict(lr=3e-3, weight_decay=0.0, bias_correction=False)]
    jp = [JaxParameter(jnp.asarray(a)) for a in init]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jopt = JaxFusedAdam([{"params": jp[:2], **groups[0]},
                         {"params": jp[2:], **groups[1]}], betas=(0.8, 0.99))
    topt = FusedAdam([{"params": tp[:2], **groups[0]},
                      {"params": tp[2:], **groups[1]}], betas=(0.8, 0.99))
    for gs in grads:
        for p, g in zip(jp, gs):
            p.grad = jnp.asarray(g)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
    assert [g["step"] for g in topt.param_groups] == [3, 3]
    # the JAX step computes the bias corrections in fp32 on the device, the
    # port's eager step in double on the host: a few fp32 roundings apart
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b.data),
                                   rtol=1e-6, atol=1e-7)
        st = topt.state[a]
        assert st["exp_avg"].dtype == torch.float32
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(jopt.state[b]["exp_avg"]),
                                   rtol=1e-6, atol=1e-7)
    topt.zero_grad()
    assert all(p.grad is None for p in tp)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(tp, amsgrad=True)
    with pytest.raises(RuntimeError, match="step\\(\\) with no"):
        topt.step(grads=[1])


def test_dropout_generator_reproducible_rate_and_per_step():
    x = torch.ones(400, 250)

    def draw(seed, step):
        g = torch.Generator().manual_seed(dropout_seed(seed, step))
        return dropout(x, 0.1, True, g)

    a = draw(7, 3)
    assert torch.equal(a, draw(7, 3))
    assert not torch.equal(a, draw(7, 4))
    assert not torch.equal(a, draw(8, 3))
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005            # 100000 draws: ~5 sigma
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.9))
    assert torch.equal(dropout(x, 0.1, False, None), x)
    # a train step seeds its model's dropout from (rng_seed, call index):
    # the same seed gives the same losses, another seed other losses, and
    # the masks change from call to call
    losses = {}
    for seed in (3, 3, 4):
        _, tm = _models(seed=10, dropout=0.3)
        step = make_train_step(tm, FusedAdam(list(tm.parameters()), lr=0.0),
                               _torch_loss, loss_scale=1.0, rng_seed=seed)
        ids = torch.from_numpy(_ids(3))
        losses.setdefault(seed, []).append(
            [float(step(ids, ids)) for _ in range(2)])
    assert losses[3][0] == losses[3][1]
    assert losses[3][0] != losses[4][0]
    assert losses[3][0][0] != losses[3][0][1]   # lr 0: only the mask moved


def test_unported_make_train_step_options_raise():
    _, tm = _models()
    opt = FusedAdam(list(tm.parameters()), lr=LR)
    for kw in (dict(tp_axis="model"), dict(axis_name="model"),
               dict(parallel="auto")):
        with pytest.raises(NotImplementedError, match="not ported"):
            make_train_step(tm, opt, _torch_loss, **kw)
    # data parallelism, its knobs, flat masters and ZeRO are ported (A9's
    # first part): the data axis builds, the knobs alone are the JAX
    # step's no-ops, flat_master stacks, zero_sharding wraps
    from apex_tpu_torch.parallel import ZeroTrainStep
    for kw in (dict(axis_name="data"), dict(gradient_predivide_factor=2.0),
               dict(allreduce_always_fp32=True), dict(flat_master=True)):
        assert make_train_step(tm, opt, _torch_loss, **kw).state.step == 0
    assert isinstance(make_train_step(tm, opt, _torch_loss,
                                      zero_sharding=True), ZeroTrainStep)
    # telemetry, once refused here, is ported: the step carries its
    # accumulator
    assert make_train_step(tm, opt, _torch_loss,
                           telemetry=True).state.telem is not None
    # every fused optimizer of the JAX step is ported; another one raises
    # the JAX step's TypeError
    sgd = torch.optim.SGD(tm.parameters(), lr=0.1)
    with pytest.raises(TypeError, match="supported: FusedSGD, FusedAdam, "
                                        "FusedLAMB, FusedNovoGrad"):
        make_train_step(tm, sgd, _torch_loss)


def test_to_numpy_state_dict_round_trips():
    jm, tm = _models(seed=12)
    sd = to_numpy_state_dict(tm)
    assert set(sd) == set(jm.state_dict())
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(sd[k], np.asarray(v))
    tm.bfloat16()
    sd16 = to_numpy_state_dict(tm)
    assert all(v.dtype == np.float32 for v in sd16.values())
    back = from_jax_state_dict(GptModel(**CFG, device="cpu"), sd16)
    assert torch.equal(back.tok_emb.weight, tm.tok_emb.weight.float())


# --- the chunked and fused losses, accumulation, lr schedules ---

XV = 1003
XCFG = dict(CFG, vocab_size=XV)


def _xmodels(seed=21, **kw):
    cfg = {**XCFG, **kw}
    jnn.manual_seed(seed)
    jm = JaxGpt(**cfg)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(GptModel(**cfg, device="cpu"), sd)


def _xids(seed, b=B):
    return np.random.default_rng(seed).integers(0, XV, (b, S))


def _jax_fused_loss(logits, ids):
    from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss
    flat = logits[:, :-1].reshape((-1, logits.shape[-1]))
    return jnp.mean(softmax_cross_entropy_loss(
        flat, ids[:, 1:].reshape((-1,)), 0.0, -1, True))


def _torch_fused_loss(logits, ids):
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
    flat = logits[:, :-1].reshape(-1, logits.shape[-1])
    return softmax_cross_entropy_loss(flat, ids[:, 1:].reshape(-1), 0.0, -1,
                                      True).mean()


def _losses(mode):
    """(output_hidden, JAX loss, port loss) of a bench loss mode."""
    if mode == "fused":
        return False, _jax_fused_loss, _torch_fused_loss
    from apex_tpu.contrib.xentropy import make_chunked_lm_loss as jax_mcl
    from apex_tpu_torch.contrib.xentropy import make_chunked_lm_loss
    # 30 rows in chunks of 8: three full chunks and a padded remainder
    return (True, jax_mcl(vocab_size=XV, padding_idx=-1, chunk_rows=8),
            make_chunked_lm_loss(vocab_size=XV, padding_idx=-1,
                                 chunk_rows=8))


def _run_pair(mode, ids, steps=4, jax_kw=None, port_kw=None, **kw):
    """Losses and scaler histories of the JAX and the port's
    ``make_train_step`` from the same weights, fp32, dynamic scale."""
    hidden, jloss, tloss = _losses(mode)
    jm, tm = _xmodels(output_hidden=hidden)
    jstep = jax_make_train_step(
        jm, JaxFusedAdam(list(jm.parameters()), lr=LR, weight_decay=WD),
        jloss, loss_scale="dynamic", **kw, **(jax_kw or {}))
    tstep = make_train_step(
        tm, FusedAdam(list(tm.parameters()), lr=LR, weight_decay=WD),
        tloss, loss_scale="dynamic", **kw, **(port_kw or {}))
    out = {}
    for key, step, arr in (("jax", jstep, jnp.asarray),
                           ("port", tstep, torch.from_numpy)):
        losses, hist = [], []
        x = arr(ids)
        for _ in range(steps):
            with force_mode("interpret"):
                losses.append(float(step(x, x)))
            st = step.state.scaler
            hist.append((int(st.overflow), float(st.loss_scale),
                         int(st.unskipped), int(step.state.step)))
        out[key] = (losses, hist, step)
    return out, jm, tm


@pytest.mark.parametrize("mode", ["chunked", "fused"])
def test_loss_mode_train_steps_match_jax(mode):
    out, jm, tm = _run_pair(mode, _xids(31))
    (jl, jh, jstep), (tl, th, tstep) = out["jax"], out["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert th == jh == [(0, 65536.0, i, i) for i in range(1, 5)]
    assert tl[-1] < tl[0]
    jw = _masters(jstep, jm.named_parameters())
    tw = _masters(tstep, tm.named_parameters())
    diff = np.concatenate([np.abs(tw[n] - jw[n]).ravel() for n in jw])
    assert diff.max() <= 8 * LR
    assert (diff <= 1e-5).mean() >= 0.999


@pytest.mark.parametrize("stacked", [False, True])
def test_gradient_accumulation_matches_jax(stacked):
    ids = _xids(32, b=4)
    if stacked:
        ids = ids.reshape(2, 2, S)
    # a static scale of 1.0 (the bf16 recipe's) with a loss weight that
    # is broadcast to every microbatch, not split
    kw = dict(accum_steps=2, accum_stacked=stacked)
    hidden, jloss, tloss = _losses("chunked")
    jm, tm = _xmodels(output_hidden=hidden)
    jstep = jax_make_train_step(
        jm, JaxFusedAdam(list(jm.parameters()), lr=LR, weight_decay=WD),
        lambda out, x, w: jloss(out, x) * w, loss_scale=1.0, **kw)
    tstep = make_train_step(
        tm, FusedAdam(list(tm.parameters()), lr=LR, weight_decay=WD),
        lambda out, x, w: tloss(out, x) * w, loss_scale=1.0, **kw)
    with force_mode("interpret"):
        jl = [float(jstep(jnp.asarray(ids), jnp.asarray(ids),
                          jnp.asarray(0.5, jnp.float32))) for _ in range(3)]
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(ids),
                      torch.tensor(0.5))) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert int(tstep.state.step) == int(jstep.state.step) == 3
    jw = _masters(jstep, jm.named_parameters())
    tw = _masters(tstep, tm.named_parameters())
    diff = np.concatenate([np.abs(tw[n] - jw[n]).ravel() for n in jw])
    assert diff.max() <= 6 * LR and (diff <= 1e-5).mean() >= 0.999
    with pytest.raises(ValueError, match="microbatch count" if stacked
                       else "not divisible"):
        tstep(torch.from_numpy(_xids(1, b=3)), torch.from_numpy(_xids(1, b=3)),
              torch.tensor(1.0))


def test_accumulation_options_are_checked_like_jax():
    _, tm = _xmodels()
    opt = FusedAdam(list(tm.parameters()), lr=LR)
    with pytest.raises(ValueError, match="conflicts"):
        make_train_step(tm, opt, _torch_fused_loss, accum_steps=2,
                        grad_accum_steps=3)
    with pytest.raises(ValueError, match="accum_stacked"):
        make_train_step(tm, opt, _torch_fused_loss, accum_stacked=True)
    with pytest.raises(ValueError, match=">= 1"):
        make_train_step(tm, opt, _torch_fused_loss, grad_accum_steps=0)
    step = make_train_step(tm, opt, _torch_fused_loss, accum_steps=2,
                           accum_stacked=True, loss_scale=1.0)
    with pytest.raises(ValueError, match="microbatch count"):
        step(torch.from_numpy(_xids(2, b=3)), torch.from_numpy(_xids(2, b=3)))


def test_lr_schedule_matches_jax():
    from apex_tpu.optimizers.schedules import warmup_cosine as jwc
    from apex_tpu_torch.optimizers import warmup_cosine
    out, jm, tm = _run_pair("fused", _xids(33), steps=4,
                            jax_kw=dict(lr_schedule=jwc(2, 8)),
                            port_kw=dict(lr_schedule=warmup_cosine(2, 8)))
    (jl, jh, jstep), (tl, th, tstep) = out["jax"], out["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert th == jh
    jw = _masters(jstep, jm.named_parameters())
    tw = _masters(tstep, tm.named_parameters())
    diff = np.concatenate([np.abs(tw[n] - jw[n]).ravel() for n in jw])
    assert diff.max() <= 8 * LR and (diff <= 1e-5).mean() >= 0.999


def test_schedules_match_jax():
    from apex_tpu.optimizers import schedules as js
    from apex_tpu_torch.optimizers import schedules as ts
    pairs = [(js.warmup_poly(3, 10, 2.0, 0.1), ts.warmup_poly(3, 10, 2.0,
                                                              0.1)),
             (js.warmup_linear(2, 9), ts.warmup_linear(2, 9)),
             (js.warmup_cosine(4, 20, 0.05), ts.warmup_cosine(4, 20, 0.05)),
             (js.step_decay([3, 6], [0.5, 0.1]),
              ts.step_decay([3, 6], [0.5, 0.1]))]
    for jf, tf in pairs:
        for step in range(0, 25):
            got = tf(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jf(step)),
                                       rtol=1e-6, atol=1e-7)
            assert float(tf(step)) == float(got)
    with pytest.raises(ValueError, match="warmup"):
        ts.warmup_cosine(5, 5)
    with pytest.raises(ValueError, match="ascending"):
        ts.step_decay([5, 2], [0.1, 0.2])


def test_output_hidden_matches_jax():
    from apex_tpu.nn.modules import Ctx
    jm, tm = _xmodels(seed=22, output_hidden=True)
    ids = _xids(34)
    with force_mode("interpret"):
        jh, jt = jm.forward(Ctx(env={}, training=False), jnp.asarray(ids))
    tm.eval()
    with torch.no_grad():
        th, tt = tm(torch.from_numpy(ids))
    assert tuple(th.shape) == (B, S, E) and tt is tm.tok_emb.weight
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tt.detach().numpy(), np.asarray(jt))
    # the cached paths still return logits
    caches = tm.init_caches(B, S)
    with torch.no_grad():
        logits, _ = tm.prefill(torch.from_numpy(ids[:, :4]), caches)
    assert logits.shape == (B, 4, XV)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_adam_half_params_and_moments_equal_adam_unfused(dtype):
    """B12's plain version with p, m and v in a half dtype (amp O3) is bit
    for bit the JAX package's per-tensor Adam, each result cast back to its
    own dtype."""
    from apex_tpu.ops import multi_tensor as jops
    from apex_tpu_torch import ops
    from apex_tpu_torch.kernels import multi_tensor as mt
    r = np.random.default_rng(40)
    shapes = [(6, 5), (33,), (4, 4, 3)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def arr(scale, pos=False):
        return [np.array(jnp.asarray((np.abs if pos else np.asarray)(
            r.normal(0, scale, s)).astype(np.float32), jd).astype(
                jnp.float32)) for s in shapes]

    g, p, m, v = arr(1.0), arr(1.0), arr(0.1), arr(0.01, pos=True)
    for mode, wd in ((0, 0.0), (1, 0.1), (0, 0.1)):
        _, jp, jm_, jv = jops.adam_unfused(
            jnp.zeros((), jnp.int32),
            [[jnp.asarray(a, jd) for a in lst] for lst in (g, p, m, v)],
            1e-2, 0.9, 0.999, 1e-8, 3, mode, True, wd)
        lists = [[torch.from_numpy(a).to(td) for a in lst]
                 for lst in (g, p, m, v)]
        mt.fused_adam(ops.zero_flag("cpu"), lists, 1e-2, 0.9, 0.999, 1e-8,
                      3, mode, True, wd)
        for got, want in zip(lists[1:], (jp, jm_, jv)):
            for a, b in zip(got, want):
                assert a.dtype == td
                np.testing.assert_array_equal(
                    a.float().numpy(), np.asarray(b.astype(jnp.float32)))
