"""``amp.initialize`` + ``amp.scale_loss`` of the port against the JAX
package's, on a small GPT whose weights are carried across by
``from_jax_state_dict``, with the fused xentropy loss.

Both packages train the same weights on the same batch through the same
eager loop (forward, ``scale_loss``, backward, ``step``, ``zero_grad``):
O0 within 1e-5, O2 and O3 within the JAX amp test's ``rtol=0.05``, and the
tensors the optimizer updates (O2's fp32 masters, O3's half parameters and
moments) within fp16 rounding of the JAX optimizer's.  Beside it: O2's structure, the overflow skip and the scale halving (the same
history on both sides), ``delay_unscale``, the amp checkpoint state, O1
and ``defer_scale_update`` accepted (the deferred mode is held in
``tests/test_torch_amp_deferred.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.nn as jnn
from apex_tpu import amp as jamp
from apex_tpu.amp._amp_state import reset as jax_reset
from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss as jax_sxe
from apex_tpu.models import GptModel as JaxGpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch import amp
from apex_tpu_torch.amp._amp_state import _amp_state
from apex_tpu_torch.amp._amp_state import reset as port_reset
from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
from apex_tpu_torch.models import GptModel, from_jax_state_dict
from apex_tpu_torch.ops import (multi_tensor_axpby, multi_tensor_l2norm,
                                multi_tensor_maxnorm)
from apex_tpu_torch.optimizers import FusedAdam

torch.set_num_threads(2)

V, E, L, HEADS, S, B = 1003, 64, 2, 4, 16, 2
CFG = dict(vocab_size=V, hidden=E, layers=L, heads=HEADS, max_positions=S,
           dropout=0.0, attn_dropout=0.0)
LR = 1e-3
WD = 0.1


class _JaxLmLoss(jnn.Module):
    """The fused-xentropy next-token loss as a JAX module, so the JAX tape
    records it."""

    def forward(self, ctx, logits, ids):
        flat = logits[:, :-1].reshape((-1, logits.shape[-1]))
        return jnp.mean(jax_sxe(flat, ids[:, 1:].reshape((-1,)), 0.0, -1,
                                True))


def _port_loss(logits, ids):
    flat = logits[:, :-1].reshape(-1, logits.shape[-1])
    return SoftmaxCrossEntropyLoss.apply(flat, ids[:, 1:].reshape(-1), 0.0,
                                         -1, True).mean()


def _models(seed=3):
    jnn.manual_seed(seed)
    jm = JaxGpt(**CFG)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(GptModel(**CFG, device="cpu"), sd)


def _ids(seed=1):
    return np.random.default_rng(seed).integers(0, V, (B, S))


def _eps(opt_level):
    """Adam's eps: fp16 second moments (O3 keeps them in the parameters'
    dtype) flush to 0 below 6e-8, so at eps 1e-8 a small gradient's update
    m / (sqrt(v) + eps) blows up on both sides; 1e-4 keeps O3 trainable."""
    return 1e-4 if opt_level == "O3" else 1e-8


def _jax_run(jm, opt_level, steps, **kw):
    jax_reset()
    opt = JaxFusedAdam(list(jm.parameters()), lr=LR, eps=_eps(opt_level),
                       weight_decay=WD)
    jm, opt = jamp.initialize(jm, opt, opt_level=opt_level, verbosity=0,
                              **kw)
    crit = _JaxLmLoss()
    ids = jnp.asarray(_ids())
    losses = []
    for _ in range(steps):
        loss = crit(jm(ids), ids)
        with jamp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss))
    return jm, opt, losses


def _port_run(tm, opt_level, steps, **kw):
    port_reset()
    opt = FusedAdam(list(tm.parameters()), lr=LR, eps=_eps(opt_level),
                    weight_decay=WD)
    tm, opt = amp.initialize(tm, opt, opt_level=opt_level, verbosity=0,
                             **kw)
    ids = torch.from_numpy(_ids())
    losses = []
    for _ in range(steps):
        loss = _port_loss(tm(ids), ids)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    return tm, opt, losses


def _optimizer_state(opt, model, jax_side):
    """name -> [param, exp_avg, exp_avg_sq] as fp32 numpy, for the tensors
    the optimizer updates: the fp32 master of each half model parameter
    (O2), else the model parameter itself (O0, O3)."""
    stash = getattr(opt, "_amp_stash", None)
    halves = list(getattr(stash, "all_fp16_params", None) or [])
    masters = list(getattr(stash, "all_fp32_from_fp16_params", None) or [])
    if jax_side:
        def arr(x):
            return np.asarray(jnp.asarray(x, jnp.float32))
    else:
        def arr(x):
            return x.detach().float().numpy()
    out = {}
    for name, mp in model.named_parameters():
        p = next((m for h, m in zip(halves, masters) if h is mp), mp)
        st = opt.state[p]
        out[name] = [arr(p.data if jax_side else p), arr(st["exp_avg"]),
                     arr(st["exp_avg_sq"])]
    return out


def _ulp16(x):
    """The fp16 spacing at |x| (2^-24 in its subnormal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -14)))
    return 2.0 ** (e - 10)


def _assert_optimizer_state_close(got, want, init, half, steps):
    """Every element within a loose bound and 99.9% within rounding.
    Parameters: the gradients of the two sides, each rounded through a
    half forward and backward, differ in sign where they are tiny, and
    there Adam's updates differ by a step's size; so every element within
    twice the largest distance the reference moved an element of that
    tensor from ``init``, and 99.9% within lr / 10.  Moments: in units of
    each tensor's largest value, 16 fp16 epsilons at most and 4 for 99.9%.
    Half state (O3) may differ by its own rounding on top (one fp16 spacing
    of the value a step for parameters, two for moments), and its fp16
    second moments flush to 0 below 6e-8, where the update becomes
    m / eps: so 99.9% of its parameters within lr / 2."""
    assert sorted(got) == sorted(want)
    for k, what in enumerate(("params", "exp_avg", "exp_avg_sq")):
        diff, loose, fine = [], [], []
        for name, w in want.items():
            w = w[k]
            ulp = _ulp16(w) if half else 0.0
            if k == 0:
                moved = np.abs(w - init[name]).max()
                lo = 2 * moved + steps * ulp
                fi = (LR / 2 if half else LR / 10) + ulp
            else:
                scale = np.abs(w).max()
                lo = 2.0 ** -7 * scale + 2 * ulp
                fi = 2.0 ** -9 * scale + 2 * ulp
            diff.append(np.abs(got[name][k] - w).ravel())
            loose.append(np.broadcast_to(lo, w.shape).ravel())
            fine.append(np.broadcast_to(fi, w.shape).ravel())
        diff, loose, fine = map(np.concatenate, (diff, loose, fine))
        assert (diff <= loose).all(), (what, float((diff / loose).max()))
        assert (diff <= fine).mean() >= 0.999, (what,
                                                (diff <= fine).mean())


@pytest.mark.parametrize("opt_level,rtol", [("O0", 1e-5), ("O2", 0.05),
                                            ("O3", 0.05)])
def test_opt_levels_match_jax(opt_level, rtol):
    jm, tm = _models()
    init = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    jm, jopt, want = _jax_run(jm, opt_level, 3)
    tm, opt, got = _port_run(tm, opt_level, 3)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]
    assert [g["step"] for g in opt.param_groups] == [3]
    _assert_optimizer_state_close(_optimizer_state(opt, tm, False),
                                  _optimizer_state(jopt, jm, True), init,
                                  opt_level == "O3", 3)
    if opt_level == "O3":
        # pure half training: half parameters and half moments, updated
        # by the Adam kernel's half path (its plain version on the CPU)
        p = opt.param_groups[0]["params"][0]
        assert p.dtype == torch.float16
        assert opt.state[p]["exp_avg"].dtype == torch.float16


def test_o2_structure():
    _, tm = _models()
    tm, opt, _ = _port_run(tm, "O2", 2)
    assert all(p.dtype == torch.float16 for p in tm.parameters())
    masters = opt.param_groups[0]["params"]
    assert all(p.dtype == torch.float32 for p in masters)
    assert len(masters) == len(list(tm.parameters()))
    # the half model holds the masters rounded
    for half, master in zip(tm.parameters(), masters):
        assert torch.equal(half, master.detach().half())
    assert all(v.dtype == torch.float32 for v in tm.state_dict().values())
    # the output hook casts the logits to fp32, the input ids stay ints
    logits = tm(torch.from_numpy(_ids()))
    assert logits.dtype == torch.float32
    assert list(amp.master_params(opt)) == masters
    # a group added later gets its masters too
    extra = torch.nn.Parameter(torch.ones(3, dtype=torch.float16))
    opt.add_param_group({"params": extra})
    new_master = opt.param_groups[1]["params"][0]
    assert new_master.dtype == torch.float32 and new_master is not extra
    assert opt._amp_stash.all_fp16_params[-1] is extra
    assert opt._amp_stash.all_fp32_from_fp16_params[-1] is new_master


def _overflow_history(make_loss_inf_at, steps):
    """Scale and skip history of the port's O2 loop with the gradient of
    one half parameter made non-finite at one step."""
    _, tm = _models(seed=6)
    port_reset()
    opt = FusedAdam(list(tm.parameters()), lr=LR)
    tm, opt = amp.initialize(tm, opt, opt_level="O2", verbosity=0,
                             max_loss_scale=2.0 ** 10)
    ids = torch.from_numpy(_ids(2))
    hist = []
    for i in range(steps):
        loss = _port_loss(tm(ids), ids)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
            if i == make_loss_inf_at:
                p16 = opt._amp_stash.all_fp16_params[0]
                p16.grad[(0,) * p16.grad.dim()] = float("inf")
        before = [p.detach().clone() for p in opt.param_groups[0]["params"]]
        opt.step()
        after = opt.param_groups[0]["params"]
        skipped = all(torch.equal(a, b) for a, b in zip(after, before))
        hist.append((skipped, _amp_state.loss_scalers[0].loss_scale()))
        opt.zero_grad()
    return hist, opt


def test_overflow_skips_the_step_and_halves_the_scale_like_jax():
    hist, opt = _overflow_history(1, 4)
    assert hist == [(False, 1024.0), (True, 512.0), (False, 512.0),
                    (False, 512.0)]
    assert opt.param_groups[0]["step"] == 3
    # the JAX package's O2 loop, the same planted overflow
    jm, _ = _models(seed=6)
    jax_reset()
    jopt = JaxFusedAdam(list(jm.parameters()), lr=LR)
    jm, jopt = jamp.initialize(jm, jopt, opt_level="O2", verbosity=0,
                               max_loss_scale=2.0 ** 10)
    crit = _JaxLmLoss()
    ids = jnp.asarray(_ids(2))
    jhist = []
    for i in range(4):
        loss = crit(jm(ids), ids)
        with jamp.scale_loss(loss, jopt) as scaled:
            scaled.backward()
            if i == 1:
                p16 = jopt._amp_stash.all_fp16_params[0]
                p16.grad = p16.grad.at[(0,) * p16.grad.ndim].set(np.inf)
        before = [np.asarray(p.data) for p in jopt.param_groups[0]["params"]]
        jopt.step()
        skipped = all(np.array_equal(np.asarray(p.data), b) for p, b in
                      zip(jopt.param_groups[0]["params"], before))
        jhist.append((skipped,
                      jamp._amp_state.loss_scalers[0].loss_scale()))
        jopt.zero_grad()
    assert jhist == hist


def _accumulate(delay, ids_pair):
    _, tm = _models(seed=8)
    port_reset()
    opt = FusedAdam(list(tm.parameters()), lr=LR)
    tm, opt = amp.initialize(tm, opt, opt_level="O2", verbosity=0)
    for i, ids in enumerate(ids_pair):
        loss = _port_loss(tm(ids), ids)
        with amp.scale_loss(loss, opt,
                            delay_unscale=delay and i == 0) as scaled:
            scaled.backward()
    grads = [p.grad.clone() for p in opt.param_groups[0]["params"]]
    opt.step()
    return grads, [p.detach().clone() for p in opt.param_groups[0]["params"]]


def test_delay_unscale_accumulates_like_the_undelayed_loop():
    """Two backward passes into one step: the delayed window keeps the
    half gradients scaled and unscales once; the undelayed one unscales
    each pass into the fp32 masters.  With the same batch twice both sums
    are exact (a doubling), so the master gradients and masters agree
    bit for bit; with two batches the delayed half sum rounds once more."""
    ids = torch.from_numpy(_ids(3))
    g_d, m_d = _accumulate(True, (ids, ids))
    g_n, m_n = _accumulate(False, (ids, ids))
    for a, b in zip(g_d + m_d, g_n + m_n):
        assert torch.equal(a, b)
    other = torch.from_numpy(_ids(4))
    g_d, _ = _accumulate(True, (ids, other))
    g_n, _ = _accumulate(False, (ids, other))
    for a, b in zip(g_d, g_n):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=1e-3 * float(b.abs().max()))


def test_amp_state_dict_round_trips():
    _, tm = _models()
    port_reset()
    opt = FusedAdam(list(tm.parameters()), lr=LR)
    amp.initialize(tm, opt, opt_level="O2", num_losses=2, verbosity=0)
    _amp_state.loss_scalers[1]._loss_scale = 128.0
    _amp_state.loss_scalers[1]._unskipped = 7
    sd = amp.state_dict()
    assert dict(sd) == {"loss_scaler0": {"loss_scale": 65536.0,
                                         "unskipped": 0},
                        "loss_scaler1": {"loss_scale": 128.0,
                                         "unskipped": 7}}
    _amp_state.loss_scalers[0]._loss_scale = 2.0
    amp.load_state_dict(sd)
    assert amp.state_dict() == sd
    with pytest.raises(RuntimeError, match="Unexpected key"):
        amp.load_state_dict({"nope": {}})


def test_o1_and_deferred_updates_raise_and_options_resolve():
    _, tm = _models()
    port_reset()
    opt = FusedAdam(list(tm.parameters()), lr=LR)
    # O1 is accepted: the model stays fp32 under the session's cast policy
    # (its casts are held against JAX in tests/test_torch_amp_o1.py)
    m1, _ = amp.initialize(tm, FusedAdam(list(tm.parameters()), lr=LR),
                           opt_level="O1", verbosity=0)
    assert m1 is tm and tm._amp_policy is _amp_state.ambient_policy
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    port_reset()
    # the deferred scale update is ported (tests/test_torch_amp_deferred.py
    # holds it against JAX): initialize takes it
    _, tmd = _models()
    amp.initialize(tmd, FusedAdam(list(tmd.parameters()), lr=LR),
                   opt_level="O2", defer_scale_update=True, verbosity=0)
    assert _amp_state.opt_properties.defer_scale_update is True
    port_reset()
    with pytest.raises(RuntimeError, match="Unexpected optimization"):
        amp.initialize(tm, opt, opt_level="O4", verbosity=0)
    assert amp.resolve_dtype("bf16") is torch.bfloat16
    assert amp.resolve_dtype(torch.float16) is torch.float16
    assert amp.get_default_half_dtype() is torch.float16
    m2, o2 = amp.initialize(tm, opt, enabled=False)
    assert m2 is tm and o2 is opt
    port_reset()
    m3, o3 = amp.initialize(tm, opt, opt_level="O2",
                            cast_model_type="bfloat16", verbosity=0)
    assert all(p.dtype == torch.bfloat16 for p in m3.parameters())
    # a second pass finds half parameters, then a processed optimizer
    with pytest.raises(RuntimeError, match="expected torch.float32"):
        amp.initialize(m3, o3, opt_level="O2", verbosity=0)
    _amp_state.allow_incoming_model_not_fp32 = True
    try:
        with pytest.raises(RuntimeError, match="only be passed"):
            amp.initialize(m3, o3, opt_level="O2", verbosity=0)
    finally:
        _amp_state.allow_incoming_model_not_fp32 = False


def test_multi_tensor_ops_match_jax():
    from apex_tpu.ops import multi_tensor as jops
    r = np.random.default_rng(11)
    xs = [r.normal(size=s).astype(np.float32) for s in ((5, 3), (7,))]
    ys = [r.normal(size=s).astype(np.float32) for s in ((5, 3), (7,))]
    ys[1][2] = np.inf
    jz = jnp.zeros((), jnp.int32)
    tz = torch.zeros((), dtype=torch.int32)
    for check in (-1, 0, 1):
        jflag, jout = jops.multi_tensor_axpby(
            jz, [[jnp.asarray(x) for x in xs], [jnp.asarray(y) for y in ys],
                 [jnp.zeros(x.shape, jnp.bfloat16) for x in xs]],
            0.5, -2.0, check)
        tflag, tout = multi_tensor_axpby(
            tz, [[torch.from_numpy(x) for x in xs],
                 [torch.from_numpy(y) for y in ys],
                 [torch.zeros(x.shape, dtype=torch.bfloat16) for x in xs]],
            0.5, -2.0, check)
        assert int(tflag) == int(jflag) == (0 if check == 0 else 1)
        for a, b in zip(tout, jout):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    for per in (False, True):
        for jfn, tfn in ((jops.multi_tensor_l2norm, multi_tensor_l2norm),
                         (jops.multi_tensor_maxnorm, multi_tensor_maxnorm)):
            _, jt, jp = jfn(jz, [[jnp.asarray(x) for x in xs]], per)
            _, tt, tp = tfn(tz, [[torch.from_numpy(x) for x in xs]], per)
            np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
            if per:
                np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                           rtol=1e-6)
            else:
                assert tp is None and jp is None
