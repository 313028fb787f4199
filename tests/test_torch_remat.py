"""``nn.checkpoint_forward`` and ``remat=True`` in the port's GPT, Llama,
BERT and ViT.

At dropout 0.1 (attention dropout inside the flash kernels' plain
versions, residual and embedding dropout from the generator), the remat
model's loss and gradients equal the model's without remat bit for bit,
and the generator ends where it would without remat; likewise two bf16
``make_train_step`` steps (losses and fp32 masters).  The products run
inside ``value_products``, since two separately computed CPU products may
differ in their last bits.  At dropout 0 the port's remat gradients are
held against the JAX package's remat gradients (fp32 within 1e-5 of the
largest value; the JAX side takes its Pallas kernels' plain references on
the CPU, as its own remat tests do).  Two tests pin the two things a plain
``torch.utils.checkpoint`` would get wrong and show that it does: the
recomputation runs after the step's parameter substitution has ended, and
the dropout masks come from an explicit generator.  A batch norm in
training is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

import apex_tpu.models as jmodels
import apex_tpu.nn as jnn
from apex_tpu.nn.modules import Ctx

from apex_tpu_torch import models
from apex_tpu_torch.nn import checkpoint_forward
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.training import make_train_step
from torch_products import value_products

torch.set_num_threads(2)

LM = dict(vocab_size=64, hidden=32, layers=2, heads=4, max_positions=12)
CFGS = {
    "gpt": (models.GptModel, jmodels.GptModel, dict(LM)),
    "llama": (models.LlamaModel, jmodels.LlamaModel,
              dict(LM, kv_heads=2, intermediate=64)),
    "bert": (models.BertModel, jmodels.BertModel,
             dict(LM, intermediate=64)),
    "vit": (models.VitModel, jmodels.VitModel,
            dict(image_size=16, patch_size=4, hidden=32, layers=2, heads=4,
                 num_classes=10)),
}
DROPOUT = {"gpt": dict(dropout=0.1, attn_dropout=0.1),
           "bert": dict(dropout=0.1, attn_dropout=0.1),
           "vit": dict(dropout=0.1, attn_dropout=0.1), "llama": {}}
NO_DROPOUT = {"gpt": dict(dropout=0.0, attn_dropout=0.0),
              "bert": dict(dropout=0.0, attn_dropout=0.0), "vit": {},
              "llama": {}}


def _inputs(family, b=2):
    r = np.random.default_rng(3)
    if family == "vit":
        return (r.standard_normal((b, 3, 16, 16)).astype(np.float32),)
    ids = r.integers(0, 64, (b, 12))
    if family == "bert":
        mask = np.ones((b, 12), np.int64)
        mask[1, 8:] = 0                 # the second sequence is padded
        return ids, None, mask
    return (ids,)


def _torch_inputs(family):
    return [None if a is None else torch.from_numpy(a)
            for a in _inputs(family)]


def _pair(family, **kw):
    """The same weights without and with remat."""
    torch.manual_seed(0)
    cls, _, cfg = CFGS[family]
    plain = cls(**cfg, **kw, device="cpu")
    remat = cls(**cfg, **kw, remat=True, device="cpu")
    remat.load_state_dict(plain.state_dict())
    return plain, remat


def _loss(out):
    return torch.sin(out.float()).sum()


@pytest.mark.parametrize("family", list(CFGS))
def test_remat_builds_and_matches_no_remat_bit_for_bit(family):
    plain, remat = _pair(family, **DROPOUT[family])
    assert remat.remat and not plain.remat
    x = _torch_inputs(family)
    got = []
    with value_products():
        for m in (plain, remat):
            kw = {}
            if family != "llama":
                kw["generator"] = torch.Generator().manual_seed(7)
            loss = _loss(m(*x, **kw))
            loss.backward()
            got.append((loss, [p.grad for p in m.parameters()],
                        kw.get("generator")))
    (l0, g0, gen0), (l1, g1, gen1) = got
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    if gen0 is not None:
        assert torch.equal(gen0.get_state(), gen1.get_state())
        # and the dropout did draw: another seed moves the loss
        other = _loss(plain(*x, generator=torch.Generator().manual_seed(8)))
        assert not torch.equal(other, l0)


@pytest.mark.parametrize("family", ["gpt", "vit"])
def test_remat_train_steps_equal_no_remat_bit_for_bit(family):
    """Through the fused step in bf16: the forward runs on the step's bf16
    leaves under ``functional_call``, the backward (and so the
    recomputation) after it returns; two steps' losses and fp32 masters
    equal the step's without remat."""
    plain, remat = _pair(family, **DROPOUT[family])
    x = _torch_inputs(family)[0]
    res = []
    with value_products():
        for m in (plain, remat):
            step = make_train_step(
                m, FusedAdam(list(m.parameters()), lr=1e-2),
                lambda out: out.float().square().mean(),
                half_dtype=torch.bfloat16, loss_scale=1.0)
            losses = [step(x) for _ in range(2)]
            res.append((losses, step.state.master_params))
    (l0, p0), (l1, p1) = res
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert not torch.equal(l0[0], l0[1])


@pytest.mark.parametrize("family", ["gpt", "llama", "bert"])
def test_remat_gradients_match_jax_remat_at_dropout_0(family):
    cls, jcls, cfg = CFGS[family]
    jnn.manual_seed(2)
    jm = jcls(**cfg, **NO_DROPOUT[family], remat=True)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = models.from_jax_state_dict(
        cls(**cfg, **NO_DROPOUT[family], remat=True, device="cpu"), sd)
    x = _inputs(family)
    params = list(jm.parameters())
    names = [n for n, _ in jm.named_parameters()]

    def jloss(vals):
        ctx = Ctx(env={id(p): v for p, v in zip(params, vals)},
                  stats_out={}, training=True)
        out = jm.forward(ctx, *(None if a is None else jnp.asarray(a)
                                for a in x))
        return jnp.sum(jnp.sin(out))
    want = jax.jit(jax.grad(jloss))([p.data for p in params])
    _loss(tm(*_torch_inputs(family))).backward()
    tp = dict(tm.named_parameters())
    assert set(tp) == set(names)
    for n, w in zip(names, want):
        w = np.asarray(w)
        err = np.abs(tp[n].grad.numpy() - w).max() / max(1.0,
                                                          np.abs(w).max())
        assert err <= 1e-5, (n, err)


class _Block(torch.nn.Module):
    """A linear layer and a dropout mask drawn from the caller's generator
    (keeping every entry at ``keep`` 1)."""

    def __init__(self, keep):
        super().__init__()
        self.lin = torch.nn.Linear(6, 6)
        self.keep = keep

    def forward(self, x, generator=None):
        keep = torch.rand(x.shape, generator=generator) < self.keep
        return torch.where(keep, torch.tanh(self.lin(x)), 0.0)


class _Wrap(torch.nn.Module):
    """Calls ``fn(block, x, generator)``: the block directly, or through
    a checkpoint."""

    def __init__(self, block, fn):
        super().__init__()
        self.b, self.fn = block, fn

    def forward(self, x, generator=None):
        return self.fn(self.b, x, generator)


def _direct(b, x, g):
    return b(x, generator=g)


def _remat(b, x, g):
    return checkpoint_forward(b, x, generator=g)


def _grads(fn, block, leaves, x, generator):
    """The gradients of ``fn``'s output under ``functional_call`` with the
    ``leaves`` substituted for the block's parameters, taken after the
    substitution has ended, as the fused step takes them."""
    names = ["b." + n for n, _ in block.named_parameters()]
    out = functional_call(_Wrap(block, fn), dict(zip(names, leaves)), (x,),
                          dict(generator=generator))
    return torch.autograd.grad(out.square().sum(), leaves)


def test_recomputation_reads_the_substituted_parameters():
    """The step's leaves differ from the module's stored parameters; the
    recomputation runs after ``functional_call`` has put the stored ones
    back.  The gradients must be those of the leaves, as without remat;
    a checkpoint of the module's own call reads the stored parameters."""
    torch.manual_seed(1)
    block = _Block(keep=1.0)
    x = torch.randn(4, 6)
    leaves = [(p.detach() * 3 + 0.5).requires_grad_(True)
              for p in block.parameters()]
    fixed = torch.Generator()

    def run(fn):
        fixed.manual_seed(3)
        return _grads(fn, block, leaves, x, fixed)
    want = run(_direct)
    got = run(_remat)
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
               for a, b in zip(got, want))
    naive = run(lambda b, x, g: checkpoint(b, x, generator=g,
                                           use_reentrant=False,
                                           preserve_rng_state=False))
    assert not all(torch.allclose(a, b) for a, b in zip(naive, want))


def test_recomputation_replays_the_generator():
    """The dropout mask of the recomputation is the forward's: the
    generator is rewound to its state at the call and put back after."""
    torch.manual_seed(2)
    block = _Block(keep=0.7)
    x = torch.randn(4, 6)
    leaves = [p.detach().clone().requires_grad_(True)
              for p in block.parameters()]
    gens = [torch.Generator().manual_seed(5) for _ in range(3)]
    want = _grads(_direct, block, leaves, x, gens[0])
    got = _grads(_remat, block, leaves, x, gens[1])
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
               for a, b in zip(got, want))
    assert torch.equal(gens[1].get_state(), gens[0].get_state())

    def no_replay(b, x, g):
        names = [n for n, _ in b.named_parameters()]
        return checkpoint(lambda x, *v: functional_call(
            b, dict(zip(names, v)), (x,), dict(generator=g)),
            x, *b.parameters(), use_reentrant=False)
    naive = _grads(no_replay, block, leaves, x, gens[2])
    assert not all(torch.allclose(a, b) for a, b in zip(naive, want))


def test_a_batch_norm_in_training_is_refused():
    net = torch.nn.Sequential(torch.nn.Linear(4, 4),
                              torch.nn.BatchNorm1d(4))
    x = torch.randn(8, 4, requires_grad=True)
    with pytest.raises(ValueError, match="running statistics"):
        checkpoint_forward(net, x)
    net.eval()                          # reads them only: allowed
    checkpoint_forward(net, x).sum().backward()
    assert x.grad is not None
