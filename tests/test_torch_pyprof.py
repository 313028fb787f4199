"""The port's pyprof (``apex_tpu_torch/pyprof``) against the JAX package's
``tests/test_pyprof.py``, on the CPU: ``enrich`` and the FLOP and byte
models equal to the JAX package's on the same events and rows; the events
recorded for the functional ops both packages share; the fused ops, tensor
methods, module scopes and optimizer steps recorded; the CLI pipeline;
``profile_step``'s join over ``torch.profiler`` (on the CPU over the aten
ops' time), matched plus unattributed equal to the total; ``nvtx.annotate``
through ``observe.span``; the capability probe."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import pyprof as jax_pyprof
from apex_tpu.nn import functional as jax_F
from apex_tpu.pyprof.parse.parse import enrich as jax_enrich
from apex_tpu.pyprof.prof.models import model_row as jax_model_row

from apex_tpu_torch import pyprof
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.observe import get_registry
from apex_tpu_torch.pyprof.parse.parse import enrich
from apex_tpu_torch.pyprof.parse.trace import correlate, load_trace
from apex_tpu_torch.pyprof.prof.models import model_row
from apex_tpu_torch.pyprof.prof.prof import analyze_rows

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disable_after():
    yield
    pyprof.annotate.set_enabled(False)
    jax_pyprof.annotate.set_enabled(False)


def _ev(seq, op, shapes, dtype="float32", params=None, **kw):
    return dict(seq=seq, op=op, dir="fwd", scope="", shapes=shapes,
                dtypes=[dtype] * len(shapes), tensors={},
                params=params or {}, callsite=None, **kw)


EVENTS = [
    _ev(0, "linear", [[32, 64], [16, 64], [16]], "bfloat16"),
    _ev(1, "conv2d", [[2, 3, 8, 8], [4, 3, 3, 3]],
        params={"stride": [2, 2], "padding": [1, 1]}),
    _ev(2, "conv_transpose2d", [[2, 4, 4, 4], [4, 3, 3, 3]],
        params={"stride": 2}),
    _ev(3, "matmul", [[4, 128, 256], [256, 128]], "bfloat16"),
    _ev(4, "flash_attention", [[2, 12, 1024, 64], [2, 12, 1024, 64],
                               [2, 12, 1024, 64]], "bfloat16",
        params={"causal": True}),
    _ev(5, "fused_layer_norm_affine", [[16384, 768], [768], [768]],
        "bfloat16"),
    _ev(6, "fused_rms_norm_affine", [[16384, 768], [768]], "float16"),
    _ev(7, "softmax", [[64, 50257]]),
    _ev(8, "chunked_lm_head_loss", [[16, 1023, 768], [50257, 768],
                                    [16, 1023]], "bfloat16"),
    _ev(9, "softmax_cross_entropy_loss", [[1280, 30522], [1280]]),
    _ev(10, "max_pool2d", [[2, 3, 8, 8]], params={"kernel_size": 3}),
    _ev(11, "embedding", [[16, 1024], [50257, 768]]),
    _ev(12, "add", [[16, 1], [1, 768]]),
    _ev(13, "getitem", [[64, 768]], out_shape=[768]),
    _ev(14, "astype", [[64, 768]], params={"dtype": "bfloat16"}),
    _ev(15, "reshape", [[64, 768]]),
    _ev(16, "sum", [[64, 768]]),
    _ev(17, "gelu", [[64, 3072]], "bfloat16"),
    _ev(18, "flatten", [[4, 3, 2]]),
    _ev(19, "optimizer.FusedAdam.step", [[124439808]]),
    _ev(20, "some_unmodelled_op", [[7, 7]]),
]


@pytest.mark.parametrize("with_backward", [True, False])
def test_enrich_equals_the_jax_packages(with_backward):
    assert enrich(EVENTS, with_backward) == \
        jax_enrich(EVENTS, with_backward)


@pytest.mark.parametrize("row", enrich(EVENTS),
                         ids=lambda r: f"{r['op']}-{r['dir']}")
def test_flop_and_byte_models_equal_the_jax_packages(row):
    """Every family's FLOPs and bytes, forward and backward, are the JAX
    package's counts; the ``mxu`` column keeps the JAX dtype gate and
    models Hopper's tiles instead of the MXU's."""
    f, b, m = model_row(row)
    jf, jb, jm = jax_model_row(row)
    assert (f, b) == (jf, jb)
    assert (m is None) == (jm is None)
    if m is not None:
        assert m["eligible"] == jm["eligible"]
        assert 0.0 < m["util"] <= 1.0


def test_tensor_core_tiles_and_h100_roofline():
    """A 128-multiple product fills the 128 x 128 x 64 tiles; a 1 x K x N
    row pads to 128 rows.  The roofline is against the H100's published
    peaks: fp32 at its own rate, not half of bf16."""
    mm = {"op": "matmul", "dir": "fwd", "shapes": [[128, 256], [256, 128]],
          "dtypes": ["bfloat16"], "params": {}}
    assert model_row(mm)[2] == {"eligible": True, "util": 1.0}
    vec = dict(mm, shapes=[[1, 256], [256, 128]])
    assert model_row(vec)[2]["util"] == round(1 / 128, 3)
    rows = analyze_rows(enrich([
        _ev(0, "linear", [[4096, 4096], [4096, 4096]], "bfloat16"),
        _ev(1, "linear", [[4096, 4096], [4096, 4096]], "float32"),
        _ev(2, "relu", [[4096, 4096]], "bfloat16")], with_backward=False))
    flops = 2 * 4096 ** 3
    assert rows[0]["bound"] == "compute" and rows[2]["bound"] == "memory"
    assert rows[0]["est_us"] == round(flops / 989e12 * 1e6, 3)
    assert rows[1]["est_us"] == round(flops / 67e12 * 1e6, 3)
    assert rows[2]["est_us"] == round(2 * 4096 ** 2 * 2 / 3350e9 * 1e6, 3)


def test_shared_functional_ops_record_the_jax_events():
    """The ops both packages share (``F.linear`` / ``F.relu`` through the
    port's torch calls, ``F.conv2d`` / ``F.max_pool2d`` / ``F.cross_entropy``
    of both ``nn.functional``s) record the same op, shapes, dtypes and
    params for the same inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w = rng.standard_normal((3, 8)).astype(np.float32)
    img = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    k = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    lab = rng.integers(0, 3, (4,)).astype(np.int32)

    def run(Fm, T, relu, linear):
        linear(T(x), T(w))
        relu(T(x))
        Fm.conv2d(T(img), T(k), None, (2, 2), (1, 1))
        Fm.max_pool2d(T(img), 3)
        Fm.cross_entropy(T(x[:, :3]), T(lab))

    with jax_pyprof.capture() as jev:
        run(jax_F, jnp.asarray, jax_F.relu, jax_F.linear)
    with pyprof.capture() as tev:
        run(F, torch.from_numpy, torch.nn.functional.relu,
            torch.nn.functional.linear)
    keys = ("op", "shapes", "dtypes", "params")
    jev = [{k: e[k] for k in keys} for e in jev]
    tev = [{k: e[k] for k in keys} for e in tev]
    assert [e["op"] for e in tev] == ["linear", "relu", "conv2d",
                                      "max_pool2d", "cross_entropy"]
    assert tev == jev
    rows = pyprof.analyze(pyprof.annotate.events(), with_backward=False)
    assert rows[2]["flops"] == 2 * 1 * 4 * 4 * 4 * 3 * 3 * 3


def test_tensor_methods_scopes_and_optimizer_steps_recorded():
    from apex_tpu_torch.optimizers import FusedSGD
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                                torch.nn.ReLU())
    x = torch.randn(2, 3, 8, 8)
    opt = FusedSGD(list(model.parameters()), lr=0.1)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    with pyprof.capture() as ev:
        y = model(x)
        z = (y + 1.0) @ torch.ones(8, 2)
        z[0].sum()
        opt.step()
    ops = [e["op"] for e in ev]
    assert ops == ["conv2d", "relu", "add", "matmul", "getitem", "sum",
                   "optimizer.FusedSGD.step"]
    assert ev[0]["scope"] == "Sequential/Conv2d"
    assert ev[4]["out_shape"] == [4, 8, 2]
    numel = sum(p.numel() for p in model.parameters())
    assert ev[-1]["shapes"] == [[numel]]
    # recording off: nothing more is recorded, and no mode stays entered
    model(x)
    assert len(pyprof.annotate.events()) == len(ops)


def test_fused_ops_recorded_and_grads_flow():
    from apex_tpu_torch.contrib.multihead_attn.attn_funcs import \
        flash_attention
    from apex_tpu_torch.contrib.xentropy import chunked_lm_head_loss
    from apex_tpu_torch.normalization import FusedLayerNorm
    torch.manual_seed(0)
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    ln = FusedLayerNorm(16, device="cpu")
    emb = torch.randn(11, 16, requires_grad=True)
    with pyprof.capture() as ev:
        o = flash_attention(q, q, q, causal=True)
        h = ln(o)
        loss = chunked_lm_head_loss(h, emb, torch.randint(0, 11, (1, 2, 8)))
    assert [e["op"] for e in ev] == ["flash_attention",
                                     "fused_layer_norm_affine",
                                     "chunked_lm_head_loss"]
    assert ev[0]["params"]["causal"] is True
    assert ev[1]["scope"] == "FusedLayerNorm"
    loss.sum().backward()
    assert q.grad is not None and emb.grad is not None
    rows = pyprof.analyze(ev)
    assert [r["op"] for r in rows if r["dir"] == "bwd"] == [
        "chunked_lm_head_loss", "fused_layer_norm_affine", "flash_attention"]


def _tiny_step():
    from apex_tpu_torch.contrib.xentropy import make_chunked_lm_loss
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(0)
    m = gpt.GptModel(vocab_size=64, hidden=32, layers=2, heads=2,
                     max_positions=16, dropout=0.0, attn_dropout=0.0,
                     output_hidden=True, device="cpu")
    step = make_train_step(m, FusedAdam(list(m.parameters()), lr=1e-3),
                           make_chunked_lm_loss(), half_dtype=torch.bfloat16,
                           loss_scale=1.0)
    ids = torch.randint(0, 64, (2, 16))
    return step, ids


def test_profile_step_join_on_the_cpu(tmp_path):
    """The eager GPT step profiled: on the CPU the join runs over the
    outermost aten ops; the flash, LayerNorm, loss and FusedAdam rows are
    measured forward and (but the optimizer) backward; matched plus
    unattributed is the total, exactly; the trace left in ``trace_dir``
    joins again through the parse CLI's path to the same split."""
    step, ids = _tiny_step()
    rows, rep = pyprof.profile_step(
        lambda: step._raw_step_fn(step.state, 0, ids, ids),
        trace_dir=str(tmp_path), executions=2)
    assert rep["basis"] == "cpu_ops" and rep["executions"] == 2
    assert rep["matched_ns"] + rep["unattributed_ns"] == rep["total_ns"]
    assert rep["matched_ns"] > 0.9 * rep["total_ns"]
    assert rep["dropped_launches"] == 0 and rep["kernel_names"] == {}
    for op in ("flash_attention", "fused_layer_norm_affine",
               "chunked_lm_head_loss"):
        for d in ("fwd", "bwd"):
            hit = [r for r in rows if r["op"] == op and r["dir"] == d]
            assert hit and all(r["meas_us"] and r["meas_us"] > 0
                               for r in hit), (op, d)
    (adam,) = [r for r in rows if r["op"] == "optimizer.FusedAdam.step"]
    assert adam["meas_us"] > 0
    assert adam["shapes"] == [[sum(p.numel() for p in
                                   step.state.master_params)]]
    joined = correlate(load_trace(str(tmp_path)))
    assert joined["matched_ns"] == rep["matched_ns"]
    assert joined["unattributed_ns"] == rep["unattributed_ns"]


def test_cli_pipeline(tmp_path, capsys):
    """save -> ``python -m apex_tpu_torch.pyprof.parse`` (with ``--trace``
    over a CPU profile) -> the prof stage's CLI (``--csv``), its ``main``
    called in process (``python -m`` runs the same function)."""
    from apex_tpu_torch.pyprof.prof import prof as prof_stage
    from torch.profiler import ProfilerActivity, profile
    x, w = torch.randn(4, 8), torch.randn(3, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pyprof.capture() as ev:
            torch.nn.functional.relu(torch.nn.functional.linear(x, w))
    raw = tmp_path / "run.jsonl"
    pyprof.save(str(raw), ev)
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    parsed = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.pyprof.parse", str(raw),
         "--trace", str(trace)],
        capture_output=True, text=True, check=True, cwd=REPO)
    rows = [json.loads(line) for line in parsed.stdout.splitlines()]
    assert [(r["op"], r["dir"]) for r in rows] == [
        ("linear", "fwd"), ("relu", "fwd"), ("relu", "bwd"),
        ("linear", "bwd")]
    assert rows[0]["dur_us"] > 0 and rows[3]["dur_us"] is None
    assert "# matched 2 ops" in parsed.stderr
    net = tmp_path / "net.dict"
    net.write_text(parsed.stdout)
    prof_stage.main([str(net), "--csv"])
    out = capsys.readouterr().out
    assert "linear" in out and "est_us" in out


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::ln_fwd_vec_kernel<__nv_bfloat16, 8, 4>"
     "(__nv_bfloat16 const*, float*, int)", "void ln_fwd_vec_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul>)",
     "void at::native::vectorized_elementwise_kernel"),
    ("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_64x3_tn",
     "ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_64x3_tn"),
], ids=["anonymous-namespace", "template", "plain"])
def test_kernel_names_are_shortened_for_the_report(name, short):
    """A kernel's name in the report loses its template arguments and
    parameters, and the hand kernels' ``(anonymous namespace)`` qualifier
    (whose parentheses once cut the name down to ``void``)."""
    from apex_tpu_torch.pyprof.parse.trace import _short
    assert _short(name) == short


def test_nvtx_annotate_goes_through_observe_span():
    reg = get_registry()
    reg.clear_events()
    with pyprof.nvtx.annotate("pyprof.region", phase="fwd"):
        pass
    (ev,) = [e for e in reg.events("span") if e["span"] == "pyprof.region"]
    assert ev["phase"] == "fwd"


def test_kernel_event_probe_is_cached_and_false_here():
    r1 = pyprof.thunk_events_available()
    r2 = pyprof.thunk_events_available()
    assert r1 is r2 is False
