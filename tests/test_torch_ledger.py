"""The port's calibration ledger and tier decision
(``apex_tpu_torch/kernels/{ledger,dispatch,spec_verify}.py``) against the
JAX package's, on the CPU: ledger files cross between the packages both
ways, corrupt files and entries are skipped alike, the pure entry ->
decision rule on both kinds of kernel (a hand kernel stays on the card
whatever its measured win; ``spec_verify`` follows this card's entry, its
prior "no"), ``decide`` on the CPU, the once-per-key ``kernels.dispatch``
event, ``measured_threshold``, event ingestion, and
``ServeEngine(spec_policy="auto")`` giving the JAX engine's tokens."""
import importlib
import json

import pytest

from apex_tpu.kernels import dispatch as jax_dispatch
from apex_tpu.kernels import ledger as jax_ledger

from apex_tpu_torch.kernels import dispatch, ledger
from apex_tpu_torch.kernels.spec_verify import (_spec_verify_probe,
                                                spec_verify_fp,
                                                spec_verify_pays)
from apex_tpu_torch.observe import get_registry

import torch_serve_refs as refs

CARD = "NVIDIA H100 80GB HBM3"
FP = dispatch.rows_fp(16384, 768, "bfloat16")


@pytest.fixture(autouse=True)
def _tmp_ledgers(tmp_path):
    """Both process ledgers on a file of the test's own, no cached
    decisions before or after."""
    path = str(tmp_path / "ledger.json")
    ledger.set_path(path)
    jax_ledger.set_path(path)
    dispatch.reset_decisions()
    jax_dispatch.reset_decisions()
    yield path
    ledger.set_path(None)
    jax_ledger.set_path(None)
    dispatch.reset_decisions()
    jax_dispatch.reset_decisions()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ledger_files_cross_between_the_packages(tmp_path, writer):
    """One package's kernel and plan records load in the other's
    ``Ledger``: the same file format, version 1, the same records."""
    path = str(tmp_path / f"{writer}.json")
    w, r = (jax_ledger, ledger) if writer == "jax" else (ledger, jax_ledger)
    wl = w.Ledger(path)
    wl.record_kernel(CARD, "layer_norm", FP, pallas_us=40.0, xla_us=50.0)
    wl.record_kernel(CARD, "layer_norm", FP, pallas_us=45.0, xla_us=40.5,
                     threshold=3)
    wl.record_kernel("TPU v5 lite", "flash_attention", "b=1", pallas_us=2.0,
                     xla_us=1.0)
    wl.record_plan(CARD, "gpt2", (1, 2, True, "remat=none"),
                   measured_ms=12.5, predicted_ms=11.0)
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and set(doc) == {"version", "kernels",
                                                "plans"}
    rl = r.Ledger(path)
    got = rl.lookup_kernel(CARD, "layer_norm", FP)
    want = wl.lookup_kernel(CARD, "layer_norm", FP)
    assert got == want
    assert got["runs"] == 2 and got["win"] == pytest.approx(0.9)
    assert got["threshold"] == 3
    # a TPU's entry never prices the card
    assert rl.lookup_kernel(CARD, "flash_attention", "b=1") is None
    assert rl.kernel_entries("TPU v5 lite", "flash_attention") == \
        wl.kernel_entries("TPU v5 lite", "flash_attention")
    assert rl.plan_measurements(CARD, "gpt2") == \
        wl.plan_measurements(CARD, "gpt2")
    assert list(rl.plan_measurements(CARD, "gpt2")) == ["1/2/1/remat=none"]


@pytest.mark.parametrize("content", [
    "{not json", "[1, 2]", json.dumps({"version": 1, "kernels": "x"}),
    json.dumps({"version": 1, "kernels": {CARD: {"layer_norm": {
        FP: "garbage", "rows=1,n=2,dtype=float32": {"pallas_us": 1.0,
                                                    "xla_us": 2.0}},
        "rms_norm": 7}, "cpu": []}, "plans": {CARD: {"m": {"k": 3}}}}),
], ids=["truncated", "list", "bad_section", "bad_entries"])
def test_corrupt_files_and_entries_are_skipped(tmp_path, content):
    """A corrupt file loads empty and a corrupt entry is dropped, in both
    packages alike; neither raises, and the next record saves a clean
    file."""
    path = tmp_path / "bad.json"
    path.write_text(content)
    port, jax = ledger.Ledger(str(path)), jax_ledger.Ledger(str(path))
    assert port.lookup_kernel(CARD, "layer_norm", FP) is None
    for kernel in ("layer_norm", "rms_norm"):
        assert port.kernel_entries(CARD, kernel) == \
            jax.kernel_entries(CARD, kernel)
    assert port.plan_measurements(CARD, "m") == {}
    port.record_kernel(CARD, "xentropy", "rows=1,n=2,dtype=bfloat16",
                       pallas_us=1.0, xla_us=3.0)
    assert ledger.Ledger(str(path)).lookup_kernel(
        CARD, "xentropy", "rows=1,n=2,dtype=bfloat16")["win"] == 3.0


def test_decision_rule_on_both_kinds_of_kernel():
    """A hand kernel's card tensor runs the kernel whatever the ledger
    says, with the measured win beside it; a CPU tensor takes the plain
    version; ``spec_verify`` follows this card's entry, else its probe,
    whose prior is "no"."""
    hand = dispatch.KERNELS["layer_norm"]
    spec = dispatch.KERNELS["spec_verify"]
    slow = {"win": 0.8, "threshold": None}
    fast = {"win": 1.25, "threshold": 2}
    d = dispatch.decision_for("layer_norm", FP, CARD, on_card=True,
                              entry=slow, spec=hand)
    assert (d.tier, d.source, d.win) == ("pallas", "mode", 0.8)
    d = dispatch.decision_for("layer_norm", FP, CARD, on_card=True,
                              entry=None, spec=hand)
    assert (d.tier, d.source, d.win) == ("pallas", "mode", None)
    d = dispatch.decision_for("layer_norm", FP, "cpu", on_card=False,
                              entry=fast, spec=hand)
    assert (d.tier, d.source, d.win) == ("xla", "mode", None)
    fp = spec_verify_fp(b=4, k=3, s_t=64, s_d=64, dtype="float32")
    d = dispatch.decision_for("spec_verify", fp, CARD, on_card=True,
                              entry=fast, spec=spec)
    assert (d.tier, d.source, d.win, d.threshold) == \
        ("pallas", "ledger", 1.25, 2)
    d = dispatch.decision_for("spec_verify", fp, CARD, on_card=True,
                              entry=slow, spec=spec)
    assert (d.tier, d.source) == ("xla", "ledger")
    d = dispatch.decision_for("spec_verify", fp, CARD, on_card=True,
                              entry=None, spec=spec)
    assert (d.tier, d.source, d.threshold) == ("xla", "probe", None)
    d = dispatch.decision_for("spec_verify", fp, "cpu", on_card=False,
                              entry=fast, spec=spec)
    assert (d.tier, d.source) == ("xla", "mode")


def test_decide_on_the_cpu_and_the_dispatch_event_once_per_key():
    reg = get_registry()
    reg.clear_events()
    c0 = reg.counter("kernels.dispatch.layer_norm.xla").value
    for _ in range(3):
        d = dispatch.decide("layer_norm", FP, "cpu")
    assert (d.tier, d.source, d.chip) == ("xla", "mode", "cpu")
    dispatch.decide("layer_norm", dispatch.rows_fp(8, 768, "bfloat16"),
                    "cpu")
    evs = reg.events("kernels.dispatch")
    assert [e["shape_fp"] for e in evs] == [
        FP, dispatch.rows_fp(8, 768, "bfloat16")]
    assert evs[0]["kernel"] == "layer_norm" and evs[0]["ledger_entry"] \
        is None
    assert reg.counter("kernels.dispatch.layer_norm.xla").value == c0 + 2
    assert len(dispatch.decisions()) == 2
    dispatch.reset_decisions()
    assert dispatch.decisions() == []
    assert not spec_verify_pays(
        spec_verify_fp(b=4, k=3, s_t=64, s_d=64, dtype="float32"), "cpu")


def test_measured_threshold_and_the_spec_probe(_tmp_ledgers):
    """The smallest winning value of a fingerprint dimension on this chip
    (the CPU's key here, as in the JAX package), else the default; the
    spec probe takes it as its threshold on ``k``."""
    chip = ledger.chip_name()
    assert chip == "cpu" == jax_ledger.chip_name()
    assert dispatch.measured_threshold("spec_verify", "k", None) is None
    assert _spec_verify_probe({"k": 8}) == (None, False)
    led = ledger.get_ledger()
    for k, (p, x) in {2: (10.0, 8.0), 3: (10.0, 12.0),
                      4: (10.0, 15.0)}.items():
        led.record_kernel(chip, "spec_verify",
                          spec_verify_fp(b=4, k=k, s_t=64, s_d=64,
                                         dtype="float32"),
                          pallas_us=p, xla_us=x)
    led.record_kernel(CARD, "spec_verify", "b=1,k=1", pallas_us=1.0,
                      xla_us=9.0)
    assert dispatch.measured_threshold("spec_verify", "k", None) == 3
    assert jax_dispatch.measured_threshold("spec_verify", "k", 2) == 3
    assert _spec_verify_probe({"k": 3}) == (3.0, True)
    assert _spec_verify_probe({"k": 2}) == (3.0, False)
    assert dispatch.measured_threshold("layer_norm", "rows", 7) == 7


def test_ingest_events_as_the_jax_ledger(tmp_path):
    events = [
        {"event": "bench.kernel_probe", "chip": CARD, "kernel": "xentropy",
         "shape_fp": "rows=1023,n=50257,dtype=bfloat16", "pallas_us": 55.0,
         "xla_us": 110.0},
        {"event": "plan.auto_tune", "chip": CARD, "model_fp": "m",
         "plan_key": [1, 2], "measured_ms": 3.0},
        {"event": "bench.kernel_probe", "kernel": "x"},      # incomplete
        "not a record",
    ]
    port = ledger.Ledger(str(tmp_path / "p.json"))
    jax = jax_ledger.Ledger(str(tmp_path / "j.json"))
    assert port.ingest_events(events) == jax.ingest_events(events) == 2
    assert port.lookup_kernel(CARD, "xentropy",
                              "rows=1023,n=50257,dtype=bfloat16")["win"] \
        == 2.0
    assert port.plan_measurements(CARD, "m") == \
        jax.plan_measurements(CARD, "m")


def test_every_kernel_registers_a_resolvable_fallback():
    """B1-B12 and spec_verify are registered, each with a plain fallback
    whose dotted path names a callable of the port."""
    names = set(dispatch.catalog())
    assert {"flash_attention", "flash_attention_bwd", "layer_norm",
            "layer_norm_bwd", "rms_norm", "rms_norm_bwd", "xentropy",
            "xentropy_bwd", "vocab_chain_loss", "vocab_chain_loss_bwd",
            "multi_tensor_sgd", "multi_tensor_adam",
            "spec_verify"} <= names
    for spec in dispatch.catalog().values():
        mod, _, attr = spec.xla_fallback.rpartition(".")
        assert callable(getattr(importlib.import_module(mod), attr)), spec
        assert spec.ledger_decides == (spec.name == "spec_verify")
    # the fingerprints are the JAX package's strings
    assert dispatch.attention_fp(1, 192, 1024, 1024, 64, "bfloat16", True) \
        == jax_dispatch.attention_fp(1, 192, 1024, 1024, 64, "bfloat16",
                                     True)
    assert dispatch.multi_tensor_fp("adam", 10, 2, "bfloat16") == \
        jax_dispatch.multi_tensor_fp("adam", 10, 2, "bfloat16")
    assert dispatch.parse_fp(FP) == jax_dispatch.parse_fp(FP)


def test_spec_policy_auto_on_the_cpu_gives_the_jax_tokens():
    """``ServeEngine(spec_policy="auto")`` on the CPU decides "xla" from
    the device (source "mode"), runs plain decode ticks and gives the JAX
    engine's tokens."""
    from apex_tpu_torch.inference import make_self_draft
    from apex_tpu_torch.serve import Request, ServeEngine
    _, model = refs.models()
    reg = get_registry()
    reg.clear_events()
    eng = ServeEngine(model, num_blocks=128, block_size=8, max_batch=4,
                      prefill_chunk=4, draft=make_self_draft(model),
                      spec_k=3, spec_policy="auto")
    assert eng.run(refs.prompt_reqs(Request)) == refs.jax_refs()["prompts"]
    assert eng.metrics()["spec"]["ticks"] == 0
    evs = [e for e in reg.events("kernels.dispatch")
           if e["kernel"] == "spec_verify"]
    assert evs and all((e["tier"], e["source"], e["chip"]) ==
                       ("xla", "mode", "cpu") for e in evs)
    eng.block_pool.check_no_leaks()
