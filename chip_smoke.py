#!/usr/bin/env python3
"""Drive the PyTorch port (``apex_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a host with one H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. the card's name and power limit, the torch and CUDA versions, and the
   build of every kernel under ``apex_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together; cached builds are reused);
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes and a few others (dtypes, masks, ragged sizes), with the
   tolerance printed beside each error; then the kernel's, the plain
   version's and one library call's time at the main path's shapes (CUDA
   events around 10 calls queued behind a device-side sleep, median of 25
   such runs after warm-up);
3. the main path: ``generate`` on GPT-2 small (hidden 768, 12 layers, 12
   heads, vocab 50257, max_positions 640, fp32, random weights from a seed)
   with a batch of 8 512-token prompts and 128 greedy new tokens, reading
   the kernels' launch counts around that one call; then the prefill time
   and decode rate of the same work, timed phase by phase;
4. where the time goes: the prefill and a few decode steps under
   ``torch.profiler``, with the device's idle share and its top kernels;
5. the card against the CPU: the same weights on a CPU model (the plain
   versions), prefill logits and teacher-forced decode logits compared.

It prints one JSON line of per-kernel numbers, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
card, or without the rest of the repository beside it, it exits non-zero
before printing a result.  TF32 is off for every comparison.
"""
import json
import statistics
import subprocess
import sys
import time

SEED = 1234
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BATCH, PROMPT, NEW, MAX_POS = 8, 512, 128, 640


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _sleep_cycles_per_ms(torch):
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def median_ms(fn, reps=25, inner=10, warmup=3):
    """``(device ms, host ms)`` of one call of ``fn``.  The device time is
    ``inner`` calls timed between two CUDA events, median over ``reps``;
    each timed run is queued behind a device-side sleep longer than the
    host takes to enqueue it, so the events measure the card's work and not
    the Python wrapper's.  The host time is what enqueueing one call costs
    the Python thread."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_ms(torch) * (2 * host_ms + 0.5))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), host_ms / inner


def scaled_err(got, ref):
    """Max abs error over max(1, max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err / max(1.0, ref.float().abs().max().item()), err


def check(what, err, tol):
    print(f"  {what}: err {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{what}: error {err} above tolerance {tol}")


def ln_phase(torch, layer_norm):
    """LayerNorm kernel against its plain version; timings at the main
    path's shapes.  Returns the kernel line's numbers."""
    from torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [((4096, 768), f32, True), ((4096, 768), f32, False),
             ((4096, 768), bf16, True), ((4096, 768), bf16, False),
             ((8, 768), f32, True), ((8, 768), f32, False),
             ((8, 768), bf16, True), ((8, 768), bf16, False),
             ((37, 1000), f32, True), ((5, 8192), f16, True),
             ((3, 12000), f32, False)]
    print("LayerNorm forward vs plain (err: max abs / max(1, max |ref|)):")
    main_err = None
    for shape, dtype, affine in cases:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 1).to(dtype)
        n = shape[1]
        w = b = None
        if affine:
            w = torch.randn(n, generator=g, device="cuda")
            b = torch.randn(n, generator=g, device="cuda")
        y, mean, rstd = layer_norm.ln_forward(x, w, b, 1e-5)
        torch.cuda.synchronize()
        ry, rmean, rrstd = layer_norm.ln_forward_reference(x.float(), w, b,
                                                           1e-5)
        tol = 1e-5 if dtype == f32 else 2e-2
        tag = f"{shape} {str(dtype)[6:]} affine={affine}"
        ey, ey_abs = scaled_err(y, ry)
        check(f"{tag} y", ey, tol)
        check(f"{tag} mean", scaled_err(mean, rmean)[0], 1e-5)
        check(f"{tag} rstd", scaled_err(rstd, rrstd)[0], 1e-5)
        if shape == (4096, 768) and dtype == f32 and affine:
            main_err = ey_abs

    numbers = {}
    for shape in ((4096, 768), (8, 768)):
        rows, n = shape
        x = torch.randn(shape, generator=g, device="cuda")
        w = torch.randn(n, generator=g, device="cuda")
        b = torch.randn(n, generator=g, device="cuda")
        ms, host = median_ms(lambda: layer_norm.ln_forward(x, w, b, 1e-5))
        plain = median_ms(
            lambda: layer_norm.ln_forward_reference(x, w, b, 1e-5))[0]
        lib = median_ms(lambda: F.layer_norm(x, (n,), w, b, 1e-5))[0]
        nbytes = 2 * x.numel() * 4 + 2 * n * 4 + 2 * rows * 4
        ops = 8 * x.numel()
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_FLOP_PER_S \
            else "operations"
        print(f"  time {shape} fp32 affine: kernel {ms:.4f} ms (host "
              f"{host:.4f} ms a call), plain {plain:.4f} ms, F.layer_norm "
              f"{lib:.4f} ms, bound {bound:.6f} ms ({by})")
        numbers[shape] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bound, bound_by=by)
    return dict(max_abs_err=main_err, **numbers[(4096, 768)],
                decode_shape_ms=numbers[(8, 768)]["ms"])


def _unmasked_pairs(sq, sk, causal, window):
    if not causal:
        return sq * sk
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1)
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, hi - lo + 1)
    return total


def flash_phase(torch, attention):
    """Flash-attention kernel against its plain version; timings at the
    main path's shape.  Returns the kernel line's numbers."""
    from torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [  # (bh, sq, sk, d, dtype, causal, bias, window)
        (96, 512, 512, 64, f32, True, None, None),
        (96, 512, 512, 64, bf16, True, None, None),
        (96, 512, 512, 64, f32, False, "keypad", None),
        (96, 512, 512, 64, f32, True, None, 128),
        (96, 500, 500, 64, f32, True, None, None),
        (24, 300, 700, 64, f32, False, "full", None),
        (16, 256, 256, 128, f32, True, None, None),
        (8, 200, 200, 40, f16, True, "keypad", None),
    ]
    print("flash-attention forward vs plain (err: max abs / max(1, max "
          "|ref|)):")
    main_err = None
    for bh, sq, sk, d, dtype, causal, kind, window in cases:
        q, k, v = (torch.randn((bh, s, d), generator=g, device="cuda")
                   .to(dtype) for s in (sq, sk, sk))
        bias = None
        if kind == "keypad":   # per batch of 12 heads, the last keys masked
            pad = torch.zeros((bh // 12 or 1, 1, sk), device="cuda")
            for i in range(pad.shape[0]):
                pad[i, 0, sk - 1 - 17 * i:] = -1e30
            bias = torch.repeat_interleave(pad, bh // pad.shape[0], dim=0)
        elif kind == "full":
            bias = torch.randn((1, sq, sk), generator=g, device="cuda")
        scale = d ** -0.5
        out, lse = attention.flash_attention_fwd(q, k, v, bias, scale,
                                                 causal, window=window)
        torch.cuda.synchronize()
        rout, rlse = attention.flash_attention_reference(
            q.float(), k.float(), v.float(), bias, scale, causal, window)
        tol = 2e-5 if dtype == f32 else 2e-2
        tag = (f"({bh}, {sq}, {sk}, {d}) {str(dtype)[6:]} causal={causal} "
               f"bias={kind} window={window}")
        eo, eo_abs = scaled_err(out, rout)
        check(f"{tag} out", eo, tol)
        check(f"{tag} lse", scaled_err(lse, rlse)[0], 2e-5)
        if (bh, sq, d, dtype, causal, kind, window) == \
                (96, 512, 64, f32, True, None, None):
            main_err = eo_abs

    bh, s, d = 96, 512, 64
    q, k, v = (torch.randn((bh, s, d), generator=g, device="cuda")
               for _ in range(3))
    scale = d ** -0.5
    q4, k4, v4 = (t.view(BATCH, bh // BATCH, s, d) for t in (q, k, v))
    ms, host = median_ms(lambda: attention.flash_attention_fwd(
        q, k, v, None, scale, True))
    plain = median_ms(lambda: attention.flash_attention_reference(
        q, k, v, None, scale, True))[0]
    lib = median_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale))[0]
    nbytes = 4 * bh * s * d * 4 + bh * s * 4
    ops = 4 * d * bh * _unmasked_pairs(s, s, True, None)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    bound = 1e3 * max(t_bytes, t_ops)
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  time ({bh}, {s}, {s}, {d}) fp32 causal: kernel {ms:.4f} ms "
          f"(host {host:.4f} ms a call), plain {plain:.4f} ms, "
          f"F.scaled_dot_product_attention "
          f"{lib:.4f} ms, bound {bound:.4f} ms ({by}; {ops / 1e9:.3f} "
          f"GFLOP at the fp32 rate, {nbytes / 1e6:.1f} MB)")
    return dict(max_abs_err=main_err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by)


def main_path(torch, dispatch, gpt):
    """generate() on GPT-2 small at full width; returns the model, the
    output tokens, the launch counts and the card's logits for phase 4."""
    torch.manual_seed(SEED)
    model = gpt.gpt2_small(max_positions=MAX_POS, dropout=0.0,
                           attn_dropout=0.0, device="cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompt = torch.randint(0, 50257, (BATCH, PROMPT), generator=g,
                           device="cuda")
    gpt.generate(model, prompt[:, :16], 2)        # warm-up: cuBLAS, caches
    torch.cuda.synchronize()

    dispatch.reset_counts()
    t0 = time.perf_counter()
    out = gpt.generate(model, prompt, NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dispatch.counts()

    print("main path: generate(gpt2_small, batch 8, prompt 512, 128 new "
          "tokens, fp32, greedy)")
    print(f"  launches: {counts}")
    layers = len(model.blocks)
    want = {"flash_attention_fwd": layers,
            "ln_forward": (2 * layers + 1) * NEW}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if out.shape != (BATCH, PROMPT + NEW) or out.dtype != torch.long:
        raise AssertionError(f"output {tuple(out.shape)} {out.dtype}")
    if not torch.equal(out[:, :PROMPT], prompt):
        raise AssertionError("generate changed the prompt")
    if int(out.min()) < 0 or int(out.max()) >= 50257:
        raise AssertionError("generated ids outside the vocabulary")

    # the same work phase by phase, teacher-forced with the tokens above
    with torch.inference_mode():
        caches = model.init_caches(BATCH, PROMPT + NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(out[:, :PROMPT], caches)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits[:2].float().cpu()
        greedy_ok = torch.equal(logits[:, -1].argmax(-1), out[:, PROMPT])
        step_logits = []
        t0 = time.perf_counter()
        for t in range(PROMPT, PROMPT + NEW - 1):
            logits, caches = model.decode_step(out[:, t], caches, t)
            if t < PROMPT + 8:
                step_logits.append(logits[:2].float().cpu())
                greedy_ok &= torch.equal(logits.argmax(-1), out[:, t + 1])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    if not torch.isfinite(prefill_logits).all():
        raise AssertionError("non-finite prefill logits")
    if not greedy_ok:
        raise AssertionError("generate's tokens are not the argmax of the "
                             "same model's logits")
    tok_s = BATCH * (NEW - 1) / decode_s
    print(f"  generate wall {wall:.3f} s; prefill {1e3 * prefill_s:.2f} ms; "
          f"decode {NEW - 1} steps {decode_s:.3f} s = {tok_s:.1f} tokens/s "
          f"(batch {BATCH})")
    return model, out, counts, prefill_logits, step_logits


def _profiled(torch, fn):
    """Run ``fn`` under ``torch.profiler``; returns the window's wall ms,
    the device's busy ms (union of kernel and copy intervals on the card),
    the device ms per kernel name (None and None where the profiler saw no
    device activity) and the number of device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall_ms, None, None, 0
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
        if e > end:
            busy += e - max(s, end)
            end = e
    return wall_ms, busy / 1e3, by_name, len(spans)


def profile_phase(torch, model, out, steps=8):
    """Where the time goes: the prefill and ``steps`` decode steps of the
    main path's work under ``torch.profiler`` (which adds host time of its
    own, so the idle shares are upper bounds)."""
    print("profile (torch.profiler; device busy = union of device "
          "intervals):")
    with torch.inference_mode():
        caches = model.init_caches(BATCH, PROMPT + NEW)
        state = {}

        def prefill():
            state["caches"] = model.prefill(out[:, :PROMPT], caches)[1]

        def decode():
            c = state["caches"]
            for t in range(PROMPT, PROMPT + steps):
                c = model.decode_step(out[:, t], c, t)[1]

        for what, fn in (("prefill", prefill),
                         (f"{steps} decode steps", decode)):
            wall, busy, by_name, n = _profiled(torch, fn)
            if busy is None:
                print(f"  {what}: wall {wall:.2f} ms; device time not "
                      f"measured (the profiler saw no device activity)")
                continue
            print(f"  {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms,"
                  f" idle share {1 - busy / wall:.3f}, {n} device "
                  f"operations")
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
                print(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")


def cpu_phase(torch, gpt, model, out, prefill_logits, step_logits):
    """The same weights on the CPU (the plain versions): prefill logits of
    the first 2 sequences and 8 teacher-forced decode steps."""
    cpu = gpt.gpt2_small(max_positions=MAX_POS, dropout=0.0,
                         attn_dropout=0.0, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = out[:2].cpu()
    tol = 1e-3     # fp32 on both sides, TF32 off; sums in other orders
    print("card vs CPU (same weights; max abs logit difference):")
    with torch.inference_mode():
        caches = cpu.init_caches(2, PROMPT + NEW)
        logits, caches = cpu.prefill(toks[:, :PROMPT], caches)
        check("prefill logits (2, 512, 50257)",
              (logits - prefill_logits).abs().max().item(), tol)
        for i, want in enumerate(step_logits):
            t = PROMPT + i
            logits, caches = cpu.decode_step(toks[:, t], caches, t)
            check(f"decode step t={t} logits",
                  (logits - want).abs().max().item(), tol)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from apex_tpu_torch import _build
    from apex_tpu_torch.kernels import attention, dispatch, layer_norm
    from apex_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"kernel build: {built}, {time.perf_counter() - t0:.1f} s")

    ln = ln_phase(torch, layer_norm)
    fl = flash_phase(torch, attention)
    model, out, counts, prefill_logits, step_logits = main_path(
        torch, dispatch, gpt)
    profile_phase(torch, model, out)
    cpu_phase(torch, gpt, model, out, prefill_logits, step_logits)

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_attention.cu",
             replaces="apex_tpu/kernels/attention.py:352",
             launches=counts["flash_attention_fwd"],
             shape="(96, 512, 64) fp32 causal", **fl),
        dict(name="ln_forward", route="cuda",
             source="apex_tpu_torch/csrc/layer_norm.cu",
             replaces="apex_tpu/kernels/layer_norm.py:77",
             launches=counts["ln_forward"],
             shape="(4096, 768) fp32 affine", **ln),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
