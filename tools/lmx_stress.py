#!/usr/bin/env python3
"""Stress the fused LM-head backward's tensor-core kernels (dx and dW).

    python3 tools/lmx_stress.py MODE CALLS

At the Llama loss's (16368, 32000, 768) bf16 shape, repeats
``lm_head_xent_backward`` CALLS times and prints one JSON line: the launch
pairs made, the status (``ok``, a mismatch, or the CUDA error that stopped
the run) and the seconds.  MODE ``sync`` synchronises after every call and
holds every 500th result bit for bit against the first; ``timed`` runs
``chip_smoke.median_ms``'s loop (3 calls behind a device-side sleep, 10
reps); ``after_norm`` runs ``chip_smoke.ln_phase`` and ``rms_phase`` first,
then ``sync``.  Run it under ``timeout``: a fault ends the process's CUDA
context.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main(mode, calls):
    import torch
    if not torch.cuda.is_available():
        print("lmx_stress: no CUDA device", file=sys.stderr)
        return 1
    from apex_tpu_torch.kernels import dispatch, layer_norm, lm_head_xent, \
        rms_norm
    if mode == "after_norm":
        cs.ln_phase(torch, layer_norm, dispatch)
        cs.rms_phase(torch, rms_norm, dispatch)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 30)
    n0, v0, e0 = 16368, 32000, 768
    x, emb, lab = cs._lmx_case(torch, g, n0, v0, e0, torch.bfloat16)
    gm = torch.full((n0,), 1.0 / n0, device="cuda")
    _, lse = lm_head_xent.lm_head_xent_forward(x, emb, lab)
    dx0, dw0 = lm_head_xent.lm_head_xent_backward(x, emb, lab, lse, gm)
    torch.cuda.synchronize()

    def fn():
        return lm_head_xent.lm_head_xent_backward(x, emb, lab, lse, gm)
    done, t0, status = 0, time.perf_counter(), "ok"
    try:
        if mode == "timed":
            while done < calls:
                cs.median_ms(fn, reps=10, inner=3)
                done += 3 + 3 + 3 * 10    # warm-up, host pass, timed reps
        else:
            for i in range(calls):
                dx, dw = fn()
                torch.cuda.synchronize()
                done += 1
                if i % 500 == 0 and not (torch.equal(dx, dx0)
                                         and torch.equal(dw, dw0)):
                    status = f"mismatch at {i}"
                    break
    except Exception as exc:  # noqa: BLE001 - the fault is the result
        status = f"{type(exc).__name__}: {exc}"[:300]
    print(json.dumps(dict(mode=mode, launch_pairs=done, status=status,
                          seconds=round(time.perf_counter() - t0, 1))))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("sync", "timed",
                                                 "after_norm"):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
