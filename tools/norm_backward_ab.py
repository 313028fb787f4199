#!/usr/bin/env python3
"""Time the norm backward row kernels of one source tree, for an A/B on one
card.

    python3 tools/norm_backward_ab.py TREE LABEL OUT.jsonl

TREE is a directory holding an ``apex_tpu_torch`` package: this checkout
(``.``) or another commit unpacked beside it by ``git archive`` into an
ignored directory (``build/...``).  For the LayerNorm and RMSNorm
backwards at the train step's (16384, 768) bf16, BERT's (8192, 768) bf16
and amp O2's (16384, 768) fp16 with an fp32 weight, the script times the
tree's row kernel (``apex_ln_bwd`` / ``apex_rms_bwd``) on each route it
has, into a workspace of the rows ``apex_*_bwd_parts`` gives: warm
(back-to-back calls on one set of inputs) and cold (rotating over sets of
2 x the L2's size) with ``chip_smoke.median_ms``, and each launch's device
time alone with ``chip_smoke.kernel_split_ms`` (``torch.profiler``).  An
entry point without a route argument has one route, timed as ``scalar``.
Each route's dx is first held against the plain version.  One JSON line a
(kind, shape, route) is printed and appended to OUT.jsonl.  To compare
trees, run them in turns in one chip call (parent, change, change,
parent).
"""
import importlib.util
import itertools
import json
import math
import os
import sys

SHAPES = [((16384, 768), "bfloat16", "bfloat16"),
          ((8192, 768), "bfloat16", "bfloat16"),
          ((16384, 768), "float16", "float32")]
# the row kernels' names (torch.profiler) and the entry points' argument
# counts without a route argument
KERNEL = {("ln", "vec"): "ln_bwd_vec_kernel",
          ("ln", "scalar"): "ln_bwd_kernel",
          ("rms", "vec"): "rms_bwd_vec_kernel",
          ("rms", "scalar"): "rms_bwd_kernel"}
ONE_ROUTE_ARGS = {"ln": 14, "rms": 12}


def main(tree, label, out_path):
    sys.path.insert(0, os.path.abspath(tree))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("norm_backward_ab: no CUDA device", file=sys.stderr)
        return 1
    from apex_tpu_torch.kernels import layer_norm, rms_norm
    if not layer_norm.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {layer_norm.__file__}, not {tree}'s")
    g = torch.Generator(device="cuda").manual_seed(7)
    card = cs.card_line()
    st = torch.cuda.current_stream().cuda_stream
    res = []
    for kind, mod in (("ln", layer_norm), ("rms", rms_norm)):
        lib = mod._lib()
        entry = lib.apex_ln_bwd if kind == "ln" else lib.apex_rms_bwd
        one_route = len(entry.argtypes) == ONE_ROUTE_ARGS[kind]
        routes = {"scalar": None} if one_route else {"vec": 1, "scalar": 0}
        code = mod.dtype_code
        for shape, dtype, wdtype in SHAPES:
            rows, n = shape
            dt, wdt = getattr(torch, dtype), getattr(torch, wdtype)
            set_bytes = 3 * rows * n * (torch.finfo(dt).bits // 8)
            k = max(4, math.ceil(2 * cs.L2_BYTES / set_bytes))
            xs = (torch.randn((k, rows, n), generator=g, device="cuda") * 2
                  + 1).to(dt)
            gs = torch.randn((k, rows, n), generator=g, device="cuda").to(dt)
            w = (torch.randn(n, generator=g, device="cuda") * 0.5 + 1).to(wdt)
            sets = [(gs[i], xs[i], cs._norm_stats(kind, mod, xs[i]),
                     torch.empty_like(xs[i])) for i in range(k)]
            ref = cs._norm_bwd_fns(kind, mod)[2](
                sets[0][0].float(), sets[0][1].float(), sets[0][2],
                w.float())[0]
            for route, rc in routes.items():
                parts = (lib.apex_ln_bwd_parts if kind == "ln"
                         else lib.apex_rms_bwd_parts)(
                    rows, n, *(() if rc is None else (code(dt), rc)))
                ws = [torch.empty((parts, n), device="cuda")
                      for _ in range(2 if kind == "ln" else 1)]
                tail = ([] if rc is None else [rc]) + [st]

                def fn(s, parts=parts, ws=ws, tail=tail):
                    gg, x, stats, dx = s
                    head = [gg.data_ptr(), x.data_ptr()] \
                        + [t.data_ptr() for t in stats] \
                        + [w.data_ptr(), code(wdt), dx.data_ptr()] \
                        + [t.data_ptr() for t in ws]
                    err = entry(*head, parts, rows, n, code(dt), *tail)
                    if err:
                        raise RuntimeError(f"{kind} backward entry point, "
                                           f"{route}: CUDA error {err}")
                fn(sets[0])
                torch.cuda.synchronize()
                cs.check(f"{label} {kind} {shape} {dtype} {route} dx",
                         cs.scaled_err(sets[0][3], ref)[0],
                         1e-2 if kind == "ln" else 2e-2)
                warm = cs.median_ms(lambda: fn(sets[0]))[0]
                it = itertools.cycle(sets)
                cold = cs.median_ms(lambda: fn(next(it)))[0]
                name = KERNEL[(kind, route)]
                device = cs.kernel_split_ms(torch, lambda: fn(sets[0]),
                                            (name,))[name]
                r = dict(label=label, kind=kind, shape=list(shape),
                         dtype=dtype, weight=wdtype, route=route,
                         parts=parts, warm_ms=warm, cold_ms=cold,
                         device_ms=device, card=card)
                res.append(r)
                print(json.dumps(r))
            del xs, gs, sets
    with open(out_path, "a") as f:
        for r in res:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 4:
        sys.exit(__doc__)
    sys.exit(main(*sys.argv[1:]))
