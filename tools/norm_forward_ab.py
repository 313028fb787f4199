#!/usr/bin/env python3
"""Time the norm forward kernels of one source tree, for an A/B on one card.

    python3 tools/norm_forward_ab.py TREE LABEL OUT.jsonl

TREE is a directory holding an ``apex_tpu_torch`` package: this checkout
(``.``) or another commit unpacked beside it by ``git archive`` into an
ignored directory (``build/...``).  For the LayerNorm and RMSNorm
forwards, at ``chip_smoke.py``'s timed shapes and a few small ones, the
script times each route of the tree's C entry point (``apex_ln_fwd`` /
``apex_rms_fwd``) and ``y.copy_(x)`` of the same bytes, warm (back-to-back
calls on one input) and cold (rotating over inputs of 2 x the L2's size),
with ``chip_smoke.median_ms``; each route is first held against the plain
version.  It reads three forms of the entry points by their argument
count: PR 8's (fp32 parameters, one route, timed as ``pr8``), one that
also takes a grid (0 for its default), and this tree's.  One JSON line a
(kind, shape, route) is printed and appended to OUT.jsonl.  To compare
trees, run them in turns in one chip call (parent, change, change,
parent); the parameters are in x's dtype, as the steps and ``generate``
hold them.
"""
import importlib.util
import itertools
import json
import math
import os
import sys

SHAPES = [((16384, 768), "bfloat16"), ((8192, 768), "bfloat16"),
          ((1280, 768), "bfloat16"), ((4096, 768), "float32"),
          ((8, 768), "float32"), ((8, 768), "bfloat16"),
          ((32, 2048), "bfloat16")]
EPS = 1e-5


def main(tree, label, out_path):
    sys.path.insert(0, os.path.abspath(tree))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("norm_forward_ab: no CUDA device", file=sys.stderr)
        return 1
    from apex_tpu_torch.kernels import layer_norm, rms_norm
    if not layer_norm.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {layer_norm.__file__}, not {tree}'s")
    g = torch.Generator(device="cuda").manual_seed(5)
    card = cs.card_line()
    st = torch.cuda.current_stream().cuda_stream
    res = []
    for kind, mod in (("ln", layer_norm), ("rms", rms_norm)):
        lib = mod._lib()
        nargs = len((lib.apex_ln_fwd if kind == "ln"
                     else lib.apex_rms_fwd).argtypes)
        code = mod.dtype_code
        for shape, dtype in SHAPES:
            rows, n = shape
            dt = getattr(torch, dtype)
            pair_bytes = 2 * rows * n * (torch.finfo(dt).bits // 8)
            k = max(4, math.ceil(2 * cs.L2_BYTES / pair_bytes))
            xs = (torch.randn((k, rows, n), generator=g, device="cuda") * 2
                  + 1).to(dt)
            w = (torch.randn(n, generator=g, device="cuda") * 0.5 + 1).to(dt)
            b = (torch.randn(n, generator=g, device="cuda").to(dt)
                 if kind == "ln" else None)
            pairs = [(xs[i],) + cs._norm_outputs(torch, kind, xs[i])
                     for i in range(k)]
            _, ref_fn = cs._norm_fns(kind, mod)
            ref = ref_fn(pairs[0][0].float(), w.float(),
                         None if b is None else b.float(), EPS)
            tol = 1e-5 if dt == torch.float32 else 2e-2

            def entry(route, grid_arg):
                """The entry point on ``route`` (None: PR 8's, fp32
                parameters), with a trailing grid argument of 0 if
                ``grid_arg``."""
                wf = w.float() if route is None else w
                bf = (None if b is None else
                      b.float() if route is None else b)
                tail = ([] if route is None else [route]) \
                    + ([0] if grid_arg else []) + [st]

                def fn(x, y, mean, rstd):
                    if kind == "ln":
                        head = [x.data_ptr(), wf.data_ptr()] \
                            + ([] if route is None else [code(wf.dtype)]) \
                            + [bf.data_ptr()] \
                            + ([] if route is None else [code(bf.dtype)]) \
                            + [y.data_ptr(), mean.data_ptr(),
                               rstd.data_ptr()]
                        err = lib.apex_ln_fwd(*head, rows, n, EPS,
                                              code(x.dtype), *tail)
                    else:
                        head = [x.data_ptr(), wf.data_ptr()] \
                            + ([] if route is None else [code(wf.dtype)]) \
                            + [y.data_ptr(), rstd.data_ptr()]
                        err = lib.apex_rms_fwd(*head, rows, n, EPS,
                                               code(x.dtype), *tail)
                    if err:
                        raise RuntimeError(f"{kind} entry point: CUDA "
                                           f"error {err}")
                return fn
            form = {11: "pr8", 15: "grid", 14: "route"} if kind == "ln" \
                else {9: "pr8", 12: "grid", 11: "route"}
            if form[nargs] == "pr8":      # no route, fp32 parameters
                routes = {"pr8": entry(None, False)}
            else:
                grid_arg = form[nargs] == "grid"
                routes = {name: entry(rc, grid_arg)
                          for name, rc in cs.NORM_VARIANTS}
            calls = {}
            for name, fn in routes.items():
                fn(*pairs[0])
                torch.cuda.synchronize()
                cs._norm_check(kind, f"{label} {kind} {shape} {dtype} {name}",
                               pairs[0][1:], ref, tol)
                calls[name] = lambda p, fn=fn: fn(*p)
            calls["copy"] = lambda p: p[1].copy_(p[0])
            for name, call in calls.items():
                warm = cs.median_ms(lambda: call(pairs[0]))[0]
                it = itertools.cycle(pairs)
                cold = cs.median_ms(lambda: call(next(it)))[0]
                r = dict(label=label, kind=kind, shape=list(shape),
                         dtype=dtype, variant=name, warm_ms=warm,
                         cold_ms=cold, card=card)
                res.append(r)
                print(json.dumps(r))
            del xs, pairs
    with open(out_path, "a") as f:
        for r in res:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 4:
        sys.exit(__doc__)
    sys.exit(main(*sys.argv[1:]))
