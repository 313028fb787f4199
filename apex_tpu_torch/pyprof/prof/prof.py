"""Prof stage: enriched rows -> per-op metrics + roofline estimate, the
port's copy of ``apex_tpu/pyprof/prof/prof.py`` (reference:
apex/pyprof/prof/prof.py driving the per-family handlers, with
output.py's columnar/CSV writer).

The roofline estimate is ``max(flops / peak, bytes / bandwidth)`` against
the published peaks of one NVIDIA H100 SXM (NVIDIA's H100 Tensor Core GPU
data sheet, dense rates without sparsity, at the full 700 W power limit):
989 TFLOP/s bf16/fp16 on the tensor cores, 495 TFLOP/s TF32, 67 TFLOP/s
fp32 outside the tensor cores, 3.35 TB/s of HBM3.  An fp32 row is priced
at the fp32 rate (the port keeps TF32 off), not at half the bf16 rate,
which is the TPU MXU's rule.  A card set below 700 W reaches less; the
``eff`` column (estimate over measured time) is against these peaks.
"""
from __future__ import annotations

import json

from .models import model_row

H100_SXM_BF16_TFLOPS = 989.0      # dense bf16 / fp16, tensor cores
H100_SXM_TF32_TFLOPS = 495.0      # dense TF32, tensor cores
H100_SXM_FP32_TFLOPS = 67.0       # fp32 outside the tensor cores
H100_SXM_HBM_GBS = 3350.0         # HBM3


def analyze_rows(rows, peak_tflops: float = H100_SXM_BF16_TFLOPS,
                 hbm_gbs: float = H100_SXM_HBM_GBS,
                 fp32_tflops: float = H100_SXM_FP32_TFLOPS):
    out = []
    for row in rows:
        flops, bytes_, mxu = model_row(row)
        dtype = (row.get("dtypes") or ["float32"])[0]
        peak = peak_tflops * 1e12
        if dtype in ("float32", "float64"):
            peak = fp32_tflops * 1e12
        t_compute = flops / peak
        t_memory = bytes_ / (hbm_gbs * 1e9)
        est_us = max(t_compute, t_memory) * 1e6
        dur = row.get("dur_us")
        out.append({
            **row,
            "flops": flops,
            "bytes": bytes_,
            "ai": round(flops / bytes_, 2) if bytes_ else 0.0,
            "mxu": mxu,
            "bound": "compute" if t_compute >= t_memory else "memory",
            "est_us": round(est_us, 3),
            # measured columns (present when parse joined a profiler trace):
            # achieved TFLOP/s and fraction of the roofline estimate
            "meas_us": dur,
            "tflops": (round(flops / (dur * 1e-6) / 1e12, 3)
                       if dur else None),
            "eff": (round(est_us / dur, 3) if dur else None),
        })
    return out


def _shapes_str(row):
    return ";".join("x".join(str(d) for d in s) for s in row["shapes"][:3])


def write_columnar(rows, file, top=None):
    from .output import Table
    measured = any(r.get("meas_us") is not None for r in rows)
    cols = ["seq", "dir", "op", "scope", "shapes", "dtype", "flops",
            "bytes", "AI", "MXU", "bound", "est_us"]
    if measured:
        cols += ["meas_us", "TFLOP/s"]
    t = Table(cols, file=file)
    total_f = total_b = total_t = total_m = 0.0
    body = rows if top is None else sorted(
        rows, key=lambda r: -(r["meas_us"] if measured and r.get("meas_us")
                              else r["est_us"]))[:top]
    for r in body:
        mxu = r["mxu"]
        vals = [r["seq"], r["dir"], r["op"], r.get("scope", ""),
                _shapes_str(r), (r.get("dtypes") or ["-"])[0],
                _human(r["flops"]), _human(r["bytes"]), r["ai"],
                "-" if mxu is None else
                f"{'Y' if mxu['eligible'] else 'n'}:{mxu['util']:.2f}",
                r["bound"], r["est_us"]]
        if measured:
            vals += [r.get("meas_us") if r.get("meas_us") is not None
                     else "-",
                     r.get("tflops") if r.get("tflops") is not None else "-"]
        t.row(vals)
    n_meas = 0
    for r in rows:
        total_f += r["flops"]
        total_b += r["bytes"]
        total_t += r["est_us"]
        if r.get("meas_us") is not None:
            total_m += r["meas_us"]
            n_meas += 1
    totals = ["", "", "TOTAL", "", "", "", _human(total_f), _human(total_b),
              round(total_f / total_b, 2) if total_b else 0, "", "",
              round(total_t, 1)]
    if measured:
        # mark coverage so a partial join isn't read as "faster than
        # roofline": meas total only spans the measured rows
        cov = "" if n_meas == len(rows) else f" ({n_meas}/{len(rows)} rows)"
        totals += [f"{round(total_m, 1)}{cov}", ""]
    t.row(totals)
    t.flush()


def _human(n):
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(n) < 1000:
            return f"{n:.1f}{unit}" if unit else f"{int(n)}"
        n /= 1000.0
    return f"{n:.1f}E"


def write_csv(rows, file):
    import csv
    w = csv.writer(file)
    w.writerow(["seq", "dir", "op", "scope", "shapes", "dtype", "flops",
                "bytes", "ai", "mxu_eligible", "mxu_util", "bound",
                "est_us", "meas_us", "tflops", "eff", "callsite"])
    for r in rows:
        mxu = r["mxu"] or {}
        w.writerow([r["seq"], r["dir"], r["op"], r.get("scope", ""),
                    _shapes_str(r), (r.get("dtypes") or ["-"])[0],
                    r["flops"], r["bytes"], r["ai"],
                    mxu.get("eligible", ""), mxu.get("util", ""),
                    r["bound"], r["est_us"], r.get("meas_us", ""),
                    r.get("tflops", ""), r.get("eff", ""),
                    r.get("callsite") or ""])


def main(argv=None):
    import argparse
    import sys
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.pyprof.prof",
        description="enriched op dict -> FLOP/byte/tensor-core/roofline "
                    "analysis")
    p.add_argument("file",
                   help="output of python -m apex_tpu_torch.pyprof.parse")
    p.add_argument("--csv", action="store_true")
    p.add_argument("--top", type=int, default=None,
                   help="only the N most expensive ops")
    p.add_argument("--peak-tflops", type=float, default=H100_SXM_BF16_TFLOPS)
    p.add_argument("--hbm-gbs", type=float, default=H100_SXM_HBM_GBS)
    p.add_argument("--fp32-tflops", type=float,
                   default=H100_SXM_FP32_TFLOPS)
    args = p.parse_args(argv)
    with open(args.file) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = analyze_rows(rows, args.peak_tflops, args.hbm_gbs,
                        args.fp32_tflops)
    if args.csv:
        write_csv(rows, sys.stdout)
    else:
        write_columnar(rows, sys.stdout, top=args.top)


if __name__ == "__main__":
    main()
