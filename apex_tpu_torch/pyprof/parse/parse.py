"""Parse stage: raw op events -> enriched op rows, the port's copy of
``apex_tpu/pyprof/parse/parse.py`` (reference: apex/pyprof/parse/).

:func:`enrich` is the JAX package's: stable seq ids, and the backward
synthesised from the forward list (every differentiable forward op
contributes a backward row in reverse program order, ``corr`` linking it
to its forward row).  ``--trace`` joins a ``torch.profiler`` trace's
measured times onto the rows (``trace.py``), where the JAX CLI took a
``jax.profiler`` dump and the compiled HLO.
"""
from __future__ import annotations

import json

# ops with no gradient path (or none worth modeling); the per-family
# backward cost factors live in prof/models.py model_row
_NO_BWD = {"flatten", "pad"}


def enrich(events, with_backward: bool = True):
    """-> list of row dicts: fwd rows (trace order) then synthesized bwd rows
    (reverse order), each carrying seq/dir/corr."""
    rows = []
    for i, e in enumerate(events):
        r = dict(e)
        r["seq"] = i
        r["dir"] = "fwd"
        r["corr"] = i
        rows.append(r)
    if with_backward:
        nxt = len(rows)
        for e in reversed(rows[:]):
            op = e["op"]
            if op in _NO_BWD or op.startswith("optimizer."):
                continue
            b = dict(e)
            b["seq"] = nxt
            b["dir"] = "bwd"
            b["corr"] = e["seq"]
            b["op"] = op
            nxt += 1
            rows.append(b)
    return rows


def main(argv=None):
    import argparse
    import sys
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.pyprof.parse",
        description="raw capture (.jsonl) -> enriched op dict on stdout")
    p.add_argument("file",
                   help="event log written by apex_tpu_torch.pyprof.save")
    p.add_argument("--no-backward", action="store_true",
                   help="forward ops only")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="a torch.profiler Chrome trace (export_chrome_trace "
                        "output, or a directory holding one) of runs "
                        "recorded under pyprof.capture: join its measured "
                        "times onto the rows")
    p.add_argument("--executions", type=int, default=1,
                   help="how many step executions the trace covers "
                        "(durations are reported per execution)")
    args = p.parse_args(argv)
    with open(args.file) as f:
        events = [json.loads(line) for line in f if line.strip()]
    rows = enrich(events, with_backward=not args.no_backward)
    if args.trace:
        from .trace import correlate, load_trace, merge_measurements
        joined = correlate(load_trace(args.trace))
        rows = merge_measurements(rows, joined["per_seq"],
                                  executions=args.executions)
        print(f"# matched {len(joined['per_seq'])} ops, unattributed "
              f"{joined['unattributed_ns'] / 1e3:.1f}us "
              f"({joined['basis']})", file=sys.stderr)
    for row in rows:
        sys.stdout.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
