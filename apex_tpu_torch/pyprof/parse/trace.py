"""Measured-profile ingestion: join a ``torch.profiler`` trace to the
annotate-stage op log, the PyTorch counterpart of
``apex_tpu/pyprof/parse/trace.py`` (reference: apex/pyprof/parse/nvvp.py,
which correlates nvprof's kernel rows with the NVTX ranges around their
launches and the backward with the forward by autograd sequence id).

The inputs: the op log (``annotate``: one ``pp<seq>_<op>`` profiler range a
recorded op) and a ``torch.profiler`` Chrome trace of the same runs.  The
join, for each unit of work (*item*):

* On the card an item is a kernel (``cat == "kernel"``).  It links to its
  launching runtime event (``cudaLaunchKernel`` and its kin) by
  correlation id; that event lies, on its host thread, inside the op's
  ``pp<seq>_<op>`` range (a forward kernel), or inside an
  ``autograd::engine::evaluate_function: <Node>`` range on the autograd
  thread (a backward kernel), whose ``Sequence number`` the profiler also
  records on the forward op that made the node; the forward op lies in a
  ``pp`` range, which names the backward's row.
* Where the trace has no kernels (the CPU), an item is an outermost aten op
  (a ``cpu_op`` inside no other ``cpu_op`` on its thread), and the same
  join runs over its CPU time.

An item that reaches no row is *unattributed*, under its name (its kernel's
name without template arguments, ``bwd:<Node>`` for a backward node with
no recorded forward, ``graph_replay`` for a kernel of a CUDA graph replay,
which runs no op, ``no_launch_record`` for a kernel whose launch the trace
lacks).  Times are integer nanoseconds, so the matched and the
unattributed time add up to the items' total exactly.  Launches whose
kernel the profiler dropped (a runtime launch with no kernel record) are
counted apart.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re

_PP_RE = re.compile(r"^pp(\d+)_")
_BWD_PREFIX = "autograd::engine::evaluate_function: "
# runtime and driver calls that launch a kernel, or a graph, by name prefix
# (the trace may carry a version suffix: "cudaLaunchKernelExC_v11060")
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel",
             "cudaLaunchCooperativeKernel")
_GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def find_trace_json(path: str) -> str:
    """A Chrome trace file itself, or the newest ``*.json(.gz)`` under a
    directory (``torch.profiler.tensorboard_trace_handler``'s output)."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json*"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(
            f"no *.json(.gz) trace found under {path!r}; pass a file from "
            f"torch.profiler's export_chrome_trace or its directory")
    return hits[-1]


def load_trace(src):
    """The trace's event list from a path (file or directory), a loaded
    Chrome trace dict, or an event list."""
    if isinstance(src, list):
        return src
    if isinstance(src, dict):
        return src.get("traceEvents", [])
    f = find_trace_json(src)
    opener = gzip.open if f.endswith(".gz") else open
    with opener(f, "rt") as fh:
        return json.load(fh).get("traceEvents", [])


def _ns(us) -> int:
    return int(round(float(us) * 1000.0))


def _short(name: str) -> str:
    """A kernel's demangled name without its template arguments, its
    parameters and the ``(anonymous namespace)`` qualifier (whose
    parentheses are not a parameter list): ``void (anonymous
    namespace)::ln_fwd_vec_kernel<...>(...)`` -> ``void
    ln_fwd_vec_kernel``."""
    base = name.replace("(anonymous namespace)::", "")
    base = base.split("<", 1)[0].split("(", 1)[0].strip()
    return base or name


def _kind(e):
    cat, name = e.get("cat"), e.get("name", "")
    if cat == "user_annotation":
        m = _PP_RE.match(name)
        return ("pp", int(m.group(1))) if m else None
    if cat == "cpu_op":
        args = e.get("args") or {}
        seqnr = args.get("Sequence number")
        if name.startswith(_BWD_PREFIX):
            return ("bwd", (seqnr, name[len(_BWD_PREFIX):]))
        return ("op", seqnr)
    if cat in _RUNTIME_CATS:
        return ("rt", (e.get("args") or {}).get("correlation"))
    return None


def _walk(events):
    """Each host range's place among the ranges of its thread, by one sweep
    of each thread's properly nested ranges: for every range, the innermost
    enclosing ``pp`` or backward-node range (itself for a backward node)
    and whether a ``cpu_op`` encloses it.  -> list of
    ``(event, kind, payload, inner, has_cpu_parent)``."""
    threads = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        k = _kind(e)
        if k is None:
            continue
        start = _ns(e.get("ts", 0))
        end = start + _ns(e.get("dur", 0))
        threads.setdefault((e.get("pid"), e.get("tid")), []).append(
            (start, end, k[0], k[1], e))
    out = []
    for items in threads.values():
        items.sort(key=lambda x: (x[0], -x[1]))
        stack = []
        for it in items:
            start, end, kind, payload, e = it
            while stack and stack[-1][1] <= start:
                stack.pop()
            inner = None
            if kind == "bwd":
                inner = it
            else:
                for s in reversed(stack):
                    if s[2] in ("pp", "bwd"):
                        inner = s
                        break
            cpu_parent = any(s[2] in ("op", "bwd") for s in stack)
            out.append((e, kind, payload, inner, cpu_parent))
            stack.append(it)
    return out


def correlate(events):
    """Join the trace's items to the op log's rows (see the module
    docstring).  -> dict with ``per_seq`` (``{seq: {fwd_ns, bwd_ns, fwd_n,
    bwd_n}}`` summed over every execution in the trace), ``total_ns``,
    ``matched_ns``, ``unattributed_ns``, ``unattributed_by`` ({name: ns}),
    ``basis`` ("kernels" or "cpu_ops"), ``items``, ``kernel_names``
    ({short name: launches seen}), ``dropped_launches`` (runtime launches
    with no kernel record) and ``dropped_by`` ({op: count})."""
    events = [e for e in events if isinstance(e, dict)]
    kernels = [e for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    walked = _walk(events)

    # the forward op that made each autograd node -> its pp row
    seq_of_node = {}
    for e, kind, payload, inner, _ in walked:
        if kind == "op" and payload is not None and inner is not None \
                and inner[2] == "pp":
            seq_of_node.setdefault(payload, inner[3])

    per_seq = {}
    unattributed_by = {}
    total = [0, 0]                          # total_ns, unattributed_ns

    def attribute(dur, inner, name):
        total[0] += dur
        if inner is not None and inner[2] == "pp":
            seq, direction = inner[3], "fwd"
        elif inner is not None and inner[2] == "bwd":
            seqnr, node = inner[3]
            seq, direction = seq_of_node.get(seqnr), "bwd"
            if seq is None:
                name = f"bwd:{node}"
        else:
            seq = None
        if seq is None:
            total[1] += dur
            unattributed_by[name] = unattributed_by.get(name, 0) + dur
            return
        d = per_seq.setdefault(seq, {"fwd_ns": 0, "bwd_ns": 0, "fwd_n": 0,
                                     "bwd_n": 0})
        d[f"{direction}_ns"] += dur
        d[f"{direction}_n"] += 1

    launch_of = {}
    for e, kind, payload, inner, _ in walked:
        if kind == "rt" and payload is not None:
            launch_of[payload] = (e, inner)
    kernel_names = {}
    if kernels:
        basis = "kernels"
        seen = set()
        for k in kernels:
            corr = (k.get("args") or {}).get("correlation")
            seen.add(corr)
            dur = _ns(k.get("dur", 0))
            name = _short(k.get("name", ""))
            kernel_names[name] = kernel_names.get(name, 0) + 1
            hit = launch_of.get(corr)
            if hit is None:
                attribute(dur, None, "no_launch_record")
            elif hit[0].get("name", "").startswith(_GRAPH_LAUNCHES):
                attribute(dur, None, "graph_replay")
            else:
                attribute(dur, hit[1], name)
        dropped_by = {}
        for corr, (e, inner) in launch_of.items():
            if e.get("name", "").startswith(_LAUNCHES) and corr not in seen:
                where = "unattributed"
                if inner is not None and inner[2] == "pp":
                    where = f"fwd:{inner[3]}"
                elif inner is not None:
                    where = f"bwd:{inner[3][1]}"
                dropped_by[where] = dropped_by.get(where, 0) + 1
        items = len(kernels)
    else:
        basis = "cpu_ops"
        dropped_by = {}
        items = 0
        for e, kind, payload, inner, cpu_parent in walked:
            if kind not in ("op", "bwd") or cpu_parent:
                continue
            items += 1
            attribute(_ns(e.get("dur", 0)), inner, e.get("name", ""))
    return {
        "per_seq": per_seq,
        "total_ns": total[0],
        "matched_ns": sum(d["fwd_ns"] + d["bwd_ns"]
                          for d in per_seq.values()),
        "unattributed_ns": total[1],
        "unattributed_by": unattributed_by,
        "basis": basis,
        "items": items,
        "kernel_names": kernel_names,
        "dropped_launches": sum(dropped_by.values()),
        "dropped_by": dropped_by,
    }


def merge_measurements(rows, per_seq, executions: int = 1):
    """Attach measured per-execution durations (µs) to enriched rows: fwd
    rows from their seq's forward sum, synthesised bwd rows from the
    backward sum of the row they correlate to (``corr``).  Rows with no
    measurement keep ``dur_us=None``."""
    n = max(1, executions)
    out = []
    for r in rows:
        r = dict(r)
        m = per_seq.get(r.get("corr", r.get("seq")))
        if m is None:
            r["dur_us"] = None
        elif r.get("dir") == "bwd":
            r["dur_us"] = round(m["bwd_ns"] / 1e3 / n, 3) \
                if m["bwd_n"] else None
        else:
            r["dur_us"] = round(m["fwd_ns"] / 1e3 / n, 3) \
                if m["fwd_n"] else None
        out.append(r)
    return out


def profile_step(fn, *args, trace_dir=None, executions: int = 3,
                 with_backward: bool = True):
    """A measured profile of one step, run eagerly: ``fn(*args)`` once to
    warm up (kernel builds, caches), then ``executions`` times under
    ``torch.profiler`` (the card's kernels and the host's ops) with
    recording on, each execution's op log restarting at seq 0 so that its
    ``pp`` labels repeat.  A CUDA graph replay runs no op, so ``fn`` should
    run the step un-captured (``TrainStep._raw_step_fn``); a replay's
    kernels would count as ``graph_replay``.

    Returns ``(rows, report)``: enriched rows with the measured ``dur_us``
    per execution, and the join's statistics (:func:`correlate`'s, in µs
    where the JAX report has µs, plus the wrappers' launch counts over the
    profiled executions, ``launch_counts``)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ...kernels import dispatch as _dispatch
    from .. import annotate
    from .parse import enrich

    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    annotate.init()
    annotate.set_enabled(False)
    fn(*args)
    sync()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    before = _dispatch.counts()
    logs = []
    with profile(activities=activities) as prof:
        for _ in range(executions):
            annotate.clear()
            annotate.set_enabled(True)
            try:
                fn(*args)
            finally:
                annotate.set_enabled(False)
            logs.append([dict(e) for e in annotate.events()])
        sync()
    after = _dispatch.counts()
    ops = [[e["op"] for e in log] for log in logs]
    if any(o != ops[0] for o in ops):
        raise RuntimeError("profile_step: the executions recorded different "
                           "op sequences; the pp labels would not line up")
    tmp = trace_dir or tempfile.mkdtemp(prefix="apex_tpu_torch_pyprof_")
    path = os.path.join(tmp, "trace.json")
    try:
        prof.export_chrome_trace(path)
        joined = correlate(load_trace(path))
    finally:
        if trace_dir is None:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
            tmp = None
    rows = merge_measurements(enrich(logs[-1], with_backward=with_backward),
                              joined["per_seq"], executions=executions)
    report = {
        "trace_dir": tmp,
        "basis": joined["basis"],
        "items": joined["items"],
        "matched_seqs": len(joined["per_seq"]),
        "total_ns": joined["total_ns"],
        "matched_ns": joined["matched_ns"],
        "unattributed_ns": joined["unattributed_ns"],
        "matched_us": round(joined["matched_ns"] / 1e3, 3),
        "unattributed_us": round(joined["unattributed_ns"] / 1e3, 3),
        "unattributed_by": {
            k: round(v / 1e3, 3)
            for k, v in sorted(joined["unattributed_by"].items(),
                               key=lambda kv: -kv[1])},
        "kernel_names": joined["kernel_names"],
        "dropped_launches": joined["dropped_launches"],
        "dropped_by": joined["dropped_by"],
        "launch_counts": {k: after[k] - before.get(k, 0) for k in after
                          if after[k] != before.get(k, 0)},
        "executions": executions,
    }
    return rows, report
