#!/usr/bin/env python3
"""Probes for capturing the port's train step as a CUDA graph, and for
ROADMAP C6 (the BERT step that was not reproducible on the card).

    PYTHONPATH=. python3 tools/graph_probe.py [graph] [c6] [c6full] [trace]
        [dot]

``graph``: which of torch's graph-safe generator calls this torch has;
whether a generator registered with a graph, re-seeded on the host before
each replay, draws what a fresh generator with that seed draws eagerly;
whether ``get_state`` works under capture, and whether a cloned state,
registered and swapped in with ``graphsafe_set_state``, replays a draw;
and whether the flash (``tc``), LayerNorm (its column sums launched as a
programmatic dependent), xentropy and Adam kernels give the same bits
replayed as launched.

``c6``: the gradients of the 2-layer BERT-base step (64 x 128, bf16,
attention dropout 0.1) four times from one state: twice as they come,
then after the caching allocator's free memory was filled with random
values, then with NaN; each tensor that differs from the first run is
named with its largest difference.  Then the same under
``torch.use_deterministic_algorithms(True, warn_only=True)``, printing
the operations torch names as nondeterministic.  ``c6full`` does the same
at 12 layers.  ``trace``: the BERT-base FusedLAMB step (64 x 128, bf16)
through the executor: its wrappers' counts in call 1 (eager) and call 2
(the capture); then three replays and three eager calls of
``_raw_step_fn`` under ``torch.profiler``, each with the hand-written
kernels counted by name (``chip_smoke.KERNEL_COUNTERS``), its device
operations, and where the replay's sequence of kernels departs from the
eager one's.  ``dot``: the kernel nodes of two LayerNorm forwards
captured by the executor and of the BERT-base step's graph (FusedLAMB
and FusedNovoGrad), read back by ``runtime.executor.graph_dot``, the
hand-written kernels counted by name against the wrappers' counts of the
eager call.  Prints one JSON line a probe.
"""
import json
import sys
import time
import warnings

import chip_smoke as cs


def env(torch):
    g = torch.Generator(device="cuda")
    return dict(torch=torch.__version__, cuda=torch.version.cuda,
                python=sys.version.split()[0], card=cs.card_line(),
                register_generator_state=hasattr(torch.cuda.CUDAGraph,
                                                 "register_generator_state"),
                graphsafe=[a for a in ("graphsafe_get_state",
                                       "graphsafe_set_state", "clone_state")
                           if hasattr(g, a)])


def _draws(torch, g):
    seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=g, device="cuda",
                         dtype=torch.int32)
    r = torch.rand((1000, 37), generator=g, device="cuda")
    return seed, r


def graph_generators(torch):
    out = {}
    g = torch.Generator(device="cuda")
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        g.manual_seed(5)
        _draws(torch, g)                     # warm-up
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    g.manual_seed(5)
    with torch.cuda.graph(graph):
        st_seed, st_r = _draws(torch, g)
    same = []
    for seed in (11, 12, 11):
        g.manual_seed(seed)
        graph.replay()
        fresh = torch.Generator(device="cuda").manual_seed(seed)
        e_seed, e_r = _draws(torch, fresh)
        same.append(bool(torch.equal(st_seed, e_seed)
                         and torch.equal(st_r, e_r)))
    out["reseeded_replay_equals_eager"] = same
    # get_state under capture
    graph2 = torch.cuda.CUDAGraph()
    graph2.register_generator_state(g)
    try:
        with torch.cuda.graph(graph2):
            g.get_state()
        out["get_state_under_capture"] = "ok"
    except Exception as e:                   # noqa: BLE001
        out["get_state_under_capture"] = f"{type(e).__name__}: {e}"[:300]
    del graph2
    # a rewind under capture through a cloned, registered state
    try:
        g.manual_seed(3)
        graph3 = torch.cuda.CUDAGraph()
        graph3.register_generator_state(g)
        with torch.cuda.graph(graph3):
            twin = g.clone_state()
            graph3.register_generator_state(twin)
            a = torch.rand(4096, generator=g, device="cuda")
            after = g.graphsafe_get_state()
            g.graphsafe_set_state(twin)
            b = torch.rand(4096, generator=g, device="cuda")
            g.graphsafe_set_state(after)
            c = torch.rand(4096, generator=g, device="cuda")
        res = []
        for seed in (21, 22):
            g.manual_seed(seed)
            twin.manual_seed(seed)
            graph3.replay()
            fresh = torch.Generator(device="cuda").manual_seed(seed)
            ea = torch.rand(4096, generator=fresh, device="cuda")
            ec = torch.rand(4096, generator=fresh, device="cuda")
            res.append(dict(a=bool(torch.equal(a, ea)),
                            b_is_a=bool(torch.equal(b, ea)),
                            c=bool(torch.equal(c, ec))))
        out["twin_rewind"] = res
    except Exception as e:                   # noqa: BLE001
        out["twin_rewind"] = f"{type(e).__name__}: {e}"[:300]
    return out


def graph_kernels(torch):
    """Each kernel's wrapper in a captured graph against the same call
    launched eagerly, on the same inputs."""
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.contrib.multihead_attn.attn_funcs import \
        flash_attention
    from apex_tpu_torch.kernels import dispatch, multi_tensor
    from apex_tpu_torch.normalization import FusedLayerNorm
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bf = torch.bfloat16
    q, k, v = (torch.randn(8, 12, 128, 64, generator=gen, device="cuda",
                           dtype=bf).requires_grad_() for _ in range(3))
    ln = FusedLayerNorm(768, device="cuda", dtype=bf)
    x = torch.randn(1280, 768, generator=gen, device="cuda",
                    dtype=bf).requires_grad_()
    logits = torch.randn(1280, 30522, generator=gen, device="cuda",
                         dtype=bf).requires_grad_()
    labels = torch.randint(0, 30522, (1280,), generator=gen, device="cuda")
    ps = [torch.randn(n, generator=gen, device="cuda") for n in
          (4096, 768 * 3, 1 << 20)]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    gs = [torch.randn(p.shape, generator=gen, device="cuda", dtype=bf)
          for p in ps]
    flag = torch.zeros((), dtype=torch.int32, device="cuda")
    stepc = torch.ones((), dtype=torch.int32, device="cuda")
    start = [t.clone() for t in ps + ms + vs]

    def body():
        out = flash_attention(q, k, v, causal=True, dropout_p=0.1,
                              dropout_seed=torch.full((), 7,
                                                      dtype=torch.int32,
                                                      device="cuda"))
        y = ln(x)
        loss = softmax_cross_entropy_loss(logits, labels, 0.0, -1,
                                          True).float().mean()
        gr = torch.autograd.grad(
            (out.float().square().mean() + y.float().square().mean()
             + loss), (q, k, v, x, logits, ln.weight, ln.bias))
        multi_tensor.fused_adam(flag, [gs, ps, ms, vs], 1e-3, 0.9, 0.999,
                                1e-8, stepc, 1, True, 0.01)
        return [out.detach(), y.detach(), *gr]

    def reset():
        for t, s0 in zip(ps + ms + vs, start):
            t.copy_(s0)
    reset()
    eager = [t.clone() for t in body()] + [t.clone() for t in ps + ms + vs]
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        reset()
        body()
    torch.cuda.current_stream().wait_stream(s)
    reset()
    graph = torch.cuda.CUDAGraph()
    before = dispatch.counts()
    err = None
    try:
        with torch.cuda.graph(graph):
            static = body()
    except Exception as e:                   # noqa: BLE001
        err = f"{type(e).__name__}: {e}"[:400]
    if err:
        return dict(capture=err)
    delta = {k: v - before.get(k, 0) for k, v in dispatch.counts().items()
             if v != before.get(k, 0)}
    reset()
    graph.replay()
    torch.cuda.synchronize()
    got = [t.clone() for t in static] + [t.clone() for t in ps + ms + vs]
    names = ["out", "y", "dq", "dk", "dv", "dx", "dlogits", "dw", "db"] + \
        [f"state{i}" for i in range(9)]
    diff = {n: float((a.float() - b.float()).abs().max())
            for n, a, b in zip(names, got, eager) if not torch.equal(a, b)}
    return dict(capture="ok", launches_in_capture=delta,
                replay_differs_from_eager=diff)


def _bert_grads(torch, model, batch, loss_fn, seed):
    from torch.func import functional_call
    from apex_tpu_torch.training.step import dropout_seed
    names = [n for n, _ in model.named_parameters()]
    leaves = [p.detach().to(torch.bfloat16).requires_grad_()
              for p in model.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(dropout_seed(0, seed))
    (ids, pos), labels = batch
    out = functional_call(model, dict(zip(names, leaves)), ((ids, pos),),
                          dict(generator=gen))
    loss = loss_fn(out, labels)
    grads = torch.autograd.grad(loss.float(), leaves)
    return names, [g.detach().clone() for g in grads]


def _fill_free(torch, value):
    """Take most of the free device memory into tensors of ``value`` (a
    number, or None for random normals) and free them: the caching
    allocator keeps the blocks, so later tensors may start with these
    contents."""
    free, _ = torch.cuda.mem_get_info()
    held = []
    left = int(free * 0.8)
    while left > 1 << 28:
        n = min(left, 1 << 30) // 4
        t = torch.empty(n, device="cuda")
        if value is None:
            t.normal_()
        else:
            t.fill_(value)
        held.append(t)
        left -= n * 4
    del held


def c6(torch, layers):
    from apex_tpu_torch.models import bert
    torch.manual_seed(cs.SEED)
    model = bert.bert_base(layers=layers, max_positions=cs.BERT_SEQ,
                           attn_dropout=cs.DROP_P, device="cuda")
    batch = cs._bert_batch(torch, cs.BERT_BATCH, cs.BERT_SEQ, "cuda")
    loss_fn = cs._bert_mlm_loss(torch)
    out = {}
    names, first = _bert_grads(torch, model, batch, loss_fn, 0)
    for tag, fill in (("again", False), ("after_random_fill", None),
                      ("after_nan_fill", float("nan")), ("again2", False)):
        if fill is not False:
            _fill_free(torch, fill)
        _, got = _bert_grads(torch, model, batch, loss_fn, 0)
        out[tag] = {n: float((a.float() - b.float()).abs().max())
                    for n, a, b in zip(names, got, first)
                    if not torch.equal(a, b)}
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, det1 = _bert_grads(torch, model, batch, loss_fn, 0)
        _fill_free(torch, None)
        _, det2 = _bert_grads(torch, model, batch, loss_fn, 0)
    torch.use_deterministic_algorithms(False)
    out["deterministic_warnings"] = sorted({str(w.message)[:200]
                                            for w in caught})
    out["deterministic_twice"] = {n: float((a.float() - b.float()).abs().max())
                                  for n, a, b in zip(names, det2, det1)
                                  if not torch.equal(a, b)}
    out["deterministic_vs_first"] = {
        n: float((a.float() - b.float()).abs().max())
        for n, a, b in zip(names, det1, first) if not torch.equal(a, b)}
    out["names_in_order"] = names[:8] + ["..."] + names[-6:]
    return out


def _device_sequence(torch, fn, activities):
    """The names of the device operations of ``fn()`` in the order of
    their start, as torch.profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    return [n for _, n in spans]


def _symbols(names):
    out = []
    for n in names:
        m = cs._KERNEL_NAME.search(n)
        out.append(m.group(1) if m else n[:48])
    return out


def trace(torch):
    import difflib
    from torch.profiler import ProfilerActivity
    from apex_tpu_torch.kernels import dispatch
    from apex_tpu_torch.models import bert
    from apex_tpu_torch.optimizers import FusedLAMB
    step = cs._bert_step(torch, bert, FusedLAMB, 0.0)
    x, labels = cs._bert_batch(torch, cs.BERT_BATCH, cs.BERT_SEQ, "cuda")
    out = {}
    for i in range(2):
        torch.cuda.synchronize()
        dispatch.reset_counts()
        step(x, labels)
        torch.cuda.synchronize()
        out[f"call{i + 1}_wrappers"] = cs._nonzero(dispatch.counts())
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    arms = {"replay": lambda: step(x, labels),
            "eager": lambda: step._raw_step_fn(step.state, 9, x, labels)}
    seqs = {}
    for arm, fn in arms.items():
        for acts, tag in ((both, "cpu+cuda"), ([ProfilerActivity.CUDA],
                                               "cuda")):
            for k in range(3):
                seq = _symbols(_device_sequence(torch, fn, acts))
                seqs.setdefault(arm, seq)
                out.setdefault(f"{arm} {tag}", []).append(dict(
                    ops=len(seq),
                    ln_fwd=sum(s.startswith("ln_fwd") for s in seq),
                    ln_bwd=sum(s.startswith("ln_bwd_") and "cols" not in s
                               for s in seq),
                    hand=sum(s in cs.KERNEL_COUNTERS for s in seq)))
    a, b = seqs["eager"], seqs["replay"]
    diffs = []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if op != "equal":
            diffs.append(dict(op=op, eager=[i1, a[max(0, i1 - 2):i2 + 2]],
                              replay=[j1, b[max(0, j1 - 2):j2 + 2]]))
    out["first_ops"] = dict(eager=a[:6], replay=b[:6])
    out["diffs"] = diffs[:30]
    return out


def dot(torch):
    import re
    from apex_tpu_torch.kernels import dispatch, layer_norm
    from apex_tpu_torch.models import bert
    from apex_tpu_torch.optimizers import FusedLAMB, FusedNovoGrad
    from apex_tpu_torch.runtime import executor
    out = {}
    x = torch.randn(64, 768, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(768, device="cuda", dtype=torch.bfloat16)
    prog = executor.Program("probe", ("ln",), lambda x: (
        layer_norm.ln_forward(x, w, w, 1e-5),
        layer_norm.ln_forward(x, None, None, 1e-5)))
    for _ in range(3):
        executor.executor.submit(prog, (x,))
    texts = executor.graph_dot(prog)
    text = texts[0]
    i = text.find("ln_fwd")
    out["ln_forward_x2"] = dict(
        counts=cs._nonzero(cs._dot_kernel_counts(texts, dispatch.counts())),
        nodes=len(cs._DOT_NODE.findall(text)), bytes=len(text),
        head=text[:300], around=text[max(0, i - 700):i + 300])
    bx, labels = cs._bert_batch(torch, cs.BERT_BATCH, cs.BERT_SEQ, "cuda")
    for cls in (FusedLAMB, FusedNovoGrad):
        step = cs._bert_step(torch, bert, cls)
        torch.cuda.synchronize()
        dispatch.reset_counts()
        step(bx, labels)
        torch.cuda.synchronize()
        eager = cs._nonzero(dispatch.counts())
        step(bx, labels)
        step(bx, labels)
        texts = executor.graph_dot(step._program)
        got = cs._nonzero(cs._dot_kernel_counts(texts, dispatch.counts()))
        out[cls.__name__] = dict(
            eager=eager, graph=got, equal=got == eager,
            nodes=[len(cs._DOT_NODE.findall(t)) for t in texts],
            kernel_words=len(re.findall(r"KERNEL", texts[0])),
            bytes=[len(t) for t in texts])
        del step
        torch.cuda.empty_cache()
    return out


def main(args):
    import torch
    if not torch.cuda.is_available():
        print("graph_probe: no CUDA device", file=sys.stderr)
        return 1
    from apex_tpu_torch import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(json.dumps(dict(env=env(torch), build=_build.build_all(),
                          build_s=time.perf_counter() - t0)), flush=True)
    if "graph" in args:
        for fn in (graph_generators, graph_kernels):
            try:
                r = fn(torch)
            except Exception as e:           # noqa: BLE001
                r = f"{type(e).__name__}: {e}"[:400]
            print(json.dumps({fn.__name__: r}), flush=True)
    if "dot" in args:
        t0 = time.perf_counter()
        try:
            r = dot(torch)
        except Exception as e:               # noqa: BLE001
            r = f"{type(e).__name__}: {e}"[:600]
        print(json.dumps({"dot": r, "s": time.perf_counter() - t0}),
              flush=True)
    if "trace" in args:
        t0 = time.perf_counter()
        print(json.dumps({"trace": trace(torch),
                          "s": time.perf_counter() - t0}), flush=True)
    for tag, layers in (("c6", 2), ("c6full", 12)):
        if tag in args:
            t0 = time.perf_counter()
            r = c6(torch, layers)
            print(json.dumps({tag: r, "s": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
