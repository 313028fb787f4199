"""The weight publish's copy, two bodies side by side: one ``copy_`` a leaf
(124 copies in one CUDA graph) and one ``torch._foreach_copy_`` over the
lists, each captured as a CUDA graph over GPT-2 small's 124 fp32 masters
and fp32 serve parameters (497.6 MB), as ``rollout.WeightPublisher``'s
``weight_publish`` program runs on the card; then the same with bf16
serve parameters (the copy casts).  Each graph's replays are timed
between CUDA events in turns (A B B A, repeated), beside the bound: the
bytes read and written once over the card's memory rate.

    PYTHONPATH=. python3 tools/publish_copy_ab.py [TURNS]
"""
import statistics
import sys

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
REPLAYS = 10


def per_leaf(masters, targets):
    for t, m in zip(targets, masters):
        t.copy_(m)


def foreach(masters, targets):
    torch._foreach_copy_(targets, masters)


def graph(body, masters, targets):
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s), torch.no_grad():
        body(masters, targets)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g), torch.no_grad():
        body(masters, targets)
    return g


def replay_ms(g):
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(REPLAYS):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPLAYS


def main():
    turns = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    if not torch.cuda.is_available():
        print("publish_copy_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from apex_tpu_torch.models import gpt
    torch.manual_seed(c.SEED)
    m = gpt.gpt2_small(max_positions=c.TRAIN_POS, dropout=0.0,
                       attn_dropout=0.0, device="cuda")
    masters = [p.detach().clone() for p in m.parameters()]
    print(f"{c.card_line()}; {torch.__version__}; {len(masters)} leaves")
    for dtype in (torch.float32, torch.bfloat16):
        targets = [torch.empty_like(p, dtype=dtype) for p in masters]
        nbytes = sum(p.numel() * (p.element_size() + dtype.itemsize)
                     for p in masters)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        graphs = {name: graph(body, masters, targets)
                  for name, body in (("copy_ a leaf", per_leaf),
                                     ("_foreach_copy_", foreach))}
        for body in (per_leaf, foreach):
            for t in targets:
                t.zero_()
            graphs["copy_ a leaf" if body is per_leaf
                   else "_foreach_copy_"].replay()
            torch.cuda.synchronize()
            if not all(torch.equal(t, p.to(dtype))
                       for t, p in zip(targets, masters)):
                raise AssertionError(f"{body.__name__}: the copy differs")
        times = {name: [] for name in graphs}
        order = list(graphs)
        for _ in range(turns):
            for name in order + order[::-1]:
                times[name].append(replay_ms(graphs[name]))
        line = "; ".join(
            f"{name} {statistics.median(ts):.4f} ms (min {min(ts):.4f}, "
            f"{bound / statistics.median(ts):.0%} of the bound)"
            for name, ts in times.items())
        print(f"fp32 masters into {str(dtype)[6:]} targets, {nbytes} bytes "
              f"moved, bound {bound:.4f} ms: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
