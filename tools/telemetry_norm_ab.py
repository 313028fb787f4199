#!/usr/bin/env python3
"""The cost of the train step's on-device telemetry a replay, and the two
forms of its gradient norm, on one card.

    PYTHONPATH=. python3 tools/telemetry_norm_ab.py

GPT-2 small's step as ``chip_smoke.py``'s observe phase builds it (batch
16 x 1024, bf16 half copies, FusedAdam, the chunked loss, dropout 0), in
three arms captured as CUDA graphs through the executor: ``plain``
(telemetry off), ``foreach`` (telemetry on: the package's
``observe.telemetry.global_grad_norm``, ``torch._foreach_norm`` over the
gradients read in fp32, then the norm of the norms) and ``chain``
(telemetry on, with the norm taken as a chain of ``sum(g.float() *
g.float())`` a tensor, added one by one, then ``sqrt``: four small
launches a tensor).  Each arm's graph nodes (``executor.graph_dot``),
then its replay's ms on the host clock over 10 replays a turn, in the
turns plain, foreach, chain, chain, foreach, plain, and one replay
between CUDA events an arm.  Prints the card's name and power limit and
one JSON line.
"""
import json
import subprocess
import time


def chain_norm(torch):
    def global_grad_norm(grads):
        gsq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for g in grads:
            gf = g.float()
            gsq = gsq + torch.sum(gf * gf)
        return torch.sqrt(gsq)
    return global_grad_norm


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("telemetry_norm_ab: no CUDA device")
    import chip_smoke as c
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.observe import telemetry
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.runtime import executor
    from apex_tpu_torch.training import make_train_step
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.manual_seed(c.SEED)
    model = gpt.gpt2_small(max_positions=c.TRAIN_POS, dropout=0.0,
                           attn_dropout=0.0, device="cuda")
    model.output_hidden = True
    g = torch.Generator(device="cuda").manual_seed(c.SEED + 6)
    ids = torch.randint(0, model.vocab_size, (c.TRAIN_BATCH, c.TRAIN_SEQ),
                        generator=g, device="cuda")
    forms = {"foreach": telemetry.global_grad_norm,
             "chain": chain_norm(torch)}
    steps, nodes = {}, {}
    for arm in ("plain", "foreach", "chain"):
        step = make_train_step(
            model, FusedAdam(list(model.parameters()), lr=c.LR,
                             weight_decay=c.WD), c._chunked_lm_loss(),
            half_dtype=torch.bfloat16, loss_scale=1.0,
            telemetry=arm != "plain", drain_every=10 ** 6)
        # the norm's form is baked into the graph at the capture (call 2)
        telemetry.global_grad_norm = forms.get(arm, forms["foreach"])
        try:
            for _ in range(3):
                step(ids, ids)
            torch.cuda.synchronize()
        finally:
            telemetry.global_grad_norm = forms["foreach"]
        steps[arm] = step
        nodes[arm] = sum(len(c._DOT_NODE.findall(t))
                         for t in executor.graph_dot(step._program))
    norms = {arm: float(s.state.telem.grad_norm)
             for arm, s in steps.items() if arm != "plain"}
    turns = ("plain", "foreach", "chain", "chain", "foreach", "plain")
    ms = {arm: [] for arm in steps}
    for arm in turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            steps[arm](ids, ids)
        torch.cuda.synchronize()
        ms[arm].append(1e3 * (time.perf_counter() - t0) / 10)
    event_ms = {arm: c._event_ms(torch, lambda s=s: s(ids, ids))
                for arm, s in steps.items()}
    print(card)
    print(f"graph nodes {nodes}; replay ms (host clock, 10 replays a turn, "
          f"turns {'/'.join(turns)}) {ms}; one replay between CUDA events "
          f"{event_ms}; the last windows' norms {norms}")
    print(json.dumps(dict(card=card, graph_nodes=nodes, replay_ms=ms,
                          event_ms=event_ms, grad_norms=norms)))


if __name__ == "__main__":
    main()
