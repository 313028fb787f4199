"""How far a wrong kernel moves chip_smoke.py's tp/sp arms' readings, and
what the sound arms read.

``tp_sp_phase`` holds each tensor- or sequence-parallel arm of GPT-2
small's train step (bf16 half copies, FusedAdam, ZERO_BATCH x TRAIN_SEQ,
zero_phase's ZERO_STEPS batches) against zero_phase's plain step from the
same weights: bit for bit where the arithmetic is the same, else within
``TP_SP_TOL`` on two
readings, the largest relative loss difference and the masters' distance
over the plain step's move of them (``chip_smoke._arm_distance``).  This
script takes both readings for the plain step with one kernel wrapper made
wrong at a time (``tools/rollout_loss_controls.py``'s faults) and for each
sound arm of ``TP_SP_ARMS`` over NCCL at world size 1, so that the limits
sit between what the sound arms read and what the least of the faults
reads.

    PYTHONPATH=. python3 tools/tp_sp_controls.py   (one card)

Prints one line a run and, last, one JSON object of the readings.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    if not torch.cuda.is_available():
        print("tp_sp_controls: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from rollout_loss_controls import faults
    from torch.distributed.device_mesh import init_device_mesh
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import use_mesh, vocab_parallel_cross_entropy
    from apex_tpu_torch.training import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    torch.manual_seed(c.SEED)
    plain = gpt.gpt2_small(max_positions=c.TRAIN_POS, dropout=0.0,
                           attn_dropout=0.0, output_hidden=True,
                           device="cuda")
    weights = {k: t.detach().clone() for k, t in plain.state_dict().items()}
    # zero_phase's batches
    g = torch.Generator(device="cuda").manual_seed(c.SEED + 21)
    batches = [(ids, ids) for ids in (
        torch.randint(0, 50257, (c.ZERO_BATCH, c.TRAIN_SEQ), generator=g,
                      device="cuda") for _ in range(c.ZERO_STEPS))]

    def vocab_loss(logits, ids):
        return vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:],
                                            "model")

    def run(model, loss="chunked", **kw):
        step = make_train_step(
            model, FusedAdam(list(model.parameters()), lr=c.LR,
                             weight_decay=c.WD),
            vocab_loss if loss == "vocab" else c._chunked_lm_loss(),
            half_dtype=torch.bfloat16, loss_scale=1.0, **kw)
        losses = [[float(step(*b))] for b in batches]
        return dict(losses=losses,
                    masters=[m.clone() for m in step.state.master_params])
    sound = run(plain)
    sound["init"] = [weights[n].float() for n, _ in plain.named_parameters()]
    rows = []

    def reading(name, r):
        loss_rel, master_rel = c._arm_distance(torch, r["losses"],
                                               r["masters"], sound)
        rows.append(dict(name=name, loss_rel=loss_rel,
                         master_rel=master_rel, losses=r["losses"]))
        print(f"  {name}: loss {loss_rel:.3e}, masters {master_rel:.3e}; "
              f"losses {r['losses']}")
    reading("sound, a second step", run(plain))
    for name, mod, attr, wrap in faults():
        orig = getattr(mod, attr)
        setattr(mod, attr, wrap(orig))
        try:
            reading(name, run(plain))
        finally:
            setattr(mod, attr, orig)
    with c.nccl_world(torch):
        mesh = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("data", "seq", "model"))
        with use_mesh(mesh):
            for arm, model_kw, step_kw, loss in c.TP_SP_ARMS:
                model = gpt.gpt2_small(max_positions=c.TRAIN_POS,
                                       dropout=0.0, attn_dropout=0.0,
                                       device="cuda", **model_kw)
                model.load_state_dict(weights)
                reading(f"arm {arm}", run(model, loss, **step_kw))
                del model
    print(json.dumps(dict(card=c.card_line(), sound=sound["losses"],
                          rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
