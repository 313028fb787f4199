"""How far a wrong kernel moves the two losses of chip_smoke.py's rollout
check (e).

``rollout_phase`` holds the card's first two train-step losses against an
fp32 recompute of both steps on the CPU: the first relative to the loss,
the second as a share of how far the first step moved it (the second
batch's loss at the seed's weights beside it).  This script reads those
two numbers for deliberately wrong kernels on the same data.  GPT-2
small's serve engine (fp32, the seed's weights, serve_phase's pool
geometry) runs one rollout round as ``rollout_phase`` does, and the round's
first two train batches are kept.  Then fresh trainers from the seed (bf16
half copies over fp32 masters, FusedAdam, the chunked loss, as
``rollout_phase``'s) each take two steps on those batches: the sound
kernels, and each fault below on its own, made by wrapping one kernel
wrapper so that its result is wrong.  Adam's first update is nearly
lr * sign(g), so a fault that scales every gradient alike moves nothing:
the faults change directions or drop parts.

    PYTHONPATH=. python3 tools/rollout_loss_controls.py   (one card)

Prints one line a trainer and, last, one JSON object of the readings.
"""
import json
import sys

import numpy as np
import torch


def faults():
    """(name, module, attribute, wrap): ``wrap(original)`` is the wrong
    wrapper put in the attribute's place while that trainer runs."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.kernels import attention, layer_norm, xentropy

    def non_causal(f):
        return lambda q, k, v, bias, scale, causal, *a: f(
            q, k, v, bias, scale, False, *a)

    def dq_unwritten(f):
        def g(*a):
            dq, dk, dv = f(*a)
            return torch.zeros_like(dq), dk, dv
        return g

    def no_bias(f):
        return lambda x, w, b, eps: f(x, w, torch.zeros_like(b), eps)

    def sums_unwritten(f):
        def g(*a):
            dx, dw, db = f(*a)
            return dx, torch.zeros_like(dw), torch.zeros_like(db)
        return g

    def labels_late(f):
        return lambda x, lab, *a: f(x, lab.roll(1), *a)

    def no_target(f):
        # an out-of-range label: the softmax alone, without the target's -1
        return lambda x, lab, *a: f(x, torch.full_like(lab, x.shape[1] + 5),
                                    *a)

    def skips_last(f):
        return lambda flag, lists, *a, **kw: f(
            flag, [lst[:-1] for lst in lists], *a, **kw)

    return [
        ("B1 flash forward without the causal mask", attention, "flash_fwd",
         non_causal),
        ("B2 flash backward, dq not written", attention, "flash_bwd",
         dq_unwritten),
        ("B3 LayerNorm forward without its bias", layer_norm, "ln_forward",
         no_bias),
        ("B4 LayerNorm backward, dgamma and dbeta not written", layer_norm,
         "_backward", sums_unwritten),
        ("B7 xentropy forward, each row's label read one row late",
         xentropy, "xent_forward", labels_late),
        ("B8 xentropy backward without the target's -1", xentropy,
         "xent_backward", no_target),
        ("B12 Adam skips the last tensor", ops, "multi_tensor_adam",
         skips_last),
    ]


def trainer(c, gpt):
    """A fresh rollout trainer from the seed, as rollout_phase builds it."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.training import make_train_step
    torch.manual_seed(c.SEED)
    m = gpt.gpt2_small(max_positions=c.TRAIN_POS, dropout=0.0,
                       attn_dropout=0.0, device="cuda")
    m.output_hidden = True
    return make_train_step(
        m, FusedAdam(list(m.parameters()), lr=c.LR, weight_decay=c.WD),
        c._chunked_lm_loss(), half_dtype=torch.bfloat16, loss_scale=1.0)


def two_losses(c, gpt, batches):
    step = trainer(c, gpt)
    return [float(step(x, x)) for x in batches]


def main():
    if not torch.cuda.is_available():
        print("rollout_loss_controls: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from apex_tpu_torch import _build, rollout
    from apex_tpu_torch import serve
    from apex_tpu_torch.models import gpt
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    torch.manual_seed(c.SEED)
    model = gpt.gpt2_small(max_positions=c.TRAIN_POS, dropout=0.0,
                           attn_dropout=0.0, device="cuda").eval()
    eng = serve.ServeEngine(model, num_blocks=c.SERVE_BLOCKS,
                            block_size=c.SERVE_BLOCK,
                            max_batch=c.SERVE_BATCH,
                            prefill_chunk=c.SERVE_CHUNK)
    rt = rollout.RolloutRuntime(
        eng, trainer(c, gpt), capacity=c.ROLL_CAPACITY,
        max_staleness=c.ROLL_STALENESS, prompt_len=c.ROLL_PROMPT,
        max_new_tokens=c.ROLL_NEW, rollouts_per_round=c.ROLL_PROMPTS,
        train_batch=c.ROLL_BATCH, train_steps_per_round=c.ROLL_STEPS,
        seq_len=c.ROLL_SEQ, publish_every=1, seed=c.SEED)
    default_batch, batches = rt.batch_fn, []

    def batch_fn(xs, w):
        batches.append(torch.as_tensor(np.asarray(xs), dtype=torch.long,
                                       device="cuda"))
        return default_batch(xs, w)
    rt.batch_fn = batch_fn
    rt.run_round()
    eng.close()
    batches = batches[:2]
    print(f"{c.card_line()}; the round's losses {rt.losses}")
    # the second batch's loss at the seed's weights: a fresh trainer's
    # first call reports the loss before its update
    held = float(trainer(c, gpt)(batches[1], batches[1]))
    sound = two_losses(c, gpt, batches)
    again = two_losses(c, gpt, batches)
    moved = sound[1] - held
    rows = [dict(name="sound", losses=sound),
            dict(name="sound, a second trainer", losses=again)]
    for name, mod, attr, wrap in faults():
        orig = getattr(mod, attr)
        setattr(mod, attr, wrap(orig))
        try:
            rows.append(dict(name=name, losses=two_losses(c, gpt, batches)))
        finally:
            setattr(mod, attr, orig)
    print(f"second batch at the seed's weights {held:.6f}; the sound step "
          f"moved it by {moved:.6f}")
    for r in rows:
        r["first_rel"] = abs(r["losses"][0] - sound[0]) / abs(sound[0])
        r["second_share"] = abs(r["losses"][1] - sound[1]) / abs(moved)
        print(f"  {r['name']}: losses {r['losses'][0]:.6f}, "
              f"{r['losses'][1]:.6f}; first {r['first_rel']:.3e} of the "
              f"sound loss, second {r['second_share']:.3e} of the sound "
              f"step's move")
    print(json.dumps(dict(card=c.card_line(), round_losses=rt.losses,
                          held=held, moved=moved, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
