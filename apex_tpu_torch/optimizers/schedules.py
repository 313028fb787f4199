"""Learning-rate schedules for the fused train step, the PyTorch
counterpart of ``apex_tpu/optimizers/schedules.py``.

Each factory returns ``schedule(step) -> multiplier`` on the optimizer
groups' base lr.  ``make_train_step(lr_schedule=...)`` calls it with the
1-based step count as an int32 device scalar, so the lr changes every step
with no host round trip; a Python int gives a 0-dim fp32 CPU tensor (for
logging and plotting).  The arithmetic is fp32, in the JAX package's
order.
"""
from __future__ import annotations

import math

import torch


def _check_warmup(warmup_steps, total_steps):
    if not 0 < warmup_steps < total_steps:
        raise ValueError(
            f"need 0 < warmup_steps < total_steps, got "
            f"{warmup_steps}, {total_steps}")


def _as_f32(step):
    return torch.as_tensor(step).to(torch.float32)


def warmup_poly(warmup_steps: int, total_steps: int, power: float = 1.0,
                min_ratio: float = 0.0):
    """Linear warmup 0 -> 1 over ``warmup_steps``, then polynomial decay to
    ``min_ratio`` at ``total_steps`` (clamped past the end)."""
    _check_warmup(warmup_steps, total_steps)

    def schedule(step):
        s = _as_f32(step)
        warm = s / warmup_steps
        frac = torch.clamp((total_steps - s)
                           / float(total_steps - warmup_steps), 0.0, 1.0)
        decay = min_ratio + (1.0 - min_ratio) * frac ** power
        return torch.where(s < warmup_steps, warm, decay)

    return schedule


def warmup_linear(warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.0):
    """Linear warmup then linear decay (the BERT pretraining shape):
    ``warmup_poly`` with ``power=1``."""
    return warmup_poly(warmup_steps, total_steps, power=1.0,
                       min_ratio=min_ratio)


def warmup_cosine(warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.0):
    """Linear warmup then cosine decay to ``min_ratio`` (the GPT shape)."""
    _check_warmup(warmup_steps, total_steps)

    def schedule(step):
        s = _as_f32(step)
        warm = s / warmup_steps
        prog = torch.clamp((s - warmup_steps)
                           / float(total_steps - warmup_steps), 0.0, 1.0)
        decay = min_ratio + (1.0 - min_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, decay)

    return schedule


def step_decay(boundaries, factors):
    """Piecewise-constant multiplier: from ``boundaries[i]`` steps on it is
    ``factors[i]`` (1 before the first).  Boundaries must ascend."""
    boundaries = list(boundaries)
    if len(boundaries) != len(factors):
        raise ValueError("boundaries and factors must align")
    if boundaries != sorted(boundaries):
        raise ValueError(
            f"boundaries must be ascending, got {boundaries}")
    bs = torch.tensor(boundaries, dtype=torch.float32)
    fs = torch.tensor([1.0] + list(factors), dtype=torch.float32)
    # the tables on each device, copied once: a train step captured as a
    # CUDA graph cannot copy from the host inside the capture
    on = {}

    def schedule(step):
        s = _as_f32(step)
        if s.device not in on:
            on[s.device] = (bs.to(s.device), fs.to(s.device))
        b_dev, f_dev = on[s.device]
        idx = (s >= b_dev).sum()
        return f_dev[idx]

    return schedule
