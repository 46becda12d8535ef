"""LR schedules: cosine (default) and WSD (warmup-stable-decay, MiniCPM)
— the port of the reference's ``optim/schedule.py``.

Pure functions of the step counter, computed in float32 as the
reference computes them: ``lr(step)`` takes a Python int or a tensor
(an ``OptState.step`` on the card stays there, so reading the rate
never waits for the device) and returns a 0-dim float32 tensor.
"""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    def lr(step):
        step = _step_f32(step)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, min_ratio: float = 0.01):
    """Warmup -> Stable (constant) -> Decay (last ``decay_frac`` of steps).

    MiniCPM's schedule (arXiv:2404.06395): exponential-ish decay tail
    approximated by the published 'sqrt-linear' ramp.
    """
    decay_start = int(total * (1 - decay_frac))

    def lr(step):
        step = _step_f32(step)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                        0, 1)
        decay = base_lr * torch.pow(min_ratio, t)
        stable = torch.full_like(step, base_lr)
        return torch.where(step < warmup, warm,
                           torch.where(step < decay_start, stable, decay))
    return lr


def get_schedule(name: str, base_lr: float, warmup: int, total: int):
    if name == "wsd":
        return wsd_schedule(base_lr, warmup, total)
    return cosine_schedule(base_lr, warmup, total)
