"""Learning-rate schedules (the port of ``repro/optim/schedules.py``).

Each returns ``fn(step) -> float32 scalar tensor``.  Includes the paper's
exponentially decayed rate η(k) = η₀·δᵏ (§6, η₀ = 0.1, δ = 0.95 per round;
the trainer's ``eta0``, ``eta_decay`` and ``eta_decay_every``) and
MiniCPM's WSD (Warmup-Stable-Decay) schedule [arXiv:2404.06395] used by
the minicpm-2b assigned architecture.
"""
from __future__ import annotations

import math

import torch

f32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=f32)


def constant(eta0: float):
    return lambda step: _f32(eta0)


def exponential(eta0: float, delta: float = 0.95, decay_every: int = 1):
    """The paper's η(k) = η₀ · δ^⌊k / decay_every⌋."""
    def fn(step):
        return _f32(eta0) * _f32(delta) ** (step // decay_every)
    return fn


def cosine(eta0: float, total_steps: int, warmup: int = 0,
           eta_min: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = eta0 * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0, 1)
        cos = eta_min + 0.5 * (eta0 - eta_min) * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos).to(f32)
    return fn


def wsd(eta0: float, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, eta_min_frac: float = 0.1):
    """Warmup-Stable-Decay (MiniCPM): linear warmup → flat → exponential
    decay to ``eta_min_frac``·η₀."""
    warmup = max(1, int(warmup_frac * total_steps))
    decay_start = int(total_steps * (1 - decay_frac))
    eta_min = eta0 * eta_min_frac

    def fn(step):
        step = _f32(step)
        warm = eta0 * step / warmup
        stable = _f32(eta0)
        prog = torch.clamp((step - decay_start)
                           / max(total_steps - decay_start, 1), 0, 1)
        decay = eta0 * (eta_min / eta0) ** prog
        out = torch.where(step < warmup, warm,
                          torch.where(step < decay_start, stable, decay))
        return out.to(f32)
    return fn
