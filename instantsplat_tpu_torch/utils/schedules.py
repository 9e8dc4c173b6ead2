"""Learning-rate schedules (port of instantsplat_tpu/utils/schedules.py,
`expon_lr` only — the one stage 2 uses)."""

from __future__ import annotations

import math

import torch


def expon_lr(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-linear lr interpolation with optional delayed start.

    Returns step -> float32 0-dim tensor. Evaluated in float32 like the JAX
    version, so both packages see the same learning rates. Returns 0 when
    step < 0 or both endpoints are 0.
    """

    def helper(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(step)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        f32 = dict(dtype=torch.float32)
        log_lerp = torch.exp(torch.log(torch.tensor(lr_init, **f32)) * (1 - t)
                             + torch.log(torch.tensor(lr_final, **f32)) * t)
        lr = delay_rate * log_lerp
        return torch.where(step < 0, torch.zeros_like(lr), lr)

    return helper
