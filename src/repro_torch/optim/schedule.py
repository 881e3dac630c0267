"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(
    step,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_fraction: float = 0.1,
) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``final_fraction``
    of it; a 0-d f32 tensor on ``step``'s device (a host int goes to the CPU).

    Computed in f32 from the step as a tensor, operation for operation as the
    reference's jnp expression: Python floats are f64 and would round
    elsewhere. Python constants meet the f32 tensor as weak scalars, as in JAX.
    """
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    progress = torch.clamp(
        (s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
    )
    cos = peak_lr * (
        final_fraction + (1 - final_fraction) * 0.5 * (1 + torch.cos(math.pi * progress))
    )
    return torch.where(s < warmup_steps, warm, cos)
