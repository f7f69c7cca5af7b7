"""Learning-rate schedules on a step tensor (float32 math, 0-d tensor out),
as the reference's ``optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def _quotient(step: torch.Tensor, n: int) -> torch.Tensor:
    """``step / n`` in float32, an IEEE quotient (a division by a Python
    number would be a multiply by its reciprocal)."""
    s = torch.as_tensor(step).to(torch.float32)
    return s / torch.tensor(float(n), dtype=torch.float32, device=s.device)


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1
                    ) -> torch.Tensor:
    frac = torch.clamp(_quotient(step, max(total_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return final_frac + (1.0 - final_frac) * cos


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = torch.clamp(_quotient(step, max(warmup, 1)), 0.0, 1.0)
    return warm * cosine_schedule(torch.clamp_min(step - warmup, 0),
                                  max(total_steps - warmup, 1), final_frac)
