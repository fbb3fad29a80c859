"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step."""
from __future__ import annotations

import math


def cosine_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1) -> float:
    """Linear warm-up to ``peak_lr``, then a cosine decay to ``floor *
    peak_lr`` at ``total``; the reference's float32 arithmetic in Python
    floats (the step is a host integer here)."""
    s = float(step)
    if s < warmup:
        return peak_lr * min(s / max(warmup, 1), 1.0)
    t = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))
