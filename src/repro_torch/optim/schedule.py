"""LR schedules (port of the JAX package's ``optim/schedule.py``). The
paper uses the Vaswani rsqrt schedule for Adam runs and linear-warmup +
rsqrt-normalized-decay with a 0.01 constant for PG-19. A schedule maps the
(host-side, integer) step to a Python float, computed in fp32 as the JAX
package computes it."""
from __future__ import annotations

import numpy as np


def make_schedule(tc, d_model: int = 512):
    f32 = np.float32
    w = f32(max(tc.warmup_steps, 1))

    def vaswani(step: int) -> float:
        t = f32(max(step, 1))
        return float(f32(d_model ** -0.5)
                     * min(t ** f32(-0.5), t * w ** f32(-1.5)))

    def linear_warmup_rsqrt(step: int) -> float:
        t = f32(max(step, 1))
        warm = min(f32(1.0), t / w)
        # rsqrt_normalized_decay: flat through warmup then ~1/sqrt(t/w)
        decay = np.sqrt(w / max(t, w))
        return float(f32(tc.lr) * warm * decay)

    def const(step: int) -> float:
        t = f32(max(step, 1))
        return float(f32(tc.lr) * min(f32(1.0), t / w))

    if tc.schedule == "vaswani":
        return vaswani
    if tc.schedule == "linear_warmup_rsqrt":
        return linear_warmup_rsqrt
    if tc.schedule == "const":
        return const
    raise ValueError(f"unknown schedule {tc.schedule}")
