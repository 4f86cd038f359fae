"""Schedule formulas (port of neurosis_tpu/schedulers/schedules.py; parity:
schedulers/*.py) as pure ``step -> value`` callables.

Host-side floats (exactly the reference math, numpy), so one both sets a
torch param group's lr and can be logged.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Optional

import numpy as np


def _ensure_list(x, n=1):
    return list(x) if isinstance(x, (list, tuple)) else [x] * n


def cosine_with_warmup(num_warmup_steps: int, num_training_steps: int, num_cycles: float = 0.5):
    """HF cosine schedule with warmup (hf.py:29-48); returns multiplier."""

    def f(step):
        step = float(step)
        if step < num_warmup_steps:
            return step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return f


def cosine_with_hard_restarts(num_warmup_steps: int, num_training_steps: int, num_cycles: int = 1):
    """HF hard-restarts cosine (hf.py:8-27)."""

    def f(step):
        step = float(step)
        if step < num_warmup_steps:
            return step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        if progress >= 1.0:
            return 0.0
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((num_cycles * progress) % 1.0))))

    return f


def lambda_warmup_cosine_scheduler2(
    warm_up_steps, f_min, f_max, f_start, cycle_lengths, **_
):
    """Interval-based warmup+cosine multiplier (linear.py:10-69)."""
    warm_up_steps = _ensure_list(warm_up_steps)
    n_stages = len(warm_up_steps)
    f_min = _ensure_list(f_min, n_stages)
    f_max = _ensure_list(f_max, n_stages)
    f_start = _ensure_list(f_start, n_stages)
    cycle_lengths = _ensure_list(cycle_lengths, n_stages)
    cum = np.cumsum([0] + list(cycle_lengths))

    def f(step):
        n = float(step)
        cycle = min(bisect_left(cum[1:], n), n_stages - 1)
        n = n - cum[cycle]
        if n < warm_up_steps[cycle]:
            return (f_max[cycle] - f_start[cycle]) / warm_up_steps[cycle] * n + f_start[cycle]
        t = min((n - warm_up_steps[cycle]) / (cycle_lengths[cycle] - warm_up_steps[cycle]), 1.0)
        return f_min[cycle] + 0.5 * (f_max[cycle] - f_min[cycle]) * (1 + math.cos(t * math.pi))

    return f


def lambda_linear_scheduler(warm_up_steps, f_min, f_max, f_start, cycle_lengths, **_):
    """Linear decay variant (linear.py:72-94)."""
    warm_up_steps = _ensure_list(warm_up_steps)
    n_stages = len(warm_up_steps)
    f_min = _ensure_list(f_min, n_stages)
    f_max = _ensure_list(f_max, n_stages)
    f_start = _ensure_list(f_start, n_stages)
    cycle_lengths = _ensure_list(cycle_lengths, n_stages)
    cum = np.cumsum([0] + list(cycle_lengths))

    def f(step):
        n = float(step)
        cycle = min(bisect_left(cum[1:], n), n_stages - 1)
        n = n - cum[cycle]
        if n < warm_up_steps[cycle]:
            return (f_max[cycle] - f_start[cycle]) / warm_up_steps[cycle] * n + f_start[cycle]
        return f_min[cycle] + (f_max[cycle] - f_min[cycle]) * (cycle_lengths[cycle] - n) / cycle_lengths[cycle]

    return f


def cosine_warmup_schedule(
    warm_up_steps: int,
    max_decay_steps: int,
    lr_min: float,
    lr_max: float,
    lr_start: Optional[float] = None,
):
    """Absolute-LR warmup+cosine (warmup.py:88-123)."""
    lr_start = lr_start if lr_start is not None else lr_min

    def f(step):
        n = float(step)
        if n < warm_up_steps:
            return (lr_max - lr_start) / warm_up_steps * n + lr_start
        t = min((n - warm_up_steps) / (max_decay_steps - warm_up_steps), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return f


def cosine_warmup_schedule_staged(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """Staged cosine (warmup.py:125-175) — same math as the cosine scheduler2."""
    return lambda_warmup_cosine_scheduler2(warm_up_steps, f_min, f_max, f_start, cycle_lengths)


def linear_warmup_schedule(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """Staged linear decay (warmup.py:177-199)."""
    return lambda_linear_scheduler(warm_up_steps, f_min, f_max, f_start, cycle_lengths)


def cosine_annealing_warmup_restarts(
    warm_up_steps: int,
    cycle_steps: int,
    lr_min: float = 1e-6,
    lr_max: float = 1e-3,
    lr_start: Optional[float] = None,
    decay_factor: float = 0.9,
):
    """Restarting cosine with per-cycle max-LR decay (cosine.py:14-112)."""
    lr_start = lr_start if lr_start is not None else lr_min
    if lr_start < lr_min:
        raise ValueError("lr_start must be greater than or equal to lr_min")

    def f(step):
        n = float(step)
        if n < warm_up_steps:
            # linear warmup (reproducing cosine.py:77 including its division
            # form: (max-start)/(warmup*max(step,1)) + start — upstream formula)
            return (lr_max - lr_start) / (warm_up_steps * max(n, 1.0)) + lr_start
        cycle_num, cycle_step = divmod(n - warm_up_steps, cycle_steps)
        max_lr = lr_max * decay_factor**cycle_num
        t = min(cycle_step / cycle_steps, 1.0)
        return lr_min + 0.5 * (max_lr - lr_min) * (1 + math.cos(t * math.pi))

    return f


def cosine_decay_with_warmup(
    warmup_steps: int, total_steps: int, lr_min: float = 0.0, lr_max: float = 1.0
):
    """warmup.py:14-86."""

    def f(step):
        n = float(step)
        if n < warmup_steps:
            return lr_max * n / max(1, warmup_steps)
        t = min((n - warmup_steps) / max(1, total_steps - warmup_steps), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return f


def legacy_cosine_annealing_warmup_restarts(
    first_cycle_steps: int,
    cycle_mult: float = 1.0,
    min_lr: float = 1e-6,
    warm_up_steps: int = 0,
    gamma: float = 0.9,
    max_lr: float = 1.0,
    **_,
):
    """LegacyCosineAnnealingWarmupRestarts (cosine.py:114-210) argument
    surface. cycle_mult grows each cycle's length; lr scales by gamma per
    cycle; the warmup is linear inside each cycle."""
    import math as _math

    def f(step):
        n = float(step)
        # walk cycles; the next cycle's length scales the POST-warmup portion
        # (cosine.py:190: (cur - warm_up) * mult + warm_up)
        cycle, start, length = 0, 0.0, float(first_cycle_steps)
        while n >= start + length:
            start += length
            cycle += 1
            # int() truncation matches cosine.py:190 exactly — without it,
            # cycle boundaries drift from torch for fractional cycle_mult.
            length = float(int((length - warm_up_steps) * cycle_mult) + warm_up_steps)
        step_in_cycle = n - start
        cur_max = max_lr * (gamma**cycle)
        if warm_up_steps > 0 and step_in_cycle < warm_up_steps:
            return min_lr + (cur_max - min_lr) * step_in_cycle / warm_up_steps
        frac = (step_in_cycle - warm_up_steps) / max(length - warm_up_steps, 1.0)
        return min_lr + 0.5 * (cur_max - min_lr) * (1.0 + _math.cos(_math.pi * frac))

    return f
