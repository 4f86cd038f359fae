"""LR schedules (port of neurosis_tpu/schedulers; parity: schedulers/{cosine,hf,linear,warmup,base}.py).

All return ``step -> multiplier`` (or an absolute lr where the reference
does). The builder composes one with an optimizer as the JAX package does:
each param group's lr is its base lr × ``sched(count)``, ``count`` the
updates already made (``attach_schedule``).
"""

from .attach import attach_schedule
from .schedules import (
    cosine_annealing_warmup_restarts,
    cosine_decay_with_warmup,
    cosine_warmup_schedule,
    cosine_warmup_schedule_staged,
    cosine_with_warmup,
    cosine_with_hard_restarts,
    lambda_linear_scheduler,
    legacy_cosine_annealing_warmup_restarts,
    lambda_warmup_cosine_scheduler2,
    linear_warmup_schedule,
)

__all__ = [
    "attach_schedule",
    "cosine_annealing_warmup_restarts",
    "cosine_decay_with_warmup",
    "cosine_warmup_schedule",
    "cosine_warmup_schedule_staged",
    "cosine_with_warmup",
    "cosine_with_hard_restarts",
    "lambda_linear_scheduler",
    "legacy_cosine_annealing_warmup_restarts",
    "lambda_warmup_cosine_scheduler2",
    "linear_warmup_schedule",
]
