"""Schedule composition (port of neurosis_tpu/trainer/builder.py:92-99).

The JAX package feeds ``lambda count: base_lr × sched(count)`` to the
optimizer as its learning rate, ``count`` being optax's count of the updates
already made, so the first update uses ``sched(0)``. Here each param group
keeps its own ``base_lr`` and ``schedule_count`` and its ``lr`` always holds
the rate of the next update. They live in the param group, so the
optimizer's ``state_dict()`` carries them and a resumed run continues the
schedule.
"""

from __future__ import annotations

import logging
from typing import Callable

import torch

logger = logging.getLogger(__name__)


def attach_schedule(optimizer: torch.optim.Optimizer, sched: Callable[[int], float]) -> torch.optim.Optimizer:
    """Set each group's lr to ``base_lr × sched(count)`` now and after every
    ``optimizer.step()``. A group without an lr (Adafactor's relative step)
    keeps its own rate, as in the JAX package, where such an optimizer takes
    no learning rate and the schedule is dropped."""
    groups = [g for g in optimizer.param_groups if g.get("lr") is not None]
    if len(groups) < len(optimizer.param_groups):
        logger.warning(f"{type(optimizer).__name__} has param groups without an lr: the schedule leaves them be")

    def set_lr(group):
        group["lr"] = group["base_lr"] * float(sched(group["schedule_count"]))

    for group in groups:
        group.setdefault("base_lr", group["lr"])
        group.setdefault("schedule_count", 0)
        set_lr(group)

    def advance(opt, args, kwargs):
        for group in opt.param_groups:
            if "schedule_count" in group:
                group["schedule_count"] += 1
                set_lr(group)

    optimizer.register_step_post_hook(advance)
    return optimizer
