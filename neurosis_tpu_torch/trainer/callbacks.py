"""The trainer callbacks the configs name (port of the part of
neurosis_tpu/trainer/callbacks.py they use): device memory stats and the
model summary. The image logger and checkpoint callbacks are not ported yet
(ROADMAP Queue 1 items 5 and 12); the CLI refuses configs that ask for them.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


def engine_modules(engine) -> dict:
    """The engine's top-level modules by name."""
    names = ("model", "conditioner", "first_stage") if hasattr(engine, "conditioner") else \
        ("encoder", "decoder", "loss")
    return {n: getattr(engine, n) for n in names if getattr(engine, n, None) is not None}


class DeviceStatsCallback:
    """CUDA memory logging (GPUMemoryUsage parity, trainer/callbacks/stats.py:78-118):
    allocated, reserved and peak allocated GiB every ``every_n_train_steps``."""

    def __init__(self, every_n_train_steps: int = 100):
        self.every_n = every_n_train_steps

    def on_train_batch_end(self, trainer, state, batch, metrics, step: int):
        if step % self.every_n != 0 or trainer.device.type != "cuda":
            return
        gib = 2.0**30
        trainer.logger.log({"device/mem_allocated_gib": torch.cuda.memory_allocated(trainer.device) / gib,
                            "device/mem_reserved_gib": torch.cuda.memory_reserved(trainer.device) / gib,
                            "device/mem_peak_gib": torch.cuda.max_memory_allocated(trainer.device) / gib}, step)


class ModelSummaryCallback:
    """Parameter counts per module path to ``max_depth`` components (the top
    level counts as one), trainable and frozen, logged at fit start
    (lightning.pytorch.callbacks.ModelSummary's role)."""

    def __init__(self, max_depth: int = 2, **_):
        self.max_depth = max_depth

    def summary(self, engine) -> str:
        rows: dict = {}
        for top, module in engine_modules(engine).items():
            for name, p in module.named_parameters():
                key = ".".join([top] + name.split(".")[:-1][: max(self.max_depth - 1, 0)])
                n, t = rows.get(key, (0, 0))
                rows[key] = (n + p.numel(), t + (p.numel() if p.requires_grad else 0))
        width = max(len(k) for k in rows)
        lines = [f"{'module':<{width}}  {'params':>14}  {'trainable':>14}"]
        lines += [f"{k:<{width}}  {n:>14,}  {t:>14,}" for k, (n, t) in rows.items()]
        total = sum(n for n, _ in rows.values())
        lines.append(f"{'total':<{width}}  {total:>14,}  {sum(t for _, t in rows.values()):>14,}")
        return "\n".join(lines)

    def on_fit_start(self, trainer, state):
        logger.info("\n" + self.summary(trainer.engine))
