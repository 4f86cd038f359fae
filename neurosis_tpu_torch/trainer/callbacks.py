"""The trainer callbacks the configs name (port of the part of
neurosis_tpu/trainer/callbacks.py they use): device memory stats, the model
summary and the image logger. The checkpoint callback is not ported yet
(ROADMAP Queue 1 item 12); the CLI refuses configs that ask for it.

Hooks: on_fit_start(trainer, state), on_train_batch_end(trainer, state,
batch, metrics, step), on_fit_end(trainer, state).
"""

from __future__ import annotations

import logging
from enum import Enum
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
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


class StepType(str, Enum):
    """Cadence source (trainer/common.py:10-34)."""

    global_step = "global_step"
    batch_idx = "batch_idx"
    global_batch = "global_batch"
    sample_idx = "sample_idx"


class ImageLogger:
    """Periodic sample and reconstruction grids (image_logger.py:26-420).

    - cadence by ``log_step_type`` (``get_step_idx``/``check_step_idx``,
      image_logger.py:98-126): log_first_step, every ``every_n_train_steps``,
      never the same step twice;
    - diffusion engines: inputs, reconstructions, rendered captions and CFG
      samples of the configured sampler (``num_steps`` overrides its steps)
      under the EMA shadows when the engine keeps them, decoded by the frozen
      VAE;
    - VAE engines: inputs, reconstructions, diff and diff_boost (and their
      ``_ema`` variants), the discriminator-logit grids;
    - writes ``<root>/images/<split>/gs{step}_e{epoch}_b{batch}_<key>_<i>.png``
      and, for samples with captions, a captioned ``..._samples_grid.png``
      labelled with the step; mirrors them to wandb where the run's logger
      has it (optionally as a table).
    A failure while logging is logged and the run goes on, as in the JAX
    package.
    """

    def __init__(self, every_n_train_steps: int = 100, max_images: int = 4, num_steps: Optional[int] = None,
                 log_before_start: bool = False, log_first_step: bool = False,
                 log_step_type: StepType = StepType.global_step, batch_size: int = 1,
                 accumulate_grad_batches: int = 1, clamp: bool = True, rescale: bool = True,
                 extra_log_keys: Sequence[str] = (), wandb_log_table: bool = False, split: str = "train"):
        self.every_n = every_n_train_steps
        self.max_images = max_images
        self.num_steps = num_steps
        self.log_before_start = log_before_start
        self.log_first_step = log_first_step
        self.log_step_type = StepType(log_step_type)
        self.batch_size = batch_size
        self.accumulate_grad_batches = accumulate_grad_batches
        self.clamp = clamp
        self.rescale = rescale
        self.extra_log_keys = list(extra_log_keys)
        self.wandb_log_table = wandb_log_table
        self.split = split
        self._last_logged = -1

    # -- cadence (image_logger.py:98-126) ------------------------------------

    def get_step_idx(self, global_step: int, batch_idx: int) -> int:
        if self.log_step_type == StepType.global_step:
            return global_step
        if self.log_step_type == StepType.batch_idx:
            return batch_idx
        if self.log_step_type == StepType.global_batch:
            return batch_idx * self.accumulate_grad_batches
        return batch_idx * self.accumulate_grad_batches * self.batch_size  # sample_idx

    def check_step_idx(self, global_step: int, batch_idx: int, before_start: bool = False) -> bool:
        step_idx = self.get_step_idx(global_step, batch_idx)
        if step_idx <= self._last_logged:
            return False
        if step_idx == 0 and before_start:
            return self.log_before_start
        if step_idx == 1:
            return self.log_first_step
        return (step_idx % self.every_n) == 0

    # -- hooks ----------------------------------------------------------------

    def on_train_batch_end(self, trainer, state, batch, metrics, step: int):
        batch_idx = getattr(trainer, "batch_idx", step)
        if not self.check_step_idx(step, batch_idx):
            return
        self._last_logged = self.get_step_idx(step, batch_idx)
        try:
            self._log_images(trainer, state, batch, step)
        except Exception:
            logger.exception("image logging failed")

    def _log_images(self, trainer, state, batch, step: int):
        engine = trainer.engine
        n = self.max_images
        prepped = {k: v[:n] for k, v in trainer.prepare_batch(batch).items()}
        captions = batch.get(trainer.caption_key)
        generator = torch.Generator(engine.device).manual_seed(step)
        if hasattr(engine, "g_step"):  # the VAE-GAN trainer: reconstructions (autoencoder.py:373-427)
            images = engine.log_images(state, prepped, num_img=n, generator=generator)
        else:
            if engine.sampler is None:
                return
            images = engine.log_images(state, prepped, num_img=n, generator=generator,
                                       captions=list(captions[:n]) if captions is not None else None,
                                       num_steps=self.num_steps)
        self._write(trainer, images, batch, captions, step)

    # -- sink (image_logger.py:169-320 log_local) ------------------------------

    def _rescale(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr, np.float32)
        if self.clamp:
            arr = np.clip(arr, -1.0, 1.0)
        if self.rescale:
            arr = (arr + 1.0) / 2.0
        return arr

    def _write(self, trainer, images: dict, batch, captions, step: int):
        from ..data.png import write_png
        from ..utils.image import save_image_grid, to_uint8

        out_dir = Path(trainer.root_dir) / "images" / self.split
        out_dir.mkdir(parents=True, exist_ok=True)
        fstem = f"gs{step:06d}_e{getattr(trainer, 'epoch', 0):04d}_b{getattr(trainer, 'batch_idx', 0):06d}"
        wandb_dict: dict = {}
        table_dict: dict = {}
        for key, arr in images.items():
            arr = self._rescale(arr)
            pixels = [to_uint8(arr[i]) for i in range(arr.shape[0])]
            for idx, px in enumerate(pixels):
                write_png(out_dir / f"{fstem}_{key.replace('/', '_')}_{idx:02d}.png", px)
            wandb_dict[f"{self.split}/{key}"] = pixels
            table_dict[key] = pixels
        if "samples" in images and captions is not None:
            nimg = images["samples"].shape[0]
            grid_path = save_image_grid([images["samples"][i] for i in range(nimg)],
                                        out_dir / f"{fstem}_samples_grid.png", captions=list(captions[:nimg]),
                                        label=f"step {step}")
            wandb_dict[f"{self.split}/sample_grid"] = [grid_path]
            table_dict["caption"] = list(captions[:nimg])
        for key in self.extra_log_keys:
            if key in batch:
                vals = batch[key]
                table_dict[key] = [
                    tuple(np.asarray(v).tolist()) if hasattr(v, "__len__") and not isinstance(v, str) else v
                    for v in (vals if isinstance(vals, (list, tuple)) else list(np.asarray(vals)))
                ]
        wb = getattr(trainer.logger, "wandb", None)
        if wb is not None:
            self._to_wandb(wb, wandb_dict, table_dict, step)
        logger.info(f"logged {sorted(images)} images at step {step} → {out_dir}")

    def _to_wandb(self, wb, wandb_dict: dict, table_dict: dict, step: int) -> None:
        try:
            import wandb

            def image(x):
                return wandb.Image(str(x) if isinstance(x, Path) else x)

            wb.log({k: [image(x) for x in v] for k, v in wandb_dict.items()}, step=step)
            if self.wandb_log_table and table_dict:
                cols = list(table_dict)
                rows = [[(image(table_dict[c][i]) if isinstance(table_dict[c][i], np.ndarray) else table_dict[c][i])
                         if i < len(table_dict[c]) else None for c in cols]
                        for i in range(max(len(v) for v in table_dict.values()))]
                wb.log({f"{self.split}/table": wandb.Table(columns=cols, data=rows)}, step=step)
        except Exception:
            logger.exception("wandb image logging failed")
