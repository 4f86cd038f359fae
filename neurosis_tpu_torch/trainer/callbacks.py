"""The trainer callbacks (port of neurosis_tpu/trainer/callbacks.py):
device memory stats, the model summary, the image logger, checkpoints, the
progress line with its smoothed loss and the resolved config's copy.
``HFHubCheckpoint`` (uploads to the Hugging Face Hub) is not ported.

Checkpoints are the port's own format, not the JAX package's orbax trees:
one directory a step under ``dirpath`` (default ``<root>/checkpoints``), as
orbax's manager lays them out, holding ``state.pt``, a ``torch.save`` of
JAX's ``_state_payload`` (``params``, ``step``, ``opt_state``, ``ema_params``,
``ema_num_updates``) readable with ``torch.load(weights_only=True)``.
``load_checkpoint`` reads one back into an engine's state. A remote
``dirpath`` (``gs://``, ``s3://``, ``memory://``, ...) holds the same payload
as ``step_<NNNNNNNN>.pt`` files (``checkpoint/blob.py``), written on a
background thread.

On a mesh (``trainer.mesh``) every rank takes part in what is a collective
(gathering a sharded state, a sampling run through the wrapped UNet), and
one rank writes: global rank 0 the checkpoint, between two barriers, in the
one-card layout, so a checkpoint of N ranks resumes on 1 and one of 1 rank
on N; local rank 0 of each node the images, as JAX's process does.

Hooks: on_fit_start(trainer, state), on_train_batch_end(trainer, state,
batch, metrics, step), on_fit_end(trainer, state).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from enum import Enum
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..checkpoint.blob import BlobCheckpointIO, is_remote_url
from ..parallel.fsdp import assign, full, full_state, shard_optimizer_state
from ..utils.fs import split_url

logger = logging.getLogger(__name__)


def engine_modules(engine) -> dict:
    """The engine's top-level modules by name."""
    names = ("model", "conditioner", "first_stage", "first_stage_encoder", "first_stage_decoder") \
        if hasattr(engine, "conditioner") else \
        ("encoder", "decoder", "loss", "regularizer")
    return {n: getattr(engine, n) for n in names if isinstance(getattr(engine, n, None), torch.nn.Module)}


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

        mesh = getattr(trainer, "mesh", None)
        if mesh is not None and not mesh.is_node_writer:
            return
        out_dir = Path(trainer.root_dir) / "images" / self.split
        out_dir.mkdir(parents=True, exist_ok=True)
        fstem = f"gs{step:06d}_e{getattr(trainer, 'epoch', 0):04d}_b{getattr(trainer, 'batch_idx', 0):06d}"
        if mesh is not None and mesh.dist.env.node:
            fstem += f"_r{mesh.dist.env.node}"  # node k writes what JAX's process k writes (log_local:187-189)
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


# -- checkpoints -----------------------------------------------------------------

CHECKPOINT_FORMAT = "neurosis_tpu_torch/1"
STATE_FILE = "state.pt"


def _named_params(engine) -> list:
    """(name, parameter) of what a checkpoint holds: the diffusion engine's
    trainable parameters, or every parameter of the VAE trainer's encoder,
    decoder, loss and regularizer module (JAX's ``VAETrainState.params``,
    the frozen LPIPS trunk included)."""
    if hasattr(engine, "named_trainable_parameters"):
        return engine.named_trainable_parameters()
    return [(f"{top}.{n}", p) for top, module in engine_modules(engine).items() for n, p in module.named_parameters()]


def _ema_names(engine) -> list:
    """Names of the EMA shadows, in their order (the trainable parameters,
    or the VAE trainer's generator parameters)."""
    named = engine.named_trainable_parameters() if hasattr(engine, "named_trainable_parameters") \
        else engine.named_g_parameters()
    return [n for n, _ in named]


def state_payload(engine, state) -> dict:
    """JAX's ``_state_payload``: params, step, the optimizer's state (the
    diffusion engine's; JAX's VAETrainState keeps ``g_opt_state``, which its
    payload does not save, so the VAE trainer's optimizers are not saved
    either), the EMA shadows with their update count, and an EMA codebook's
    statistics (``reg_stats``). Sharded tensors are gathered whole (every
    rank calls it)."""
    payload = {"format": CHECKPOINT_FORMAT, "step": int(state.step),
               "params": {n: full(p.detach()) for n, p in _named_params(engine)}}
    if getattr(state, "optimizer", None) is not None:
        payload["opt_state"] = full_state(state.optimizer.state_dict())
    if getattr(state, "ema", None) is not None:
        payload["ema_params"] = dict(zip(_ema_names(engine), [full(s) for s in state.ema.params]))
        payload["ema_num_updates"] = int(state.ema.num_updates)
    if getattr(state, "reg_stats", None):
        payload["reg_stats"] = {n: t.detach() for n, t in state.reg_stats.items()}
    return payload


def _load_tensors(dst: list, src: dict, what: str) -> None:
    """Copy ``src`` ({name: tensor}) into the (name, tensor) pairs of ``dst``
    (a sharded one takes its part); names and shapes must agree."""
    names = [n for n, _ in dst]
    if sorted(names) != sorted(src):
        missing, extra = sorted(set(names) - set(src)), sorted(set(src) - set(names))
        raise ValueError(f"checkpoint {what} do not match the engine's: missing {missing[:5]}, unexpected "
                         f"{extra[:5]}")
    with torch.no_grad():
        for n, t in dst:
            if tuple(src[n].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {what} {n} has shape {tuple(src[n].shape)}, not {tuple(t.shape)}")
            assign(t, src[n])


def load_state_payload(engine, state, payload: dict):
    """Restore a payload of ``state_payload`` in place: parameters, step,
    optimizer state and EMA. The state's generator is not restored: the JAX
    package saves no rng and restarts it from the seed, and so does the port."""
    if payload.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"not a checkpoint of the port (format {payload.get('format')!r})")
    _load_tensors(_named_params(engine), payload["params"], "parameters")
    state.step = int(payload["step"])
    if "opt_state" in payload and getattr(state, "optimizer", None) is not None:
        state.optimizer.load_state_dict(shard_optimizer_state(state.optimizer, payload["opt_state"]))
    if "ema_params" in payload and getattr(state, "ema", None) is not None:
        _load_tensors(list(zip(_ema_names(engine), state.ema.params)), payload["ema_params"], "EMA shadows")
        state.ema.num_updates = int(payload["ema_num_updates"])
    if getattr(state, "reg_stats", None):
        _load_tensors(list(state.reg_stats.items()), payload.get("reg_stats", {}), "codebook statistics")
    from ..losses.patchgan import ActNorm

    for module in engine_modules(engine).values():  # saved loc/scale are initialised ones
        for m in module.modules():
            if isinstance(m, ActNorm):
                m.initialized.fill_(1)
    return state


def checkpoint_steps(root: Path) -> list:
    """Steps saved under ``root``, oldest first. A step directory without the
    port's state file (the JAX package's orbax trees, or another format)
    raises, so a run never starts fresh beside a checkpoint it cannot read."""
    steps = []
    for d in Path(root).iterdir() if Path(root).is_dir() else []:
        if not (d.is_dir() and d.name.isdigit()):
            continue  # e.g. a <step>.tmp of an interrupted save
        if not (d / STATE_FILE).is_file():
            orbax = any((d / m).exists() for m in ("_CHECKPOINT_METADATA", "_METADATA", "default"))
            raise ValueError(f"{d} holds no {STATE_FILE}: "
                             + ("it is an orbax checkpoint of the JAX package, which the port cannot read"
                                if orbax else "not a checkpoint of the port"))
        steps.append(int(d.name))
    return sorted(steps)


def load_checkpoint(path: Path) -> dict:
    """A ``state.pt`` read with ``weights_only`` into host memory, memory-mapped
    (a large one is not read at once; loading moves each tensor to its
    parameter's device); an unreadable file raises."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except Exception as e:
        raise ValueError(f"cannot read checkpoint {path}: {e}") from e


def check_store_reach(url: str, mesh) -> None:
    """A ``memory://`` store is one process's: under a mesh of several
    processes the others would neither see a save nor resume from it."""
    if mesh is not None and mesh.dist.world_size > 1 and split_url(url)[0] == "memory":
        raise ValueError(f"{url}: a memory:// store is per process, and the mesh has {mesh.dist.world_size} processes")


class CheckpointCallback:
    """State checkpointing (ModelCheckpoint's role): every
    ``every_n_train_steps`` steps the state goes to ``<dirpath>/<step>/state.pt``,
    written under ``<step>.tmp`` and then renamed, so an interrupted save
    leaves the earlier ones readable; only the newest ``keep`` are kept. A
    remote ``dirpath`` (with its ``storage_options``) goes through
    ``BlobCheckpointIO``: written on a thread, pruned to ``keep`` after each
    write, the last write waited for at the fit's end. A ``file://`` URL
    names a local directory (JAX hands it to orbax as a relative path)."""

    def __init__(self, dirpath: Optional[str] = None, every_n_train_steps: int = 1000, keep: int = 3,
                 storage_options: Optional[dict] = None):
        self.dirpath = dirpath
        self.every_n = every_n_train_steps
        self.keep = keep
        self.blob = BlobCheckpointIO(dirpath, storage_options) if is_remote_url(dirpath) else None
        if self.blob is not None:
            _ = self.blob.fs  # an unknown scheme or a missing package raises before the fit
        self.last_save_s: Optional[float] = None  # seconds of the last save, for the caller's records

    def root(self, trainer) -> Path:
        return Path(split_url(self.dirpath)[1] if self.dirpath else Path(trainer.root_dir) / "checkpoints").absolute()

    def on_fit_start(self, trainer, state):
        if self.blob is not None:
            check_store_reach(self.dirpath, getattr(trainer, "mesh", None))

    def save(self, trainer, state, step: int):
        """The state of ``step``: its directory, or for a remote ``dirpath``
        the path of its file in the store."""
        t0 = time.perf_counter()
        mesh = getattr(trainer, "mesh", None)
        if mesh is not None:
            mesh.barrier()
        payload = state_payload(trainer.engine, state)
        final = None
        if mesh is None or mesh.is_writer:
            if self.blob is not None:
                final = self.blob.save_checkpoint(payload, step, keep=self.keep)
            else:
                final = self._save_local(self.root(trainer), payload, step)
        del payload
        if mesh is not None:
            mesh.barrier()
        self.last_save_s = time.perf_counter() - t0
        logger.info(f"saved checkpoint at step {step} to {final} in {self.last_save_s:.1f} s")
        return final

    def _save_local(self, root: Path, payload: dict, step: int) -> Path:
        tmp, final = root / f"{step}.tmp", root / str(step)
        root.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        with open(tmp / STATE_FILE, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in checkpoint_steps(root)[:-self.keep]:
            shutil.rmtree(root / str(old))
        return final

    def on_train_batch_end(self, trainer, state, batch, metrics, step: int):
        if step % self.every_n == 0:
            self.save(trainer, state, step)

    def on_fit_end(self, trainer, state):
        if self.blob is not None:
            self.blob.wait()


# -- console progress and the config's copy -----------------------------------------------


class EMATracker:
    """Scalar loss smoothing (trainer/util.py:59)."""

    def __init__(self, steps: int = 64):
        self.alpha = 2.0 / (steps + 1)
        self.value: Optional[float] = None

    def update(self, v: float) -> float:
        self.value = v if self.value is None else self.alpha * v + (1 - self.alpha) * self.value
        return self.value


class ProgressCallback:
    """Throughput and smoothed loss on the console (NeurosisProgressBar's
    role): every ``every_n`` steps, from the second such step on,
    ``step S loss L (ema E) R it/s``."""

    def __init__(self, every_n: int = 10):
        self.every_n = every_n
        self.ema = EMATracker()
        self._last_time = None
        self._last_step = 0

    def on_train_batch_end(self, trainer, state, batch, metrics, step: int):
        loss = float(metrics.get("loss", metrics.get("total", 0.0)))
        smoothed = self.ema.update(loss)
        if step % self.every_n != 0:
            return
        now = time.time()
        if self._last_time is not None:
            rate = (step - self._last_step) / max(now - self._last_time, 1e-9)
            logger.info(f"step {step} loss {loss:.4f} (ema {smoothed:.4f}) {rate:.2f} it/s")
        self._last_time = now
        self._last_step = step


class SaveConfigCallback:
    """The resolved config as ``<root>/config.yaml`` at the fit's start
    (LoggerSaveConfigCallback, trainer/callbacks/wandb.py:15-34), written by
    ``config/yaml_writer.py``; with an active wandb run also its hyper-
    parameters, the file as a ``config`` artifact and, with ``log_code``, the
    package's source. The CLI hands a node that gives no ``config`` the
    run's own (JAX's CLI passes only the node's arguments)."""

    def __init__(self, config: Optional[dict] = None, log_code: bool = False):
        self.config = config
        self.log_code = log_code

    def on_fit_start(self, trainer, state):
        from ..config.yaml_writer import safe_dump

        if not self.config:
            return
        mesh = getattr(trainer, "mesh", None)
        if mesh is not None and not mesh.is_writer:
            return
        path = Path(trainer.root_dir) / "config.yaml"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(safe_dump(self.config))
        wb = getattr(trainer.logger, "wandb", None)
        if wb is not None:
            try:
                wb.config.update({"resolved_config": self.config}, allow_val_change=True)
                if hasattr(wb, "log_artifact"):
                    wb.log_artifact(str(path), type="config")
                if self.log_code and hasattr(wb, "log_code"):
                    wb.log_code(root=str(Path(__file__).resolve().parents[1]))
            except Exception:
                logger.exception("wandb config artifact upload failed")
        logger.info(f"saved resolved config → {path}")
