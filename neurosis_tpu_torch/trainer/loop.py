"""The training loop (port of neurosis_tpu/trainer/loop.py): Lightning
Trainer's role on one CUDA card.

Drives: data (bucket batches, loaded in this process) → tokenize → the
batch to the device → ``engine.train_step`` (or the VAE-GAN trainer's
g/d steps on its schedule) → metrics to ``<root>/logs/metrics.jsonl``
(wandb when importable and configured) → callbacks. Each step's host time
(``step_ms``, the step and a device sync) and the data time before it
(``data_ms``: next batch, tokenize, copy to the device) are logged beside
its metrics; each step runs inside a ``torch.profiler.record_function``
span named ``STEP_SPAN``, which a profiler reads.

``predict`` samples images for prompts with the engine's sampler and
writes them as PNGs with a captioned grid.

Not ported yet, and refused rather than skipped: resuming from
``<root>/checkpoints`` (ROADMAP Queue 1 item 12). The CLI refuses more than
one device (item 10).
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from .callbacks import engine_modules

logger = logging.getLogger(__name__)

STEP_SPAN = "neurosis/train_step"


class HashTokenizer:
    """Deterministic fallback tokenizer when no CLIP vocab is on disk.

    Produces stable pseudo-ids from word hashes — NOT CLIP-compatible; exists
    so smoke configs run end-to-end in vocabless environments. Training for
    real requires the BPE vocab (models/text_encoder/tokenizer.py).
    """

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = self.eos_token_id

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        out = np.full((len(texts), max_length), self.pad_token_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [zlib.crc32(w.encode()) % (self.vocab_size - 2) for w in t.split()][: max_length - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            out[i, : len(row)] = row
        return out


def get_tokenizer(version: str = "openai/clip-vit-large-patch14", max_length: int = 77,
                  allow_fallback: bool = False):
    """Real CLIP BPE tokenizer, or — ONLY when explicitly allowed — the
    HashTokenizer smoke fallback. A silent downgrade would train the text
    encoder on garbage ids for an entire headless run, so missing vocab is
    fatal unless fast_dev_run / NEUROSIS_ALLOW_HASH_TOKENIZER=1 opted in."""
    from ..models.text_encoder.tokenizer import CLIPTokenizer

    try:
        return CLIPTokenizer.from_pretrained(version, max_length=max_length)
    except FileNotFoundError:
        if allow_fallback or os.environ.get("NEUROSIS_ALLOW_HASH_TOKENIZER") == "1":
            logger.warning("no CLIP vocab found — using HashTokenizer (smoke-test mode)")
            return HashTokenizer(max_length=max_length)
        raise FileNotFoundError(
            f"no CLIP vocab found for tokenizer '{version}'. Training without it would "
            "silently de-CLIP the run. Install the vocab, pass Trainer(tokenizer=...), "
            "enable fast_dev_run, or set NEUROSIS_ALLOW_HASH_TOKENIZER=1 for smoke tests."
        )


class JsonlLogger:
    """Scalar logger: JSONL always; wandb when available + configured."""

    def __init__(self, log_dir: Path, wandb_config: Optional[dict] = None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.file = open(self.log_dir / "metrics.jsonl", "a")
        self.wandb = None
        if wandb_config:
            try:
                import wandb

                self.wandb = wandb.init(**wandb_config)
            except ImportError:
                logger.warning("wandb not installed; falling back to JSONL only")

    def log(self, metrics: dict, step: int):
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                continue
        self.file.write(json.dumps(record) + "\n")
        self.file.flush()
        if self.wandb is not None:
            self.wandb.log(record, step=step)


def _to_device(value: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 images stay uint8, other integers become int64 (token ids),
    floats float32."""
    arr = np.ascontiguousarray(value)
    if arr.dtype != np.uint8 and np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int64)
    elif np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(device)


class Trainer:
    def __init__(
        self,
        engine,
        max_steps: int = 1000,
        max_epochs: Optional[int] = None,
        log_every_n_steps: int = 1,
        default_root_dir: str = "./projects",
        seed: int = 42,
        fast_dev_run: bool = False,
        callbacks: Sequence[Any] = (),
        tokenizer=None,
        caption_key: str = "caption",
        token_max_length: int = 77,
        wandb_config: Optional[dict] = None,
        allow_random_weights: bool = False,
    ):
        self.engine = engine
        self.device = engine.device
        self.max_steps = 1 if fast_dev_run else max_steps
        self.max_epochs = 1 if fast_dev_run else max_epochs
        self.log_every = log_every_n_steps
        self.root_dir = Path(default_root_dir)
        self.seed = seed
        self.callbacks = list(callbacks)
        self.tokenizer = tokenizer or get_tokenizer(max_length=token_max_length, allow_fallback=fast_dev_run)
        self.caption_key = caption_key
        self.logger = JsonlLogger(self.root_dir / "logs", wandb_config=wandb_config)
        # validate on never-loaded params is meaningless; require an explicit
        # opt-in (fast_dev_run implies it)
        self.allow_random_weights = allow_random_weights or fast_dev_run
        self._weights_loaded = False
        # cadence state the callbacks read (StepType batch_idx/global_batch)
        self.batch_idx = 0
        self.epoch = 0

    # -- batch prep --------------------------------------------------------

    def prepare_batch(self, batch: dict) -> dict:
        """Host batch → tensors on the device: captions tokenized (int64 ids,
        plus the empty prompt's as ``uncond_ids``), numeric fields as tensors,
        strings dropped."""
        out = {}
        for k, v in batch.items():
            if k == self.caption_key and isinstance(v, (list, tuple)):
                out[f"{k}_ids"] = self.tokenizer(list(v))
            elif isinstance(v, np.ndarray):
                out[k] = v
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], (int, float)):
                out[k] = np.asarray(v)
        if f"{self.caption_key}_ids" in out and "uncond_ids" not in out:
            out["uncond_ids"] = self.tokenizer([""])
        return {k: _to_device(v, self.device) for k, v in out.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self, what: str):
        """The engine's state, the checkpoint loaded into it, and the refusal
        of a resume the port cannot read."""
        state = self.engine.init(self.seed)
        if getattr(self.engine, "ckpt_path", None):
            self._load_ckpt(state)
        self._maybe_resume()
        if what != "fit":
            self._require_loaded_weights(what)
        return state

    def _batches(self, batch_iter_factory):
        """(prepared batch, host batch, data ms) of each batch of one epoch."""
        it = iter(batch_iter_factory())
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            prepped = self.prepare_batch(batch)
            yield prepped, batch, (time.perf_counter() - t0) * 1e3

    def _step(self, fn, state, prepped) -> tuple[Any, dict]:
        """One step inside the profiler span, synced, with its host ms."""
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(STEP_SPAN):
            state, metrics = fn(state, prepped)
            self._sync()
        step_ms = (time.perf_counter() - t0) * 1e3
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_ms"] = step_ms
        return state, metrics

    # -- fit ---------------------------------------------------------------

    def fit(self, batch_iter_factory: Callable[[], Iterable[dict]]):
        """Run training over batches from ``batch_iter_factory()`` per epoch;
        returns the engine's state."""
        vae = hasattr(self.engine, "g_step")
        state = None
        global_step = 0
        epoch = 0
        try:
            while global_step < self.max_steps and (self.max_epochs is None or epoch < self.max_epochs):
                batch_idx = 0
                for prepped, batch, data_ms in self._batches(batch_iter_factory):
                    if state is None:
                        state = self._start("fit")
                        for cb in self.callbacks:
                            if hasattr(cb, "on_fit_start"):
                                cb.on_fit_start(self, state)
                    if vae:  # alternating G/D steps (models/autoencoder.py:280-293)
                        idx = self.engine.train_step_schedule(batch_idx, state.step)
                        use_d = idx == 1 and state.d_optimizer is not None
                        fn = self.engine.d_step if use_d else self.engine.g_step
                    else:
                        fn = self.engine.train_step
                    state, metrics = self._step(fn, state, prepped)
                    metrics["data_ms"] = data_ms
                    batch_idx += 1
                    self.batch_idx, self.epoch = batch_idx, epoch
                    global_step = int(state.step)
                    if global_step % self.log_every == 0:
                        self.logger.log(metrics, global_step)
                    for cb in self.callbacks:
                        if hasattr(cb, "on_train_batch_end"):
                            cb.on_train_batch_end(self, state, batch, metrics, global_step)
                    if global_step >= self.max_steps:
                        break
                epoch += 1
        except Exception:
            # ExceptionHandler parity: dump state for post-mortem
            if state is not None:
                self._crash_dump(state)
            raise
        for cb in self.callbacks:
            if hasattr(cb, "on_fit_end"):
                cb.on_fit_end(self, state)
        return state

    def validate(self, batch_iter_factory, max_batches: Optional[int] = None) -> dict:
        """Loss-only evaluation: mean metrics over the dataset (no updates)."""
        if hasattr(self.engine, "g_step"):
            raise NotImplementedError("validate/test of the VAE trainer: its eval_step is not ported yet: "
                                      "ROADMAP Queue 1 item 9")
        state = None
        sums: dict = {}
        n = 0
        for prepped, _, _ in self._batches(batch_iter_factory):
            if max_batches is not None and n >= max_batches:
                break
            if state is None:
                state = self._start("validate")
            state, metrics = self.engine.eval_step(state, prepped)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            return {}
        out = {k: v / n for k, v in sums.items()}
        out["num_batches"] = float(n)
        self.logger.log(out, int(state.step))
        return out

    @torch.no_grad()
    def predict(self, prompts: Sequence[str], out_dir, size: int = 1024, num_steps: Optional[int] = None) -> list:
        """Sample images for ``prompts`` with the engine's sampler, under its
        EMA shadows when it keeps them, and write ``sample_###.png`` and a
        captioned ``grid.png`` to ``out_dir`` (loop.py:456-514). SDXL's size
        conditionings default to an uncropped ``size`` x ``size`` image; the
        initial noise is drawn from the seed + 1."""
        from ..data.png import write_png
        from ..utils.image import save_image_grid

        prompts = list(prompts)
        n = len(prompts)
        sizes = np.tile(np.array([[size, size]], np.float32), (n, 1))
        batch = {self.caption_key: prompts, "original_size_as_tuple": sizes,
                 "crop_coords_top_left": np.zeros((n, 2), np.float32), "target_size_as_tuple": sizes}
        prepped = self.prepare_batch(batch)
        state = self._start("predict")
        engine = self.engine
        with engine.eval_scope(state):
            c, uc = engine.conditioner.get_unconditional_conditioning(prepped)
            shape = (n, size // 8, size // 8, engine.model.in_channels)
            latents = engine.sample(c, uc, shape, num_steps=num_steps,
                                    generator=torch.Generator(self.device).manual_seed(self.seed + 1))
        decoded = engine.decode_first_stage(latents).float().cpu().numpy()

        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for i in range(n):
            path = out_dir / f"sample_{i:03d}.png"
            write_png(path, ((np.clip(decoded[i], -1, 1) + 1) * 127.5).astype(np.uint8))
            paths.append(path)
        save_image_grid(list(decoded), out_dir / "grid.png", captions=prompts)
        return paths

    # -- checkpoints -------------------------------------------------------

    def _load_ckpt(self, state):
        from ..checkpoint.sgm import load_sgm_checkpoint

        try:
            load_sgm_checkpoint(self.engine, state, self.engine.ckpt_path)
            self._weights_loaded = True
        except FileNotFoundError:
            logger.warning(f"ckpt_path {self.engine.ckpt_path} not found — training from scratch")

    def _require_loaded_weights(self, what: str):
        """validate on never-loaded random params "succeeds" with meaningless
        output — make it loud instead."""
        if self._weights_loaded or self.allow_random_weights:
            return
        raise RuntimeError(
            f"{what} would run on randomly-initialized weights: no ckpt_path was set and "
            "no resumable checkpoint was found. Pass a checkpoint, or set "
            "Trainer(allow_random_weights=True) / fast_dev_run for smoke tests."
        )

    def _maybe_resume(self):
        """The JAX package resumes from the orbax trees under
        ``<root>/checkpoints``, which the port cannot read; rather than start
        fresh beside them, refuse."""
        ckpt_dir = (self.root_dir / "checkpoints").absolute()
        if ckpt_dir.exists():
            raise NotImplementedError(f"{ckpt_dir} exists: resuming a run is not ported yet (ROADMAP Queue 1 "
                                      "item 12); move it away to start a new run")

    def _crash_dump(self, state):
        try:
            path = self.root_dir / f"last_exception.s{int(state.step)}.pt"
            path.parent.mkdir(parents=True, exist_ok=True)
            params = {}
            for top, module in engine_modules(self.engine).items():
                params.update({f"{top}.{n}": p.detach().cpu() for n, p in module.named_parameters()
                               if p.requires_grad})
            torch.save({"step": int(state.step), "params": params}, path)
            logger.error(f"crash dump saved to {path}")
        except Exception:  # pragma: no cover
            logger.exception("failed to write crash dump")
