"""The training loop (port of neurosis_tpu/trainer/loop.py): Lightning
Trainer's role on one CUDA card, or on each card of a mesh.

Drives: data (bucket batches, loaded in this process) → tokenize → the
batch to the device → ``engine.train_step`` (or the VAE-GAN trainer's
g/d steps on its schedule) → metrics to ``<root>/logs/metrics.jsonl``
(wandb when importable and configured) → callbacks. Each step's host time
(``step_ms``, the step and a device sync) and the data time before it
(``data_ms``: next batch, tokenize, copy to the device) are logged beside
its metrics; each step runs inside a ``torch.profiler.record_function``
span named ``STEP_SPAN``, which a profiler reads. A ``NeurosisProfiler``
callback (``trainer.profiler:``) steps its trace window at each batch's end;
with its ``record_module_names`` the whole fit runs inside
``utils/profiling.record_module_names`` (JAX's loop.py:286-295).

An engine's loss hooks (``forward_hooks``) run at JAX's places
(loop.py:361-385): ``pre_hook`` on the host batch before it is tokenized
and moved (a ``loss_scale`` it adds reaches the loss), ``batch_hook`` on the
step's metrics before they are logged.

``predict`` samples images for prompts with the engine's sampler and
writes them as PNGs with a captioned grid.

A run resumes from the latest step in the blob store of
``remote_checkpoint_url`` (``checkpoint/blob.py``), else from the latest
step under ``<root>/checkpoints`` (the port's format,
``callbacks.CheckpointCallback``): parameters, optimizer state (with the
schedule's count), EMA and step. The random generator restarts from the
seed, as in the JAX package, which saves no rng. A checkpoint that cannot be
read raises rather than start fresh beside it.

With a ``mesh`` (``parallel/mesh.py``) each process drives one rank: the
engine's trainable modules are wrapped with FSDP2 before its state is
built (``parallel/fsdp.py``), each host batch (a node's, the hooks run on
all of it) is cut to this rank's rows (``mesh.shard``) and the step runs
under ``rows.sliced``, so its draws and batch statistics are the global
batch's; the step's metrics are averaged over the ranks of the other rows.
Global rank 0 writes the metrics file; a crash dump is gathered first.
On a mesh with a context axis (``context_parallel`` > 1) the UNet's
self-attention rides the context ring (its ``context_axis`` set to
"context", as JAX's loop clones the module) while fit and validate run, as
JAX enters its mesh around them.

Captions are tokenized by the CLIP tokenizer into ``<caption>_ids`` (and
the empty prompt's ``uncond_ids``), and, given a ``t5_tokenizer``, into
``<caption>_t5_ids`` and ``uncond_t5_ids`` for the embedders that read a
T5 stream (``FrozenCLIPT5Encoder``, ``FrozenT5Embedder``); an engine whose
conditioner needs T5 ids that nothing makes raises, as JAX's loop does.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..ops.ring_attention import on_axis
from ..parallel import rows as rows_
from ..parallel.fsdp import full, reshard, wrap_engine
from ..utils.profiling import record_module_names
from ..checkpoint.blob import BlobCheckpointIO
from .callbacks import (STATE_FILE, check_store_reach, checkpoint_steps, engine_modules, load_checkpoint,
                        load_state_payload)

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


class NullLogger:
    """The logger of a rank that writes no logs."""

    wandb = None

    def log(self, metrics: dict, step: int):
        pass


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
        t5_tokenizer=None,
        caption_key: str = "caption",
        token_max_length: int = 77,
        wandb_config: Optional[dict] = None,
        allow_random_weights: bool = False,
        mesh=None,
        remote_checkpoint_url: Optional[str] = None,
        storage_options: Optional[dict] = None,
    ):
        self.engine = engine
        self.remote_checkpoint_url = remote_checkpoint_url
        self.storage_options = storage_options
        self.mesh = mesh  # parallel.mesh.Mesh: wrap the engine and run this rank's rows
        if mesh is not None and mesh.context > 1:
            model = getattr(engine, "model", None)
            if model is not None and hasattr(model, "context_axis") and model.context_axis is None:
                model.context_axis = "context"
        self._wrapped = False
        self.device = engine.device
        self.max_steps = 1 if fast_dev_run else max_steps
        self.max_epochs = 1 if fast_dev_run else max_epochs
        self.log_every = log_every_n_steps
        self.root_dir = Path(default_root_dir)
        self.seed = seed
        self.callbacks = list(callbacks)
        # the VAE trainer reads no captions, so it needs no vocabulary (JAX's loop asks for one all the same)
        self.tokenizer = tokenizer or (get_tokenizer(max_length=token_max_length, allow_fallback=fast_dev_run)
                                       if hasattr(engine, "conditioner") else None)
        self.t5_tokenizer = t5_tokenizer
        self.caption_key = caption_key
        self.logger = JsonlLogger(self.root_dir / "logs", wandb_config=wandb_config) \
            if mesh is None or mesh.is_writer else NullLogger()
        # validate on never-loaded params is meaningless; require an explicit
        # opt-in (fast_dev_run implies it)
        self.allow_random_weights = allow_random_weights or fast_dev_run
        self._weights_loaded = False
        # cadence state the callbacks read (StepType batch_idx/global_batch)
        self.batch_idx = 0
        self.epoch = 0

    # -- batch prep --------------------------------------------------------

    def _caption_chunks(self) -> int:
        """The most ``extended_chunks`` among the engine's text embedders of
        the caption (0 or 1: plain 77-token prompts)."""
        embedders = getattr(getattr(self.engine, "conditioner", None), "embedders", ()) or ()
        return max([int(getattr(e, "extended_chunks", 0) or 0) for e in embedders
                    if getattr(e, "input_key", None) == self.caption_key] + [0])

    def _needs_t5_ids(self) -> bool:
        """Whether an embedder reads a second '<caption>_t5_ids' token stream."""
        t5_key = f"{self.caption_key}_t5_ids"
        for emb in getattr(getattr(self.engine, "conditioner", None), "embedders", ()) or ():
            keys = (emb.token_keys() or []) if hasattr(emb, "token_keys") else []
            if emb.token_key() == t5_key or t5_key in keys:
                return True
        return False

    def prepare_batch(self, batch: dict) -> dict:
        """Host batch → tensors on the device: captions tokenized (int64 ids,
        [B, chunks, 77] when an embedder takes extended prompts and the
        tokenizer can chunk, plus the empty prompt's as ``uncond_ids``),
        numeric fields as tensors, strings dropped."""
        return self._to_device(self._host_arrays(batch))

    def _to_device(self, arrays: dict) -> dict:
        return {k: _to_device(v, self.device) for k, v in arrays.items()}

    def _host_arrays(self, batch: dict) -> dict:
        """``prepare_batch``'s arrays, on the host."""
        out = {}
        chunks = self._caption_chunks()
        for k, v in batch.items():
            if k == self.caption_key and isinstance(v, (list, tuple)):
                if chunks > 1 and hasattr(self.tokenizer, "tokenize_extended"):
                    out[f"{k}_ids"] = self.tokenizer.tokenize_extended(list(v), chunks)
                else:
                    out[f"{k}_ids"] = self.tokenizer(list(v))
                if self.t5_tokenizer is not None and f"{k}_t5_ids" not in batch:
                    out[f"{k}_t5_ids"] = self.t5_tokenizer(list(v))
            elif isinstance(v, np.ndarray):
                out[k] = v
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], (int, float)):
                out[k] = np.asarray(v)
        if f"{self.caption_key}_ids" in out and "uncond_ids" not in out:
            out["uncond_ids"] = self.tokenizer([""])
        if f"{self.caption_key}_t5_ids" in out and "uncond_t5_ids" not in out and self.t5_tokenizer is not None:
            out["uncond_t5_ids"] = self.t5_tokenizer([""])
        if self._needs_t5_ids() and f"{self.caption_key}_t5_ids" not in out:
            raise ValueError(
                "conditioner expects T5 token ids but no t5_tokenizer is set and "
                f"the batch has no '{self.caption_key}_t5_ids' — pass Trainer(t5_tokenizer=...) "
                "or tokenize in the dataset"
            )
        return out

    def _mesh_scope(self):
        """The context axis's ring while fit or validate runs (JAX's ``with
        mesh:``); nothing without one."""
        if self.mesh is None or self.mesh.context == 1:
            return contextlib.nullcontext()
        return on_axis("context", self.mesh.context_ring)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self, what: str):
        """The engine's state, the checkpoint loaded into it, then the run's
        latest saved state over both; on a mesh the engine is wrapped first."""
        if self.mesh is not None and not self._wrapped:
            wrap_engine(self.engine, self.mesh)
            self._wrapped = True
        state = self.engine.init(self.seed)
        if getattr(self.engine, "ckpt_path", None):
            self._load_ckpt(state)
        state = self._maybe_resume(state)
        if what != "fit":
            self._require_loaded_weights(what)
        return state

    @contextlib.contextmanager
    def _batches(self, batch_iter_factory, hooks: Sequence[Any] = ()):
        """(prepared batch, host batch, data ms, rows) of each batch of one
        epoch, each host batch through the ``pre_hook`` of ``hooks`` first,
        then cut to this rank's rows on a mesh (``rows`` None: the whole
        batch); the epoch's iterator is closed on leaving, which stops its
        prefetch workers."""
        it = iter(batch_iter_factory())

        def gen():
            batch_idx = 0
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                for hook in hooks:
                    batch = hook.pre_hook(self, self.engine, batch, batch_idx)
                batch_idx += 1
                arrays, rows = self._host_arrays(batch), None
                if self.mesh is not None:
                    arrays, rows = self.mesh.shard(arrays)
                yield self._to_device(arrays), batch, (time.perf_counter() - t0) * 1e3, rows

        try:
            yield gen()
        finally:
            if hasattr(it, "close"):
                it.close()

    def _run(self, fn, state, prepped, rows) -> tuple[Any, dict]:
        """``fn(state, prepped)`` on ``rows`` of the global batch, its
        metrics (0-d tensors) averaged over the ranks of the other rows;
        a wrapped engine's parameters sharded first."""
        reshard(self.engine)
        with rows_.sliced(rows):
            state, metrics = fn(state, prepped)
            if rows is not None and metrics:
                keys = list(metrics)
                values = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=self.device)
                                      .reshape(()) for k in keys])
                metrics = dict(zip(keys, rows_.all_mean(values)))
        return state, metrics

    def _step(self, fn, state, prepped, rows=None) -> tuple[Any, dict]:
        """One step inside the profiler span, synced, with its host ms."""
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(STEP_SPAN):
            state, metrics = self._run(fn, state, prepped, rows)
            self._sync()
        step_ms = (time.perf_counter() - t0) * 1e3
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_ms"] = step_ms
        return state, metrics

    # -- fit ---------------------------------------------------------------

    def fit(self, batch_iter_factory: Callable[[], Iterable[dict]]):
        """Run training over batches from ``batch_iter_factory()`` per epoch;
        returns the engine's state."""
        with contextlib.ExitStack() as ctx:
            # a NeurosisProfiler callback with record_module_names: "[mod]" spans over the whole fit
            # (JAX's loop.py:286-295)
            for cb in self.callbacks:
                if getattr(cb, "record_module_names", False):
                    ctx.enter_context(record_module_names(getattr(cb, "capture_depth", -1)))
                    break
            ctx.enter_context(self._mesh_scope())
            return self._fit(batch_iter_factory)

    def _fit(self, batch_iter_factory):
        vae = hasattr(self.engine, "g_step")
        state = None
        global_step = 0
        epoch = 0
        try:
            while global_step < self.max_steps and (self.max_epochs is None or epoch < self.max_epochs):
                batch_idx = 0
                hooks = getattr(self.engine, "loss_hooks", ())
                with self._batches(batch_iter_factory, hooks) as batches:
                    for prepped, batch, data_ms, rows in batches:
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
                        state, metrics = self._step(fn, state, prepped, rows)
                        metrics["data_ms"] = data_ms
                        loss = metrics.get("loss")
                        for hook in hooks:
                            loss, metrics = hook.batch_hook(self.engine, batch, loss, metrics)
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
            # a blob write in flight is on a daemon thread, which dies with the interpreter:
            # finish it, so a job stopped by SIGTERM keeps its newest checkpoint
            for cb in self.callbacks:
                if getattr(cb, "blob", None) is not None:
                    try:
                        cb.blob.wait()
                    except Exception:
                        logger.exception(f"the checkpoint write to {cb.blob.base_url} failed")
            raise
        for cb in self.callbacks:
            if hasattr(cb, "on_fit_end"):
                cb.on_fit_end(self, state)
        return state

    def validate(self, batch_iter_factory, max_batches: Optional[int] = None) -> dict:
        """Loss-only evaluation: mean metrics over the dataset (no updates)."""
        with self._mesh_scope():
            return self._validate(batch_iter_factory, max_batches)

    def _validate(self, batch_iter_factory, max_batches: Optional[int]) -> dict:
        state = None
        sums: dict = {}
        n = 0
        with self._batches(batch_iter_factory) as batches:
            for prepped, _, _, rows in batches:
                if max_batches is not None and n >= max_batches:
                    break
                if state is None:
                    state = self._start("validate")
                state, metrics = self._run(self.engine.eval_step, state, prepped, rows)
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

    def _maybe_resume(self, state):
        """Restore the latest step in place (loop.py:567-640): from the blob
        store of ``remote_checkpoint_url`` when it holds one, else from
        ``<root>/checkpoints``; parameters, optimizer state, EMA and step,
        and mark the weights loaded. The generator is not restored (JAX
        saves no rng either). Where JAX logs a failed resume and starts
        fresh, this raises, so that a later save cannot rotate away a
        checkpoint it could not read."""
        if self.remote_checkpoint_url:
            check_store_reach(self.remote_checkpoint_url, self.mesh)
            blob = BlobCheckpointIO(self.remote_checkpoint_url, self.storage_options)
            latest = blob.latest_step()
            if latest is not None:
                load_state_payload(self.engine, state, blob.load_checkpoint(latest))
                self._weights_loaded = True
                logger.info(f"resumed from remote checkpoint step {latest} ({self.remote_checkpoint_url})")
                return state
        ckpt_dir = (self.root_dir / "checkpoints").absolute()
        steps = checkpoint_steps(ckpt_dir)
        if not steps:
            return state
        path = ckpt_dir / str(steps[-1]) / STATE_FILE
        load_state_payload(self.engine, state, load_checkpoint(path))
        self._weights_loaded = True
        logger.info(f"resumed from checkpoint step {steps[-1]} ({path})")
        return state

    def _crash_dump(self, state):
        """The trainable parameters at the failed step, gathered on every
        rank (a rank whose peers are gone fails here too), written by rank 0."""
        try:
            path = self.root_dir / f"last_exception.s{int(state.step)}.pt"
            params = {}
            for top, module in engine_modules(self.engine).items():
                params.update({f"{top}.{n}": full(p.detach()).cpu() for n, p in module.named_parameters()
                               if p.requires_grad})
            if self.mesh is not None and not self.mesh.is_writer:
                return
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({"step": int(state.step), "params": params}, path)
            logger.error(f"crash dump saved to {path}")
        except Exception:  # pragma: no cover
            logger.exception("failed to write crash dump")
