"""Checkpoints in a blob store (port of neurosis_tpu/checkpoint/blob.py;
parity: trainer/checkpoint_io.py:17-62, BlobCheckpointIO).

Layout: ``<base_url>/step_<NNNNNNNN>.pt``, each a ``torch.save`` of the
trainer's ``state_payload`` (``trainer/callbacks.py``, format
``neurosis_tpu_torch/1``), read back with ``weights_only=True``. The JAX
package writes flax msgpack files (``step_*.msgpack``) in the same layout;
the port cannot read them, and a base that holds any raises, naming them.

The payload is serialized into memory on the caller's thread (the copy off
the card has to happen there anyway) and written through ``utils/fs.py``
(the port's ``file`` and ``memory`` backends, fsspec for other schemes) on a
daemon thread: at most one write is in flight, and the next save or
``wait()`` joins it.
"""

from __future__ import annotations

import io
import logging
import re
import threading
import time
from typing import Optional

import torch

from ..utils.fs import url_to_fs

logger = logging.getLogger(__name__)

_STEP_RE = re.compile(r"step_(\d+)\.pt$")
_JAX_STEP_RE = re.compile(r"step_(\d+)\.msgpack$")


class BlobCheckpointIO:
    """Save, load, list and prune checkpoints under a base URL."""

    def __init__(self, base_url: str, storage_options: Optional[dict] = None, filesystem=None):
        self.base_url = str(base_url).rstrip("/")
        self.storage_options = dict(storage_options or {})
        self._fs = filesystem
        self._base_path: Optional[str] = None
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # seconds of the last save's serialization, of its write, and waited on a write in flight
        self.last_serialize_s = self.last_write_s = self.waited_s = 0.0
        self.last_bytes = 0

    # -- filesystem ---------------------------------------------------------

    @property
    def fs(self):
        if self._fs is None:
            self._fs, self._base_path = url_to_fs(self.base_url, **self.storage_options)
        return self._fs

    @property
    def base_path(self) -> str:
        if self._base_path is None:
            _ = self.fs  # resolves both
            if self._base_path is None:  # an injected filesystem: the URL without its scheme
                self._base_path = self.base_url.split("://", 1)[-1]
        return self._base_path

    def _path(self, step: int) -> str:
        return f"{self.base_path}/step_{int(step):08d}.pt"

    def _url(self, step: int) -> str:
        return f"{self.base_url}/step_{int(step):08d}.pt"

    # -- save ---------------------------------------------------------------

    def save_checkpoint(self, payload: dict, step: int, keep: int = 0) -> str:
        """Serialize ``payload`` now and write it on a daemon thread; with
        ``keep`` > 0 the write is followed by ``prune(keep)``, so the pruning
        sees this step (the JAX callback prunes while the write is in flight,
        and keeps one more until the next save)."""
        t0 = time.perf_counter()
        buf = io.BytesIO()
        torch.save(payload, buf)
        data = buf.getvalue()
        self.last_serialize_s, self.last_bytes = time.perf_counter() - t0, len(data)
        path = self._path(step)
        self.wait()  # at most one write in flight

        def write():
            t1 = time.perf_counter()
            try:
                self.fs.makedirs(self.base_path, exist_ok=True)
            except OSError:
                pass  # some blob stores have no real directories
            with self.fs.open(path, "wb") as f:
                f.write(data)
            self.last_write_s = time.perf_counter() - t1
            logger.info(f"checkpoint written to {self._url(step)} ({len(data)} bytes)")
            if keep > 0:
                self.prune(keep)

        def guarded():
            try:
                write()
            except Exception as e:  # raised again by wait()
                self._error = e

        self._pending = threading.Thread(target=guarded, daemon=True, name="blob-ckpt-write")
        self._pending.start()
        return path

    def wait(self) -> None:
        """Join the write in flight; a write that failed raises here."""
        t0 = time.perf_counter()
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self.waited_s = time.perf_counter() - t0
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"the checkpoint write to {self.base_url} failed: {error!r}") from error

    # -- load / list / remove ------------------------------------------------

    def list_steps(self) -> list:
        """The saved steps, oldest first; JAX's msgpack steps raise."""
        try:
            names = [str(n) for n in self.fs.ls(self.base_path, detail=False)]
        except FileNotFoundError:
            return []
        jax_steps = [n.rsplit("/", 1)[-1] for n in names if _JAX_STEP_RE.search(n)]
        if jax_steps:
            raise ValueError(f"{self.base_url} holds checkpoints of the JAX package ({', '.join(sorted(jax_steps))}): "
                             "flax msgpack, which the port cannot read")
        return sorted(int(m.group(1)) for m in map(_STEP_RE.search, names) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def load_checkpoint(self, step: int) -> dict:
        """The payload of ``step``, on the CPU."""
        path = self._path(step)
        if not self.fs.isfile(path):
            raise FileNotFoundError(f"checkpoint not found: {self._url(step)}")
        with self.fs.open(path, "rb") as f:
            data = f.read()
        try:
            return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
        except Exception as e:
            raise ValueError(f"cannot read checkpoint {self._url(step)}: {e}") from e

    def remove_checkpoint(self, step: int) -> None:
        path = self._path(step)
        if self.fs.isfile(path):
            self.fs.rm(path)
            logger.debug(f"removed checkpoint {path}")

    def prune(self, keep: int) -> None:
        """Keep the newest ``keep`` checkpoints."""
        steps = self.list_steps()
        for s in steps[:-keep] if keep > 0 else []:
            self.remove_checkpoint(s)


def is_remote_url(path: Optional[str]) -> bool:
    """True for fsspec URLs (gs://, s3://, memory://, ...), not local paths
    or file:// URLs."""
    return bool(path) and "://" in str(path) and not str(path).startswith("file://")
