"""Background prefetch of the host input pipeline (port of
neurosis_tpu/data/prefetch.py; the reference uses DataLoader workers,
imagefolder/aspect.py:256-265).

``dataset.get_batch(indices)`` runs ahead of the train step in spawned
worker processes (``"process"``, the default: decoding holds the GIL) or in
threads (``"thread"``), at most ``buffer_size`` batches ahead, and the
batches come back in submission order. A worker's exception is raised to
the consumer. A dataset that cannot be pickled falls back to threads with a
warning, as in the JAX package.

Each batch draws its crops and tag shuffles from its own generator, seeded
in this process from the dataset's generator in submission order
(``seeded_batches``); the in-process loader does the same, so the batches
and their order are those of ``num_workers: 0`` in every mode. (The JAX
package's workers draw from per-worker copies of the dataset's generator,
so its batches change with the worker count.)

Worker processes start with ``CUDA_VISIBLE_DEVICES=""`` in their
environment from their first instruction (the counterpart of JAX's
``JAX_PLATFORMS=cpu``): a child never creates a context on the card.
Tokenizing and the copy to the device stay in the main process.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import pickle
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

WORKER_ENV = {"CUDA_VISIBLE_DEVICES": "", "NEUROSIS_WORKER": "1"}
_WORKER_DATASET = None


def seeded_batches(dataset, batch_indices: Iterable[list]) -> Iterator[tuple[list, Optional[int]]]:
    """(indices, seed) of each batch, the seed drawn from the dataset's
    generator here, in order (None for a dataset without one)."""
    rng = getattr(dataset, "rng", None)
    for indices in batch_indices:
        yield indices, None if rng is None else int(rng.integers(2**63))


def get_batch(dataset, indices: list, seed: Optional[int]) -> dict:
    """One batch, its draws from the generator of ``seed``."""
    if seed is None:
        return dataset.get_batch(indices)
    return dataset.get_batch(indices, rng=np.random.default_rng(seed))


def _in_order(submit: Callable, jobs: Iterable[tuple], depth: int) -> Iterator:
    """Results of ``submit(*job)`` (each a callable that waits for its
    result) in submission order, at most ``depth`` outstanding."""
    pending: collections.deque = collections.deque()
    for job in jobs:
        pending.append(submit(*job))
        if len(pending) >= depth:
            yield pending.popleft()()
    while pending:
        yield pending.popleft()()


def prefetch_batches(dataset, batch_indices: Iterable[list], num_workers: int = 2,
                     buffer_size: int = 4) -> Iterator[dict]:
    """Batches loaded by a pool of ``num_workers`` threads, in order."""
    from concurrent.futures import ThreadPoolExecutor

    def gen():
        pool = ThreadPoolExecutor(max_workers=num_workers)
        try:
            yield from _in_order(lambda idx, seed: pool.submit(get_batch, dataset, idx, seed).result,
                                 seeded_batches(dataset, batch_indices), buffer_size)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    return gen()


@contextlib.contextmanager
def _environ(env: dict):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _proc_init(dataset_blob: bytes) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = pickle.loads(dataset_blob)


def _proc_get_batch(indices: list, seed: Optional[int]) -> dict:
    return get_batch(_WORKER_DATASET, indices, seed)


def prefetch_batches_processes(dataset, batch_indices: Iterable[list], num_workers: int = 2,
                               buffer_size: int = 4) -> Iterator[dict]:
    """Batches loaded by ``num_workers`` spawned processes, in order. The
    dataset is pickled once; the workers start when the first batches are
    asked for and stop when the iterator ends or is closed. A worker that
    dies raises ``BrokenProcessPool`` here rather than hang."""
    try:
        blob = pickle.dumps(dataset)
    except Exception as e:
        logger.warning(f"dataset not picklable ({e}) — falling back to thread prefetch")
        return prefetch_batches(dataset, batch_indices, num_workers, buffer_size)

    def gen():
        from concurrent.futures import ProcessPoolExecutor
        from multiprocessing import get_context

        pool = ProcessPoolExecutor(max_workers=num_workers, mp_context=get_context("spawn"),
                                   initializer=_proc_init, initargs=(blob,))

        def submit(indices, seed):
            with _environ(WORKER_ENV):  # a process the pool starts in this call inherits it
                return pool.submit(_proc_get_batch, indices, seed).result

        try:
            yield from _in_order(submit, seeded_batches(dataset, batch_indices), max(buffer_size, num_workers))
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    return gen()


def make_prefetcher(mode: str = "process"):
    """'process' | 'thread' → the matching prefetch function."""
    if mode not in ("process", "thread"):
        raise ValueError(f"prefetch mode {mode!r}: 'process' or 'thread'")
    return prefetch_batches_processes if mode == "process" else prefetch_batches
