"""The rows of the global batch this rank holds, and the batch-wide draws
and statistics that make a rank's step the one-card step.

Under JAX's mesh a step is one program over the global batch: every draw
and every batch statistic is the global one, and XLA inserts the
collectives. Here each rank runs its own rows, so while a step runs under
``sliced(rows)``:

- ``draw`` makes a per-row draw for the whole global batch from the run's
  generator (seeded alike on every rank) and keeps this rank's rows, so the
  generator advances as the one-card step's does and every row gets its
  one-card value (t, noise, posterior noise, UCG masks, dropout, Gumbel);
- ``batch_mean`` and ``all_sum`` reduce over ``rows.group``, the ranks that
  hold the other rows (the discriminator's BatchNorm, ActNorm's first-batch
  init, the EMA codebook's counts, the adaptive GAN weight's gradients);
- ``gather`` gives a per-row vector of the whole batch (the ``log_sigmas``
  metrics).

Outside ``sliced`` (one card, or a batch every rank holds whole) each is the
plain local operation.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Rows:
    """Rows [start, stop) of a global batch of ``total``; ``group`` is the
    process group over which the rows differ, its ranks in row order."""

    start: int
    stop: int
    total: int
    group: Any = None

    @property
    def count(self) -> int:
        return self.stop - self.start


_CURRENT: Optional[Rows] = None


def current() -> Optional[Rows]:
    return _CURRENT


@contextlib.contextmanager
def sliced(rows: Optional[Rows]):
    """Run the block as this rank's part of a step over ``rows``' global batch."""
    global _CURRENT
    outer, _CURRENT = _CURRENT, rows
    try:
        yield
    finally:
        _CURRENT = outer


def draw(fn: Callable, shape: Sequence[int], **kwargs) -> torch.Tensor:
    """``fn(shape, **kwargs)`` (``torch.rand``, ``torch.randn``) for a
    per-row ``shape`` ([rows, ...]): drawn for the global batch and sliced to
    this rank's rows under ``sliced``."""
    rows = _CURRENT
    shape = tuple(shape)
    if rows is None or not shape:
        return fn(shape, **kwargs)
    if shape[0] != rows.count:
        raise ValueError(f"a per-row draw of shape {shape} on a rank that holds {rows.count} rows")
    return fn((rows.total,) + shape[1:], **kwargs)[rows.start:rows.stop]


class _AllSum(torch.autograd.Function):
    """A sum over ``group`` whose backward sums the gradients over it: each
    rank's loss reaches every rank's rows through the shared statistic."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group, differentiable=False)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, differentiable=False), None


def _all_reduce(x: torch.Tensor, group, differentiable: bool) -> torch.Tensor:
    import torch.distributed as dist

    if differentiable:
        return _AllSum.apply(x, group)
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the batch's rows (no grad)."""
    rows = _CURRENT
    if rows is None:
        return x
    return _all_reduce(x, rows.group, differentiable=False)


def all_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over those ranks of a per-rank mean of equal row counts:
    the global batch's mean (no grad)."""
    rows = _CURRENT
    if rows is None:
        return x
    return all_sum(x) * (rows.count / rows.total)


def batch_mean(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``x.mean(dims)`` over the global batch (``dims`` holds the rows'
    axis 0), differentiable: the sum all-reduced, over the global count."""
    rows = _CURRENT
    if rows is None:
        return x.mean(dim=tuple(dims))
    count = rows.total
    for d in dims:
        if d % x.ndim:
            count *= x.shape[d]
    return _all_reduce(x.sum(dim=tuple(dims)), rows.group, differentiable=True) / count


def gather(x: torch.Tensor) -> torch.Tensor:
    """A per-row tensor of this rank → the global batch's, in row order (no grad)."""
    rows = _CURRENT
    if rows is None:
        return x
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(rows.group))]
    dist.all_gather(parts, x.contiguous(), group=rows.group)
    return torch.cat(parts)
