"""Ring attention over the context group (port of neurosis_tpu/ops/ring_attention.py).

Sequence parallelism for long spatial sequences: the n ranks of a context
group each hold a slice of S/n query rows, and the key/value slices travel
round the ring, rank i sending to rank (i + 1) % n, so that after n - 1
rotations every rank has met every slice. Each meeting is one block of
attention, q of S/n rows against kv of S/n rows, and the blocks' partial
results merge through their softmax statistics into the exact softmax over
the whole sequence.

``ring_self_attention(q, k, v, ring)`` takes the whole [B, H, S, D] q, k, v
that every rank of the group holds (the rest of a UNet block runs on the
whole sequence on every context rank, as JAX's replicated parameters imply),
runs this rank's slice of queries round the ring and all-gathers O along S.
Its backward takes this rank's slice of dO, runs the ring again (Di =
rowsum(dO∘O) once; each hop adds its block's dq and hands the dk/dv
accumulators on with k and v, so that after n hops each rank holds the dk
and dv of its own slice) and all-gathers dq, dk and dv along S, so every
context rank ends with the same whole gradients.

The blocks:

- where a slice passes the flash gate (``ops/attention.py``: at least
  ``FLASH_MIN_SEQ`` rows), each block runs the port's flash kernels:
  ``flash_fwd`` gives (o, LSE in log2 units) and the blocks merge in fp32;
  the backward is ``flash_bwd`` with the merged LSE and the merged O's Di,
  which gives each block its exact share of the gradient;
- other blocks take JAX's plain ``attention_with_stats`` and ``merge`` (the
  unnormalised O in q's dtype, the row max and row sum), and the plain block
  backward with the merged log-sum-exp. On the CPU every kernel wrapper runs
  its plain version.

The ring loop is written once over a ``rotate`` step: ``P2PRing`` passes
the slices between the ranks of a process group with ``batch_isend_irecv``
(NCCL on the card, gloo on the CPU); ``LocalRing`` holds all n slices in
one process and rotates them in place, which checks the ring on one card.
A ring is found by name, so the forward can be a dispatcher op
(``torch.ops.neurosis.ring_attention``) that the ``names`` remat policies
keep, as JAX names the ring's output ``attn_out``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from .flash_attention import LOG2_E, flash_bwd, flash_fwd


# ---------------------------------------------------------------------------
# the plain blocks (JAX ring_attention.py:25-44, in JAX's order and casts)
# ---------------------------------------------------------------------------


def attention_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax attention as (unnormalised o in q's dtype, row max m, row sum l)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(q.dtype), v)
    return o, m, l


def merge(o1, m1, l1, o2, m2, l2):
    """Two unnormalised blockwise results combined."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1[..., None].to(o1.dtype) + o2 * a2[..., None].to(o2.dtype)
    l = l1 * a1 + l2 * a2
    return o, m, l


def plain_block_bwd(q, k, v, do, lse, di, scale: float):
    """A plain block's (dq, dk, dv) in fp32 from the merged natural-log LSE
    and Di: P = exp(q·kᵀ·scale − LSE), dS = P∘(dO·vᵀ − Di)."""
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - di[..., None])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the flash blocks: (o, LSE base 2) merged in fp32
# ---------------------------------------------------------------------------


def _merge_lse(o1, lse1, o2, lse2):
    """Two normalised blockwise results (fp32 o) and their base-2 LSEs combined."""
    lse = torch.maximum(lse1, lse2)
    a1, a2 = torch.exp2(lse1 - lse), torch.exp2(lse2 - lse)
    s = a1 + a2
    return (o1 * (a1 / s)[..., None] + o2 * (a2 / s)[..., None]), lse + torch.log2(s)


# ---------------------------------------------------------------------------
# rings: where the slices live and how they move
# ---------------------------------------------------------------------------

_RINGS: dict = {}


class P2PRing:
    """This rank's slice of a context process group: one slot, the slices
    passed to rank (i + 1) % n and taken from rank (i − 1) % n."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.n = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.index + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.index - 1) % self.n)
        self.name = f"p2p:{group.group_name}"
        _RINGS[self.name] = self

    def slots(self, x: torch.Tensor) -> list:
        """This process's slices of ``x`` along S (axis 2)."""
        return [x.chunk(self.n, dim=2)[self.index]]

    def rotate(self, *quantities: list) -> tuple:
        """Each quantity's slot sent on and the previous rank's taken in."""
        import torch.distributed as dist

        sends = [q[0].contiguous() for q in quantities]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [op for s, r in zip(sends, recvs) for op in (dist.P2POp(dist.isend, s, self.next, self.group),
                                                           dist.P2POp(dist.irecv, r, self.prev, self.group))]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple([r] for r in recvs)

    def gather(self, parts: list) -> torch.Tensor:
        """This rank's slice gathered with the others' along S."""
        import torch.distributed as dist

        part = parts[0].contiguous()
        out = [torch.empty_like(part) for _ in range(self.n)]
        dist.all_gather(out, part, group=self.group)
        return torch.cat(out, dim=2)


class LocalRing:
    """All n slices in this process: a rotation moves slot i's to slot
    i + 1 (no copy). It checks the ring's kernels and merges on one card;
    the dispatch never picks it by itself."""

    def __init__(self, n: int):
        self.n = n
        self.name = f"local:{n}"
        _RINGS[self.name] = self

    def slots(self, x: torch.Tensor) -> list:
        return list(x.chunk(self.n, dim=2))

    def rotate(self, *quantities: list) -> tuple:
        return tuple([q[-1]] + q[:-1] for q in quantities)

    def gather(self, parts: list) -> torch.Tensor:
        return torch.cat(parts, dim=2)


def uses_flash_blocks(rows: int) -> bool:
    """A ring's blocks take the flash kernels when its slices pass the flash
    gate (``ops/attention.py``'s ``FLASH_MIN_SEQ`` query rows)."""
    from .attention import FLASH_MIN_SEQ

    return rows >= FLASH_MIN_SEQ


# ---------------------------------------------------------------------------
# the ring loop, written once over ring.rotate
# ---------------------------------------------------------------------------


def ring_forward(ring, qs: list, ks: list, vs: list, flash: Optional[bool] = None) -> tuple[list, list]:
    """(o, LSE) of each of this process's slots: plain blocks → (o in q's
    dtype, natural-log LSE), flash blocks → (o in q's dtype, base-2 LSE) from
    q̃ = q·scale·log2(e) in q's dtype. ``flash`` overrides the gate (the
    plain ring that a check holds the kernels' against)."""
    flash = uses_flash_blocks(qs[0].shape[2]) if flash is None else flash
    if flash:
        scale = 1.0 / math.sqrt(qs[0].shape[-1])
        qx = [(q * (scale * LOG2_E)).to(q.dtype) for q in qs]
        acc = [(o.float(), lse) for o, lse in (flash_fwd(q, k, v) for q, k, v in zip(qx, ks, vs))]
    else:
        acc = [attention_with_stats(q, k, v) for q, k, v in zip(qs, ks, vs)]
    for _ in range(ring.n - 1):
        ks, vs = ring.rotate(ks, vs)
        if flash:
            acc = [_merge_lse(*a, o.float(), lse) for a, (o, lse) in
                   zip(acc, (flash_fwd(q, k, v) for q, k, v in zip(qx, ks, vs)))]
        else:
            acc = [merge(*a, *attention_with_stats(q, k, v)) for a, q, k, v in zip(acc, qs, ks, vs)]
    if flash:
        return [o.to(q.dtype) for (o, _), q in zip(acc, qs)], [lse for _, lse in acc]
    return [(o / l[..., None].to(o.dtype)) for o, _, l in acc], [m + torch.log(l) for _, m, l in acc]


def ring_backward(ring, qs: list, ks: list, vs: list, os: list, lses: list, dos: list,
                  flash: Optional[bool] = None) -> tuple[list, list, list]:
    """(dq, dk, dv) of each slot's slices, in the inputs' dtypes, from
    ``ring_forward``'s (o, LSE) with the same ``flash``."""
    flash = uses_flash_blocks(qs[0].shape[2]) if flash is None else flash
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    dis = [(do.float() * o.float()).sum(dim=-1) for do, o in zip(dos, os)]
    qx = [(q * (scale * LOG2_E)).to(q.dtype) for q in qs] if flash else qs
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    for hop in range(ring.n):
        if hop:
            ks, vs, dks, dvs = ring.rotate(ks, vs, dks, dvs)
        for i, (q, k, v, do, lse, di) in enumerate(zip(qx, ks, vs, dos, lses, dis)):
            if flash:
                gq, gk, gv = flash_bwd(q, k, v, do, lse, di, scale)
            else:
                gq, gk, gv = plain_block_bwd(q, k, v, do, lse, di, scale)
            dqs[i] += gq
            dks[i] += gk
            dvs[i] += gv
    dks, dvs = ring.rotate(dks, dvs)  # each accumulator home to the rank of its slice
    return ([g.to(q.dtype) for g, q in zip(dqs, qs)], [g.to(k.dtype) for g, k in zip(dks, ks)],
            [g.to(v.dtype) for g, v in zip(dvs, vs)])


# ---------------------------------------------------------------------------
# the dispatcher op and the autograd entry
# ---------------------------------------------------------------------------


def _ring(name: str):
    if name not in _RINGS:
        raise KeyError(f"no ring named {name!r}")
    return _RINGS[name]


@torch.library.custom_op("neurosis::ring_attention", mutates_args=(), device_types=("cpu", "cuda"))
def ring_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(O over the whole sequence, this process's slots' LSEs concatenated on S)."""
    r = _ring(ring)
    os, lses = ring_forward(r, r.slots(q), r.slots(k), r.slots(v))
    return r.gather(os), torch.cat(lses, dim=2)


@ring_attention_op.register_fake
def _(q, k, v, ring):
    r = _ring(ring)
    rows = sum(s.shape[2] for s in r.slots(q))
    return torch.empty_like(q), q.new_empty(q.shape[:2] + (rows,), dtype=torch.float32)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, name):
        o, lse = ring_attention_op(q, k, v, name)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.name = name
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        r = _ring(ctx.name)
        qs = r.slots(q)
        lses = list(lse.split([s.shape[2] for s in qs], dim=2))
        grads = ring_backward(r, qs, r.slots(k), r.slots(v), r.slots(o), lses, r.slots(do))
        return (*(r.gather(g) for g in grads), None)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over the whole [B, H, S, D] sequence that every
    rank of ``ring`` holds, its query rows split over the ring (S divisible
    by ``ring.n``); differentiable."""
    if q.shape[2] % ring.n or k.shape[2] != q.shape[2]:
        raise ValueError(f"ring self-attention over {ring.n} slices needs S divisible by it and kv of q's "
                         f"length, got {tuple(q.shape)} and {tuple(k.shape)}")
    ring_self_attention.calls += 1
    return _Ring.apply(q, k, v, ring.name)


ring_self_attention.calls = 0  # forward calls, for checks that a path rode the ring


# ---------------------------------------------------------------------------
# the ambient context axis (JAX's ``with mesh:``)
# ---------------------------------------------------------------------------

_AXES: dict = {}


@contextlib.contextmanager
def on_axis(axis: str, ring):
    """Within the block, self-attention whose module names ``axis`` rides
    ``ring`` (the trainer enters it for a mesh's context axis during fit)."""
    outer = _AXES.get(axis)
    _AXES[axis] = ring
    try:
        yield ring
    finally:
        if outer is None:
            _AXES.pop(axis, None)
        else:
            _AXES[axis] = outer


def ring_of(axis: Optional[str]):
    """The ring the ambient mesh gives ``axis``, or None."""
    return None if axis is None else _AXES.get(axis)
