"""Scaled dot-product attention dispatch (port of neurosis_tpu/ops/attention.py).

Long query rows without a mask go to the flash kernel; everything else
(77-token CLIP rows, short UNet levels, masks) takes the plain
matmul-softmax with fp32 logits (JAX ``_xla_attention``). There is no
fallback from the kernel: a shape or dtype the kernel refuses raises.

With ``context_axis`` (JAX ops/attention.py:96-148), self-attention rides
the ring that the ambient mesh gives that axis (``ring_attention.on_axis``,
which the trainer enters during fit): each rank of the context group runs
its slice of the query rows round the ring and every rank gets the whole O.
Without such a ring, with a ring of one rank, or with S not divisible by
its size, the whole sequence runs on one program, as in JAX (:149-151).

Layout: [B, H, S, D].
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from .ring_attention import ring_of, ring_self_attention

# query length from which the flash kernel takes a row (JAX _PALLAS_MIN_SEQ)
FLASH_MIN_SEQ = 512


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v with fp32 logits and softmax, weights cast back to
    q's dtype before the product with v. ``mask`` is boolean, True = keep."""
    scale = 1.0 / q.shape[-1] ** 0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def uses_flash(q: torch.Tensor, mask: Optional[torch.Tensor]) -> bool:
    """Unmasked rows of at least FLASH_MIN_SEQ queries go to the kernel (JAX
    ops/attention.py:152), whatever their dtype and head dim; on the card
    every bf16 or fp32 row with d <= 512 reaches one (padded to the head dim
    it is built for), fp16 and d > 512 raise."""
    return mask is None and q.shape[-2] >= FLASH_MIN_SEQ


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    context_axis: Optional[str] = None,
) -> torch.Tensor:
    ring = ring_of(context_axis)
    if ring is not None and ring.n > 1 and q.shape[-2] % ring.n == 0:
        if mask is not None:
            raise ValueError("ring attention takes no mask")
        return ring_self_attention(q, k, v, ring)
    if uses_flash(q, mask):
        return flash_attention(q, k, v)
    return plain_attention(q, k, v, mask)
