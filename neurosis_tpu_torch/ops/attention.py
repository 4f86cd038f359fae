"""Scaled dot-product attention dispatch (port of neurosis_tpu/ops/attention.py).

Long query rows without a mask go to the flash kernel; everything else
(77-token CLIP rows, short UNet levels, masks) takes the plain
matmul-softmax with fp32 logits (JAX ``_xla_attention``). There is no
fallback from the kernel: a shape or dtype the kernel refuses raises.

Layout: [B, H, S, D].
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention

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
    ops/attention.py:152); on the card it takes bf16 and raises otherwise."""
    return mask is None and q.shape[-2] >= FLASH_MIN_SEQ


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if uses_flash(q, mask):
        return flash_attention(q, k, v)
    return plain_attention(q, k, v, mask)
