"""Transformer blocks of the diffusion UNet (port of neurosis_tpu/modules/attention.py).

Tokens are [B, S, C]; SpatialTransformer reshapes NHWC in and out. Attention
goes through ``ops.attention.dot_product_attention`` (flash kernel for long
bf16 rows). With ``use_checkpoint`` each transformer block is recomputed in
the backward pass (JAX ``remat_policy="full"``) through non-reentrant
``torch.utils.checkpoint``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike
from ..ops.attention import dot_product_attention
from .layers import Conv2d, Dense, GroupNorm32, LayerNorm32


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype=None, device: DeviceLike = None):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)  # exact (erf) gelu, as torch's default


class FeedForward(nn.Module):
    """GEGLU → Dense; ``net.1`` is the reference's (here empty) dropout slot."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4, dtype=None,
                 device: DeviceLike = None):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(
            GEGLU(dim, inner, dtype=dtype, device=device),
            nn.Identity(),
            Dense(inner, dim_out or dim, dtype=dtype, device=device),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class CrossAttention(nn.Module):
    """Self-attention (context=None) or cross-attention over [B, S, C]."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, dtype=None, device: DeviceLike = None):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_k = Dense(ctx_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_v = Dense(ctx_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_out = nn.Sequential(Dense(inner, query_dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, s, _ = x.shape
        t = ctx.shape[1]
        q = self.to_q(x).reshape(b, s, self.heads, self.dim_head).transpose(1, 2)
        k = self.to_k(ctx).reshape(b, t, self.heads, self.dim_head).transpose(1, 2)
        v = self.to_v(ctx).reshape(b, t, self.heads, self.dim_head).transpose(1, 2)
        out = dot_product_attention(q, k, v)
        return self.to_out(out.transpose(1, 2).reshape(b, s, self.heads * self.dim_head))


class BasicTransformerBlock(nn.Module):
    """norm→attn1(self)→res, norm→attn2(cross)→res, norm→ff→res."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None,
                 disable_self_attn: bool = False, dtype=None, device: DeviceLike = None):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.norm1 = LayerNorm32(dim, device=device)
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else None, n_heads, d_head,
                                    dtype=dtype, device=device)
        self.norm2 = LayerNorm32(dim, device=device)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dtype=dtype, device=device)
        self.norm3 = LayerNorm32(dim, device=device)
        self.ff = FeedForward(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), context if self.disable_self_attn else None)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """NHWC image ↔ token transformer (reference modules/attention.py:567-667):
    GroupNorm (eps 1e-6) → proj_in → blocks → zero-init proj_out → + input."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, disable_self_attn: bool = False,
                 use_linear: bool = False, use_checkpoint: bool = True, dtype=None,
                 device: DeviceLike = None):
        super().__init__()
        inner = n_heads * d_head
        self.use_linear = use_linear
        self.use_checkpoint = use_checkpoint
        self.norm = GroupNorm32(in_channels, 32, eps=1e-6, device=device)
        if use_linear:
            self.proj_in = Dense(in_channels, inner, dtype=dtype, device=device)
            self.proj_out = Dense(inner, in_channels, dtype=dtype, zero_init=True, device=device)
        else:
            self.proj_in = Conv2d(in_channels, inner, 1, padding=0, dtype=dtype, device=device)
            self.proj_out = Conv2d(inner, in_channels, 1, padding=0, dtype=dtype, zero_init=True,
                                   device=device)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim, disable_self_attn, dtype, device)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x_in = x
        x = self.norm(x)
        if not self.use_linear:
            x = self.proj_in(x)
        x = x.reshape(b, h * w, x.shape[-1])
        if self.use_linear:
            x = self.proj_in(x)
        for block in self.transformer_blocks:
            if self.use_checkpoint and torch.is_grad_enabled():
                x = checkpoint(block, x, context, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, context)
        if self.use_linear:
            x = self.proj_out(x)
        x = x.reshape(b, h, w, x.shape[-1])
        if not self.use_linear:
            x = self.proj_out(x)
        return x + x_in
