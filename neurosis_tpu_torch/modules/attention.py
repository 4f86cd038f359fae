"""Transformer blocks of the diffusion UNet (port of neurosis_tpu/modules/attention.py).

Tokens are [B, S, C]; SpatialTransformer reshapes NHWC in and out. Attention
goes through ``ops.attention.dot_product_attention`` (flash kernel for long
rows). With ``use_checkpoint`` each transformer block runs under
non-reentrant ``torch.utils.checkpoint`` with the block's ``remat_policy``
(JAX modules/attention.py:241-292), a selective-checkpoint policy over the
dispatcher ops the block runs:

- ``full``: keep nothing, recompute the block in the backward;
- ``dots``: keep the matmuls without batch dims (``aten.mm``/``addmm``: the
  projections, JAX's ``dots_with_no_batch_dims_saveable``);
- ``dots_all``: keep every matmul output (also ``bmm``/``baddbmm``);
- ``names``: keep the flash forward's outputs, o and LSE
  (``neurosis::flash_fwd``, JAX's ``attn_out``/``attn_lse``), and the ring's
  (``neurosis::ring_attention``, JAX's ``attn_out`` of the ring), so the
  backward launches neither the forward kernel nor the ring again;
- ``dots_names``: both of ``dots_all`` and ``names``;
- ``none``: no checkpoint.

Eager recompute re-runs every op it does not keep, so where JAX's compiler
drops the work behind a kept value, the port repeats it: the plain attention
of short rows is recomputed under every policy but ``none``.

With ``context_axis`` the self-attention (``context is None``) of every
block rides the ring of that mesh axis (``ops/attention.py``); a block that
recomputes it in the backward does so on every rank of the ring, in the
same order, since every context rank runs the same graph.

Dropout draws from the generator a caller passes down (none: deterministic).
Inside a checkpointed block it draws from a copy of that generator's state,
so the recompute draws the same masks.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike
from ..ops import ring_attention  # noqa: F401  (registers neurosis::ring_attention)
from ..ops.attention import dot_product_attention
from .layers import Conv2d, Dense, GroupNorm32, LayerNorm32, dropout

REMAT_POLICIES = ("full", "dots", "dots_all", "names", "dots_names", "none")


@functools.lru_cache(maxsize=None)
def _saved_ops(policy: str) -> frozenset:
    aten = torch.ops.aten
    saved = set()
    if policy in ("dots", "dots_all", "dots_names"):
        saved |= {aten.mm.default, aten.addmm.default}
    if policy in ("dots_all", "dots_names"):
        saved |= {aten.bmm.default, aten.baddbmm.default}
    if policy in ("names", "dots_names"):
        saved |= {torch.ops.neurosis.flash_fwd.default, torch.ops.neurosis.ring_attention.default}
    return frozenset(saved)


def _context_fn(policy: str):
    """The selective-checkpoint contexts of ``policy`` (None for ``full``)."""
    if policy == "full":
        return None
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = _saved_ops(policy)

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def checkpointed(block: nn.Module, policy: str, x: torch.Tensor, context: Optional[torch.Tensor],
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x, context, generator)`` under ``policy``'s checkpoint. A
    generator is replaced by a fresh one from its state, in the forward and
    in the recompute alike, and left where the forward's draws took it."""
    if generator is None:
        fn = block
    else:
        start = generator.get_state()
        end = {}

        def fn(x, context, _):
            g = torch.Generator(generator.device)
            g.set_state(start)
            out = block(x, context, g)
            end["state"] = g.get_state()
            return out

    kwargs = {"use_reentrant": False, "preserve_rng_state": False}
    context_fn = _context_fn(policy)
    if context_fn is not None:
        kwargs["context_fn"] = context_fn
    out = checkpoint(fn, x, context, None, **kwargs)
    if generator is not None:
        generator.set_state(end["state"])
    return out


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype=None, device: DeviceLike = None):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)  # exact (erf) gelu, as torch's default


class FeedForward(nn.Module):
    """GEGLU → dropout → Dense; ``net.1`` is the reference's dropout slot."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4, dropout: float = 0.0,
                 dtype=None, device: DeviceLike = None):
        super().__init__()
        inner = int(dim * mult)
        self.dropout = dropout
        self.net = nn.Sequential(
            GEGLU(dim, inner, dtype=dtype, device=device),
            nn.Identity(),
            Dense(inner, dim_out or dim, dtype=dtype, device=device),
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.net[2](dropout(self.net[0](x), self.dropout, generator))


class CrossAttention(nn.Module):
    """Self-attention (context=None) or cross-attention over [B, S, C];
    self-attention rides the ring of ``context_axis`` when one is set."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0, dtype=None, device: DeviceLike = None,
                 context_axis: Optional[str] = None):
        super().__init__()
        self.context_axis = context_axis
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_k = Dense(ctx_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_v = Dense(ctx_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_out = nn.Sequential(Dense(inner, query_dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, s, _ = x.shape
        t = ctx.shape[1]
        q = self.to_q(x).reshape(b, s, self.heads, self.dim_head).transpose(1, 2)
        k = self.to_k(ctx).reshape(b, t, self.heads, self.dim_head).transpose(1, 2)
        v = self.to_v(ctx).reshape(b, t, self.heads, self.dim_head).transpose(1, 2)
        out = dot_product_attention(q, k, v, context_axis=self.context_axis if context is None else None)
        out = self.to_out(out.transpose(1, 2).reshape(b, s, self.heads * self.dim_head))
        return dropout(out, self.dropout, generator)


class BasicTransformerBlock(nn.Module):
    """norm→attn1(self)→res, norm→attn2(cross)→res, norm→ff→res."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None,
                 disable_self_attn: bool = False, dropout: float = 0.0, dtype=None, device: DeviceLike = None,
                 context_axis: Optional[str] = None):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.norm1 = LayerNorm32(dim, device=device)
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else None, n_heads, d_head, dropout,
                                    dtype=dtype, device=device, context_axis=context_axis)
        self.norm2 = LayerNorm32(dim, device=device)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dropout, dtype=dtype, device=device,
                                    context_axis=context_axis)
        self.norm3 = LayerNorm32(dim, device=device)
        self.ff = FeedForward(dim, dropout=dropout, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), context if self.disable_self_attn else None, generator)
        x = x + self.attn2(self.norm2(x), context, generator)
        return x + self.ff(self.norm3(x), generator)


class SpatialTransformer(nn.Module):
    """NHWC image ↔ token transformer (reference modules/attention.py:567-667):
    GroupNorm (eps 1e-6) → proj_in → blocks → zero-init proj_out → + input.
    With ``use_checkpoint`` each block runs under ``remat_policy``."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, disable_self_attn: bool = False,
                 use_linear: bool = False, use_checkpoint: bool = True, dtype=None,
                 device: DeviceLike = None, dropout: float = 0.0, remat_policy: str = "full",
                 context_axis: Optional[str] = None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; known: {REMAT_POLICIES}")
        inner = n_heads * d_head
        self.use_linear = use_linear
        self.use_checkpoint = use_checkpoint
        self.remat_policy = remat_policy
        self.norm = GroupNorm32(in_channels, 32, eps=1e-6, device=device)
        if use_linear:
            self.proj_in = Dense(in_channels, inner, dtype=dtype, device=device)
            self.proj_out = Dense(inner, in_channels, dtype=dtype, zero_init=True, device=device)
        else:
            self.proj_in = Conv2d(in_channels, inner, 1, padding=0, dtype=dtype, device=device)
            self.proj_out = Conv2d(inner, in_channels, 1, padding=0, dtype=dtype, zero_init=True,
                                   device=device)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim, disable_self_attn, dropout, dtype, device,
                                  context_axis)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x_in = x
        x = self.norm(x)
        if not self.use_linear:
            x = self.proj_in(x)
        x = x.reshape(b, h * w, x.shape[-1])
        if self.use_linear:
            x = self.proj_in(x)
        remat = self.use_checkpoint and self.remat_policy != "none" and torch.is_grad_enabled()
        for block in self.transformer_blocks:
            if remat:
                x = checkpointed(block, self.remat_policy, x, context, generator)
            else:
                x = block(x, context, generator)
        if self.use_linear:
            x = self.proj_out(x)
        x = x.reshape(b, h, w, x.shape[-1])
        if not self.use_linear:
            x = self.proj_out(x)
        return x + x_in
