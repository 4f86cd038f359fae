"""Common building blocks, NHWC (port of neurosis_tpu/modules/layers.py).

Parameters are fp32 and held in torch shapes (Linear (out, in), Conv OIHW)
under the names ``export_torch_state`` gives the JAX parameters. A module
computes in ``dtype`` when one is set, else in the promotion of its input
with fp32 (flax ``promote_dtype``); norms always compute in fp32.

Parameters are created empty on ``device`` and filled by
``init_parameters(module, generator)``, which every entry point calls with
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..ops.conv3x3 import conv3x3, conv3x3_supported, gn_silu_conv3x3
from ..ops.groupnorm import group_norm
from ..parallel import rows

# flax lecun_normal draws a normal truncated at ±2σ, rescaled to keep var 1/fan_in
_TRUNC_STD = 0.87962566103423978


def compute_dtype(module_dtype: Optional[torch.dtype], x_dtype: torch.dtype) -> torch.dtype:
    """The dtype a Dense/Conv2d computes in (JAX ``conv_compute_dtype``)."""
    return module_dtype or torch.promote_types(x_dtype, torch.float32)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` with the JAX package's default init
    (lecun-normal kernels, zero biases, unit norm scales, zero-init where
    the JAX module asks for it), drawing from ``generator``."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv2d, GroupNorm32, LayerNorm32, Embed)):
            m.reset_parameters(generator)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding [N] → [N, dim], cos first, fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Dense(nn.Module):
    """Linear layer; ``zero_init`` for the reference's zero_module()."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, zero_init: bool = False, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.weight.jax_layout = (1, 0)  # JAX's kernel is (in, out): the axes that give it (AdamW8bit's blocks)
        self.bias = nn.Parameter(torch.empty(out_features, device=device)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                _lecun_normal_(self.weight, self.weight.shape[1], generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Module):
    """Embedding table (flax nn.Embed default init)."""

    def __init__(self, num: int, features: int, device: DeviceLike = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features, device=resolve_device(device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _lecun_normal_(self.weight, self.weight.shape[1], generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def gn_custom_vjp_enabled() -> bool:
    """``NEUROSIS_GN_VJP=1`` routes GroupNorm32 through the memory-saving
    ``ops.groupnorm.group_norm`` (the JAX package's gate, off by default)."""
    return os.environ.get("NEUROSIS_GN_VJP", "0").lower() in ("1", "true")


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 − p (a draw
    from ``generator``) and scale it by 1/(1 − p). No generator means
    deterministic, as JAX's ``deterministic=True``: x itself."""
    if p <= 0.0 or generator is None:
        return x
    keep = rows.draw(torch.rand, x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class GroupNorm32(nn.Module):
    """GroupNorm on NHWC x in fp32 with flax's statistics,
    var = max(0, E[x²] − E[x]²); returns x's dtype. ``fold=True`` returns
    the per-(batch, channel) affine (a, b) with gn(x) = x·a + b instead, for
    the fused GroupNorm+SiLU→conv kernel. Under ``NEUROSIS_GN_VJP=1`` a 4-D
    x goes through ``ops.groupnorm.group_norm``, which saves x and the
    per-(batch, group) statistics for the backward instead of an fp32 copy."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_channels, device=device))
        self.bias = nn.Parameter(torch.empty(num_channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, fold: bool = False):
        if not fold and x.ndim == 4 and gn_custom_vjp_enabled():
            return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)
        bsz, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xg = x.float().reshape(bsz, -1, g, c // g)
        mean = xg.mean(dim=(1, 3))
        var = (xg.square().mean(dim=(1, 3)) - mean.square()).clamp_min(0.0)
        rstd = torch.rsqrt(var + self.eps)
        if fold:
            a = self.weight[None, :] * rstd.repeat_interleave(c // g, dim=1)
            b = self.bias[None, :] - mean.repeat_interleave(c // g, dim=1) * a
            return a, b
        mul = rstd[:, None, :, None] * self.weight.reshape(g, c // g)
        y = (xg - mean[:, None, :, None]) * mul + self.bias.reshape(g, c // g)
        return y.reshape(x.shape).to(x.dtype)


class LayerNorm32(nn.Module):
    """LayerNorm over the last dim in fp32, returning the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Conv2d(nn.Module):
    """k×k NHWC conv with torch-style explicit padding.

    3×3 stride-1 SAME bf16 convs that pass ``conv3x3_supported`` go to the
    conv3x3 kernel; the rest go to ``F.conv2d``. With ``gn_affine=(a, b)``
    the folded GroupNorm + SiLU is fused into the conv kernel's tile loads
    (the caller checks ``gn_silu_conv3x3_supported`` first)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True, dtype: Optional[torch.dtype] = None,
                 zero_init: bool = False, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding
        self.dtype = dtype
        self.zero_init = zero_init
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, device=device))
        self.weight.jax_layout = (2, 3, 1, 0)  # OIHW → JAX's HWIO
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                _lecun_normal_(self.weight, self.weight[0].numel(), generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor, gn_affine=None) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x.dtype)
        w = self.weight.to(dt)
        x = x.to(dt)
        if gn_affine is not None:
            y = gn_silu_conv3x3(x, gn_affine[0], gn_affine[1], w)
        elif conv3x3_supported(x.shape, (*w.shape[2:], w.shape[1], w.shape[0]),
                               self.stride, self.padding, dt):
            y = conv3x3(x, w)
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride, padding=self.padding)
            y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2×2 average pool, stride 2 (flax ``avg_pool``: an odd edge is dropped)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4


class Upsample(nn.Module):
    """Nearest 2× upsample, then a 3×3 conv with ``use_conv`` (openaimodel.py:96-143)."""

    def __init__(self, channels: int, use_conv: bool = True, out_channels: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        super().__init__()
        self.conv = Conv2d(channels, out_channels or channels, 3, dtype=dtype, device=device) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nearest_upsample_2x(x)
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """Stride-2 3×3 conv, or with ``use_conv=False`` a 2×2 average pool
    (openaimodel.py:146-199)."""

    def __init__(self, channels: int, use_conv: bool = True, out_channels: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        super().__init__()
        if not use_conv and (out_channels or channels) != channels:
            raise ValueError("an average-pool Downsample keeps its channels")
        self.op = Conv2d(channels, out_channels or channels, 3, stride=2, padding=1, dtype=dtype,
                         device=device) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_2x(x) if self.op is None else self.op(x)
