"""ldm-style convolutional VAE Encoder and Decoder, NHWC (port of
neurosis_tpu/models/vae.py).

Submodules carry the reference's torch dotted paths (``down.0.block.1``,
``mid.attn_1``, ``up.2.upsample``), so a JAX parameter tree converted by
``checkpoint.convert.jax_params_to_state_dict`` loads with ``strict=True``.
The mid-block attention is one single-head softmax attention over h·w
tokens through ``ops.attention.dot_product_attention`` (the flash kernel at
head dim 512 for the SD VAE). Stride-2 downsampling pads (0, 1) on each
spatial axis and convolves VALID, as the reference's ConstantPad2d.

Not ported yet: ``LinAttnBlock``, the pixel-space ``Model``, remat and the
Decoder's ``give_pre_end``/``tanh_out`` options.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.layers import Conv2d, GroupNorm32, Upsample, compute_dtype, init_parameters
from ..ops.attention import dot_product_attention
from ..ops.conv3x3 import gn_silu_conv3x3_supported


class ResnetBlock(nn.Module):
    """norm→silu→conv ×2 with a 1×1 (or 3×3) shortcut (model.py:85-141),
    GroupNorm eps 1e-6. Where the fused kernel takes the shape, each
    norm→silu→conv pair runs as one gn_silu_conv3x3 on the folded GroupNorm
    affine. Only ``temb_channels=0`` (the VAE's) is ported."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, conv_shortcut: bool = False,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        super().__init__()
        out_ch = out_channels or in_channels
        self.out_channels = out_ch
        self.dtype = dtype
        self.norm1 = GroupNorm32(in_channels, 32, eps=1e-6, device=device)
        self.conv1 = Conv2d(in_channels, out_ch, 3, dtype=dtype, device=device)
        self.norm2 = GroupNorm32(out_ch, 32, eps=1e-6, device=device)
        self.conv2 = Conv2d(out_ch, out_ch, 3, dtype=dtype, device=device)
        if in_channels != out_ch:
            if conv_shortcut:
                self.conv_shortcut = Conv2d(in_channels, out_ch, 3, dtype=dtype, device=device)
            else:
                self.nin_shortcut = Conv2d(in_channels, out_ch, 1, padding=0, dtype=dtype, device=device)

    def _fuse_ok(self, t: torch.Tensor) -> bool:
        return gn_silu_conv3x3_supported(
            t.shape, (3, 3, t.shape[-1], self.out_channels), 1, 1, compute_dtype(self.dtype, t.dtype)
        )

    def _gn_silu_conv(self, norm: GroupNorm32, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        if self._fuse_ok(x):
            return conv(x, gn_affine=norm(x, fold=True))
        return conv(F.silu(norm(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._gn_silu_conv(self.norm1, self.conv1, x)
        h = self._gn_silu_conv(self.norm2, self.conv2, h)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1×1 conv projections
    (model.py:144-253), tokens laid out "b h w c → b (h w) c"."""

    def __init__(self, in_channels: int, dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        super().__init__()
        c = in_channels
        self.norm = GroupNorm32(c, 32, eps=1e-6, device=device)
        self.q = Conv2d(c, c, 1, padding=0, dtype=dtype, device=device)
        self.k = Conv2d(c, c, 1, padding=0, dtype=dtype, device=device)
        self.v = Conv2d(c, c, 1, padding=0, dtype=dtype, device=device)
        self.proj_out = Conv2d(c, c, 1, padding=0, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(b, 1, hh * ww, c) for m in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v).reshape(b, hh, ww, c)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Pad (0, 1) on H and W, then a VALID stride-2 3×3 conv (model.py:65-82)."""

    def __init__(self, in_channels: int, dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, stride=2, padding=0, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Level(nn.Module):
    """One resolution level: ``block`` (and ``downsample``/``upsample``)."""

    def __init__(self, blocks: list):
        super().__init__()
        self.block = nn.ModuleList(blocks)


class _Mid(nn.Module):
    def __init__(self, ch: int, dtype, device):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch, dtype=dtype, device=device)
        self.attn_1 = VAEAttnBlock(ch, dtype=dtype, device=device)
        self.block_2 = ResnetBlock(ch, ch, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


def _check_attn(attn_resolutions, attn_type: str) -> None:
    if attn_type not in ("vanilla", "vanilla-xformers", "memory-efficient-cross-attn", "torch-sdp"):
        raise NotImplementedError(f"attn_type {attn_type!r} is not ported (only the vanilla softmax block)")
    if attn_resolutions:
        raise NotImplementedError("attention inside the resolution levels is not ported (attn_resolutions=[])")


class Encoder(nn.Module):
    """Image [B,H,W,in] → moments [B,h,w,2z] (model.py:456-607). Built on
    CUDA unless ``device`` says otherwise, with weights drawn from
    ``generator``."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int] = (), in_channels: int = 3, resolution: int = 256,
                 z_channels: int = 4, double_z: bool = True, dropout: float = 0.0,
                 attn_type: str = "vanilla", dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        _check_attn(attn_resolutions, attn_type)
        if dropout:
            raise NotImplementedError("dropout > 0 is not ported")
        self.dtype = dtype
        in_ch_mult = (1,) + tuple(ch_mult)
        self.conv_in = Conv2d(in_channels, ch, 3, dtype=dtype, device=device)
        self.down = nn.ModuleList()
        block_in = ch
        for i_level, mult in enumerate(ch_mult):
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * mult
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out, dtype=dtype, device=device))
                block_in = block_out
            level = _Level(blocks)
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in, dtype=dtype, device=device)
            self.down.append(level)
        self.mid = _Mid(block_in, dtype, device)
        self.norm_out = GroupNorm32(block_in, 32, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3, dtype=dtype, device=device)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """Latent [B,h,w,z] → image [B,H,W,out_ch] (model.py:609-766)."""

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256, z_channels: int = 4,
                 dropout: float = 0.0,
                 attn_type: str = "vanilla", dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        _check_attn(attn_resolutions, attn_type)
        if dropout:
            raise NotImplementedError("dropout > 0 is not ported")
        self.dtype = dtype
        num_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, dtype=dtype, device=device)
        self.mid = _Mid(block_in, dtype, device)
        levels = [None] * num_res
        for i_level in reversed(range(num_res)):
            block_out = ch * ch_mult[i_level]
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, dtype=dtype, device=device))
                block_in = block_out
            level = _Level(blocks)
            if i_level != 0:
                level.upsample = Upsample(block_in, dtype=dtype, device=device)
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in, 32, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, out_ch, 3, dtype=dtype, device=device)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))
