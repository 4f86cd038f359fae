"""ldm-style convolutional VAE Encoder and Decoder, and the pixel-space
DDPM ``Model``, NHWC (port of neurosis_tpu/models/vae.py).

Submodules carry the reference's torch dotted paths (``down.0.block.1``,
``down.3.attn.0``, ``mid.attn_1``, ``up.2.upsample``, ``temb.dense.0``), so a
JAX parameter tree converted by ``checkpoint.convert.jax_params_to_state_dict``
loads with ``strict=True``. The softmax attention blocks (the mid block's,
and those inside the levels listed in ``attn_resolutions``) are one
single-head attention over h·w tokens through
``ops.attention.dot_product_attention`` (the flash kernel at head dim 512 for
the SD VAE). ``attn_type: linear`` is ``LinAttnBlock``, whose einsums are
plain torch, as JAX's are jnp. Stride-2 downsampling pads (0, 1) on each
spatial axis and convolves VALID, as the reference's ConstantPad2d; without
``resamp_with_conv`` it average-pools, and upsampling is nearest alone.

Dropout draws from the ``generator`` a forward is given; without one it is
off (JAX's ``deterministic=True``). With ``remat`` each ResnetBlock runs
under ``torch.utils.checkpoint`` and its recompute draws the same masks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.attention import checkpointed
from ..modules.layers import Conv2d, Dense, GroupNorm32, Upsample, avg_pool_2x, compute_dtype, dropout, \
    init_parameters
from ..ops.attention import dot_product_attention
from ..ops.conv3x3 import gn_silu_conv3x3_supported

_SOFTMAX_ATTN = ("vanilla", "vanilla-xformers", "memory-efficient-cross-attn", "torch-sdp")


class ResnetBlock(nn.Module):
    """norm→silu→conv ×2 with a 1×1 (or 3×3) shortcut (model.py:85-141),
    GroupNorm eps 1e-6. Where the fused kernel takes the shape, each
    norm→silu→conv pair runs as one gn_silu_conv3x3 on the folded GroupNorm
    affine (the second only while dropout draws nothing). ``temb_channels >
    0`` adds ``temb_proj(silu(temb))`` after the first conv (the pixel-space
    ``Model``'s)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, conv_shortcut: bool = False,
                 dropout: float = 0.0, temb_channels: int = 0, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None):
        super().__init__()
        out_ch = out_channels or in_channels
        self.out_channels = out_ch
        self.dtype = dtype
        self.dropout = dropout
        self.norm1 = GroupNorm32(in_channels, 32, eps=1e-6, device=device)
        self.conv1 = Conv2d(in_channels, out_ch, 3, dtype=dtype, device=device)
        if temb_channels > 0:
            self.temb_proj = Dense(temb_channels, out_ch, dtype=dtype, device=device)
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

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self._fuse_ok(x):
            h = self.conv1(x, gn_affine=self.norm1(x, fold=True))
        else:
            h = self.conv1(F.silu(self.norm1(x)))
        if hasattr(self, "temb_proj"):
            h = h + self.temb_proj(F.silu(temb))[:, None, None, :].to(h.dtype)
        if (self.dropout == 0.0 or generator is None) and self._fuse_ok(h):
            h = self.conv2(h, gn_affine=self.norm2(h, fold=True))
        else:
            h = self.conv2(dropout(F.silu(self.norm2(h)), self.dropout, generator))
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


class LinAttnBlock(nn.Module):
    """Linear attention (attention.py:77-94 LinearAttention; model.py:137-141
    pins one head of ``dim_head = in_channels`` and adds no residual): the
    keys softmaxed over tokens in fp32, then the context kᵀv applied to q."""

    def __init__(self, in_channels: int, dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        super().__init__()
        self.to_qkv = Conv2d(in_channels, 3 * in_channels, 1, padding=0, bias=False, dtype=dtype, device=device)
        self.to_out = Conv2d(in_channels, in_channels, 1, padding=0, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        qkv = self.to_qkv(x).reshape(b, hh * ww, 3, 1, c)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, S, heads, D]
        k = torch.softmax(k.float(), dim=1).to(q.dtype)
        context = torch.einsum("bshd,bshe->bhde", k, v)
        out = torch.einsum("bhde,bshd->bshe", context, q)
        return self.to_out(out.reshape(b, hh, ww, c))


def make_attn(in_channels: int, attn_type: str = "vanilla", dtype=None, device: DeviceLike = None) -> nn.Module:
    """model.py:255-284: the softmax block for every CUDA backend spelling,
    ``linear`` and ``none`` as they say."""
    if attn_type in _SOFTMAX_ATTN:
        return VAEAttnBlock(in_channels, dtype=dtype, device=device)
    if attn_type == "linear":
        return LinAttnBlock(in_channels, dtype=dtype, device=device)
    if attn_type == "none":
        return nn.Identity()
    raise ValueError(f"attn_type {attn_type} unknown")


class Downsample(nn.Module):
    """Pad (0, 1) on H and W, then a VALID stride-2 3×3 conv, or a 2×2
    average pool without ``with_conv`` (model.py:65-82)."""

    def __init__(self, in_channels: int, with_conv: bool = True, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None):
        super().__init__()
        if with_conv:
            self.conv = Conv2d(in_channels, in_channels, 3, stride=2, padding=0, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "conv"):
            return avg_pool_2x(x)
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Level(nn.Module):
    """One resolution level: ``block``, ``attn`` where the level attends,
    and ``downsample``/``upsample``."""

    def __init__(self, blocks: list, attns: list):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if attns:
            self.attn = nn.ModuleList(attns)


class _Mid(nn.Module):
    def __init__(self, ch: int, attn_type: str, dropout: float, temb_channels: int, dtype, device):
        super().__init__()
        res = dict(dropout=dropout, temb_channels=temb_channels, dtype=dtype, device=device)
        self.block_1 = ResnetBlock(ch, ch, **res)
        self.attn_1 = make_attn(ch, attn_type, dtype=dtype, device=device)
        self.block_2 = ResnetBlock(ch, ch, **res)


class _Net(nn.Module):
    """What the three networks share: ResnetBlocks, under remat when asked,
    and a level's blocks each followed by its attention."""

    remat = False

    def _block(self, block: ResnetBlock, h: torch.Tensor, temb=None, generator=None) -> torch.Tensor:
        if self.remat:
            return checkpointed(block, "full", h, temb, generator)
        return block(h, temb, generator)

    def _mid(self, h: torch.Tensor, temb=None, generator=None) -> torch.Tensor:
        h = self._block(self.mid.block_1, h, temb, generator)
        return self._block(self.mid.block_2, self.mid.attn_1(h), temb, generator)


def _levels(ch: int, ch_mult: Sequence[int], blocks_per_level: int, attn_resolutions, resolution: int,
            attn_type: str, down: bool, res: dict, dtype, device, with_conv: bool, skip: bool = False) -> list:
    """The levels of the Encoder (``down``) or Decoder, the pixel-space Model's
    with ``skip`` (an up block takes the concatenated skip's channels too)."""
    n = len(ch_mult)
    in_ch_mult = (1,) + tuple(ch_mult)
    levels = [None] * n
    block_in = ch * ch_mult[-1]
    curr_res = resolution if down else resolution // 2 ** (n - 1)
    for i_level in (range(n) if down else reversed(range(n))):
        block_out = ch * ch_mult[i_level]
        if down:
            block_in = ch * in_ch_mult[i_level]
        blocks, attns = [], []
        for i_block in range(blocks_per_level):
            skip_in = 0
            if skip:
                skip_in = ch * (in_ch_mult[i_level] if i_block == blocks_per_level - 1 else ch_mult[i_level])
            blocks.append(ResnetBlock(block_in + skip_in, block_out, **res))
            block_in = block_out
            if curr_res in attn_resolutions:
                attns.append(make_attn(block_in, attn_type, dtype=dtype, device=device))
        level = _Level(blocks, attns)
        if down and i_level != n - 1:
            level.downsample = Downsample(block_in, with_conv, dtype=dtype, device=device)
            curr_res //= 2
        if not down and i_level != 0:
            level.upsample = Upsample(block_in, use_conv=with_conv, dtype=dtype, device=device)
            curr_res *= 2
        levels[i_level] = level
    return levels


class Encoder(_Net):
    """Image [B,H,W,in] → moments [B,h,w,2z] (model.py:456-607). Built on
    CUDA unless ``device`` says otherwise, with weights drawn from
    ``generator``."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int] = (), in_channels: int = 3, resolution: int = 256,
                 z_channels: int = 4, double_z: bool = True, dropout: float = 0.0, resamp_with_conv: bool = True,
                 attn_type: str = "vanilla", dtype: Optional[torch.dtype] = None, remat: bool = False,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.remat = dtype, remat
        res = dict(dropout=dropout, dtype=dtype, device=device)
        self.conv_in = Conv2d(in_channels, ch, 3, dtype=dtype, device=device)
        self.down = nn.ModuleList(_levels(ch, ch_mult, num_res_blocks, attn_resolutions, resolution, attn_type,
                                          True, res, dtype, device, resamp_with_conv))
        block_in = ch * ch_mult[-1]
        self.mid = _Mid(block_in, attn_type, dropout, 0, dtype, device)
        self.norm_out = GroupNorm32(block_in, 32, eps=1e-6, device=device)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3, dtype=dtype, device=device)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for i, block in enumerate(level.block):
                h = self._block(block, h, None, generator)
                if hasattr(level, "attn"):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self._mid(h, None, generator)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(_Net):
    """Latent [B,h,w,z] → image [B,H,W,out_ch] (model.py:609-766); with
    ``give_pre_end`` the features before ``norm_out`` (which, with
    ``conv_out``, it then does not have), with ``tanh_out`` tanh of the image."""

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256, z_channels: int = 4,
                 give_pre_end: bool = False, tanh_out: bool = False, dropout: float = 0.0,
                 resamp_with_conv: bool = True, attn_type: str = "vanilla", dtype: Optional[torch.dtype] = None,
                 remat: bool = False, device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.remat = dtype, remat
        self.give_pre_end, self.tanh_out = give_pre_end, tanh_out
        res = dict(dropout=dropout, dtype=dtype, device=device)
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, dtype=dtype, device=device)
        self.mid = _Mid(block_in, attn_type, dropout, 0, dtype, device)
        self.up = nn.ModuleList(_levels(ch, ch_mult, num_res_blocks + 1, attn_resolutions, resolution, attn_type,
                                        False, res, dtype, device, resamp_with_conv))
        if not give_pre_end:
            self.norm_out = GroupNorm32(ch * ch_mult[0], 32, eps=1e-6, device=device)
            self.conv_out = Conv2d(ch * ch_mult[0], out_ch, 3, dtype=dtype, device=device)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self._mid(self.conv_in(z), None, generator)
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = self._block(block, h, None, generator)
                if hasattr(level, "attn"):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        if self.give_pre_end:
            return h
        h = self.conv_out(F.silu(self.norm_out(h)))
        return torch.tanh(h) if self.tanh_out else h


def ddpm_timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """The pixel-space Model's sinusoid (model.py:30-52): frequencies
    exp(−log(1e4)·i/(half − 1)), sin first, zero-padded when ``dim`` is odd."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      * -(math.log(10000) / (half - 1)))
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class _TimestepEmbed(nn.Module):
    def __init__(self, ch: int, temb_ch: int, dtype, device):
        super().__init__()
        self.dense = nn.ModuleList([Dense(ch, temb_ch, dtype=dtype, device=device),
                                    Dense(temb_ch, temb_ch, dtype=dtype, device=device)])


class Model(_Net):
    """Pixel-space DDPM UNet (model.py:286-452): the Encoder/Decoder topology
    with skip connections and, with ``use_timestep``, the timestep embedding
    added in every ResnetBlock. ``context`` is concatenated to x on the
    channels, so ``in_channels`` counts the context's channels, as the
    reference's conv_in does."""

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int] = (), in_channels: int = 3, resolution: int = 256,
                 use_timestep: bool = True, dropout: float = 0.0, resamp_with_conv: bool = True,
                 attn_type: str = "vanilla", dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.ch, self.dtype, self.use_timestep = ch, dtype, use_timestep
        temb_ch = ch * 4 if use_timestep else 0
        if use_timestep:
            self.temb = _TimestepEmbed(ch, temb_ch, dtype, device)
        res = dict(dropout=dropout, temb_channels=temb_ch, dtype=dtype, device=device)
        self.conv_in = Conv2d(in_channels, ch, 3, dtype=dtype, device=device)
        self.down = nn.ModuleList(_levels(ch, ch_mult, num_res_blocks, attn_resolutions, resolution, attn_type,
                                          True, res, dtype, device, resamp_with_conv))
        block_in = ch * ch_mult[-1]
        self.mid = _Mid(block_in, attn_type, dropout, temb_ch, dtype, device)
        self.up = nn.ModuleList(_levels(ch, ch_mult, num_res_blocks + 1, attn_resolutions, resolution, attn_type,
                                        False, res, dtype, device, resamp_with_conv, skip=True))
        self.norm_out = GroupNorm32(ch * ch_mult[0], 32, eps=1e-6, device=device)
        self.conv_out = Conv2d(ch * ch_mult[0], out_ch, 3, dtype=dtype, device=device)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None, context: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if context is not None:
            x = torch.cat([x, context], dim=-1)
        temb = None
        if self.use_timestep:
            if t is None:
                raise ValueError("Model(use_timestep=True) needs t")
            d0, d1 = self.temb.dense
            temb = d1(F.silu(d0(ddpm_timestep_embedding(t, self.ch))))
        hs = [self.conv_in(x)]
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(hs[-1], temb, generator)
                if hasattr(level, "attn"):
                    h = level.attn[i](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))
        h = self._mid(hs[-1], temb, generator)
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=-1), temb, generator)
                if hasattr(level, "attn"):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))
