"""SD-layout UNet, NHWC (port of neurosis_tpu/models/unet.py).

Submodules carry the reference's torch dotted paths (``input_blocks.1.0``,
``in_layers.2``...), so a JAX parameter tree converted by
``checkpoint.convert.jax_params_to_state_dict`` loads with ``strict=True``.
The UNet computes in ``dtype`` (bf16 under ``precision: bf16-mixed``) with
fp32 parameters and fp32 norms. It covers the SD1.5 layout
(``num_classes=None``) and SDXL's (``num_classes="sequential"``: the ADM
label embedding of the pooled text embedding and the size conditioning); the
other label embeddings (a class count, ``continuous``, ``timestep``) raise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.attention import SpatialTransformer
from ..modules.layers import (
    Conv2d,
    Dense,
    Downsample,
    GroupNorm32,
    Upsample,
    compute_dtype,
    init_parameters,
    timestep_embedding,
)
from ..ops.conv3x3 import gn_silu_conv3x3_supported


class ResBlock(nn.Module):
    """GN→SiLU→conv, +t-emb, GN→SiLU→zero-conv, +skip (openaimodel.py:200-342).

    Where the fused kernel takes the shape, each GN→SiLU→conv pair runs as
    one gn_silu_conv3x3 on the folded GroupNorm affine."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        super().__init__()
        out_ch = out_channels or channels
        self.out_channels = out_ch
        self.dtype = dtype
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, 32, device=device),
            nn.SiLU(),
            Conv2d(channels, out_ch, 3, dtype=dtype, device=device),
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_channels, out_ch, dtype=dtype, device=device))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch, 32, device=device),
            nn.SiLU(),
            nn.Identity(),  # the reference's dropout slot
            Conv2d(out_ch, out_ch, 3, dtype=dtype, zero_init=True, device=device),
        )
        if out_ch != channels:
            self.skip_connection = Conv2d(channels, out_ch, 1, padding=0, dtype=dtype, device=device)
        else:
            self.skip_connection = nn.Identity()

    def _fuse_ok(self, t: torch.Tensor) -> bool:
        return gn_silu_conv3x3_supported(
            t.shape, (3, 3, t.shape[-1], self.out_channels), 1, 1, compute_dtype(self.dtype, t.dtype)
        )

    def _gn_silu_conv(self, layers: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        norm, conv = layers[0], layers[-1]
        if self._fuse_ok(x):
            return conv(x, gn_affine=norm(x, fold=True))
        return conv(F.silu(norm(x)))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self._gn_silu_conv(self.in_layers, x)
        h = h + self.emb_layers(emb)[:, None, None, :].to(h.dtype)
        h = self._gn_silu_conv(self.out_layers, h)
        return self.skip_connection(x) + h


def _build_layout(model_channels, channel_mult, num_res_blocks, attention_resolutions,
                  num_heads, num_head_channels, transformer_depth):
    """Static per-block layout (openaimodel.py:622-801 loops), as in JAX."""
    input_blocks = [[("conv_in", model_channels)]]
    input_chans = [model_channels]
    ch = model_channels
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks[level]):
            layers = [("res", ch, mult * model_channels)]
            ch = mult * model_channels
            if ds in attention_resolutions:
                layers.append(("attn", ch, *_heads(ch, num_heads, num_head_channels), transformer_depth[level]))
            input_blocks.append(layers)
            input_chans.append(ch)
        if level != len(channel_mult) - 1:
            input_blocks.append([("down", ch)])
            input_chans.append(ch)
            ds *= 2

    middle = [("res", ch, ch), ("attn", ch, *_heads(ch, num_heads, num_head_channels), transformer_depth[-1]),
              ("res", ch, ch)]

    output_blocks = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks[level] + 1):
            ich = input_chans.pop()
            layers = [("res", ch + ich, model_channels * mult)]
            ch = model_channels * mult
            if ds in attention_resolutions:
                layers.append(("attn", ch, *_heads(ch, num_heads, num_head_channels), transformer_depth[level]))
            if level and i == num_res_blocks[level]:
                layers.append(("up", ch))
                ds //= 2
            output_blocks.append(layers)
    return input_blocks, middle, output_blocks


def _heads(ch: int, num_heads: int, num_head_channels: int):
    if num_head_channels == -1:
        return num_heads, ch // num_heads
    return ch // num_head_channels, num_head_channels


class UNetModel(nn.Module):
    """SD denoising UNet; config surface of the reference's UNetModel.

    ``forward(x, timesteps, context, y)`` takes NHWC latents, [B] timesteps,
    [B, T, context_dim] cross-attention context and, iff ``num_classes`` is
    set, the [B, adm_in_channels] vector conditioning. Builds on ``device``
    (CUDA unless told otherwise) and draws its initial weights from
    ``generator``.
    """

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: Union[int, Sequence[int]], attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_classes: Optional[Union[int, str]] = None,
                 use_checkpoint: bool = False, num_heads: int = -1, num_head_channels: int = -1,
                 transformer_depth: Union[int, Sequence[int]] = 1, context_dim: Optional[int] = None,
                 use_linear_in_transformer: bool = False, adm_in_channels: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        n_levels = len(channel_mult)
        res_blocks = [num_res_blocks] * n_levels if isinstance(num_res_blocks, int) else list(num_res_blocks)
        depth = [transformer_depth] * n_levels if isinstance(transformer_depth, int) else list(transformer_depth)
        self.model_channels = model_channels
        emb_dim = model_channels * 4
        layout_in, layout_mid, layout_out = _build_layout(
            model_channels, channel_mult, res_blocks, attention_resolutions, num_heads, num_head_channels, depth
        )

        def make(spec):
            kind = spec[0]
            if kind == "conv_in":
                return Conv2d(in_channels, spec[1], 3, dtype=dtype, device=device)
            if kind == "res":
                return ResBlock(spec[1], emb_dim, spec[2], dtype=dtype, device=device)
            if kind == "attn":
                _, ch, nh, dh, d = spec
                return SpatialTransformer(ch, nh, dh, d, context_dim, use_linear=use_linear_in_transformer,
                                          use_checkpoint=use_checkpoint, dtype=dtype, device=device)
            if kind == "down":
                return Downsample(spec[1], dtype=dtype, device=device)
            if kind == "up":
                return Upsample(spec[1], dtype=dtype, device=device)
            raise ValueError(f"unknown layer kind {kind}")

        self.time_embed = nn.Sequential(
            Dense(model_channels, emb_dim, dtype=dtype, device=device),
            nn.SiLU(),
            Dense(emb_dim, emb_dim, dtype=dtype, device=device),
        )
        self.num_classes = num_classes
        if num_classes == "sequential":
            # SDXL: y is the concat of the pooled text embedding and the size embeddings
            if adm_in_channels is None:
                raise ValueError("num_classes='sequential' needs adm_in_channels")
            self.label_emb = nn.Sequential(nn.Sequential(
                Dense(adm_in_channels, emb_dim, dtype=dtype, device=device),
                nn.SiLU(),
                Dense(emb_dim, emb_dim, dtype=dtype, device=device),
            ))
        elif num_classes is not None:
            raise NotImplementedError(f"num_classes={num_classes!r}: this port covers None and 'sequential'")
        self.input_blocks = nn.ModuleList(nn.ModuleList(make(s) for s in blk) for blk in layout_in)
        self.middle_block = nn.ModuleList(make(s) for s in layout_mid)
        self.output_blocks = nn.ModuleList(nn.ModuleList(make(s) for s in blk) for blk in layout_out)
        self.out = nn.Sequential(
            GroupNorm32(model_channels, 32, device=device),
            nn.SiLU(),
            Conv2d(model_channels, out_channels, 3, zero_init=True, device=device),
        )
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    @staticmethod
    def _apply(layer: nn.Module, h, emb, context):
        if isinstance(layer, ResBlock):
            return layer(h, emb)
        if isinstance(layer, SpatialTransformer):
            return layer(h, context)
        return layer(h)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None):
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("y must be provided iff num_classes is set")
        t_emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed(t_emb.to(self.dtype or torch.float32))
        if y is not None:
            emb = emb + self.label_emb(y.to(self.dtype or torch.float32))

        hs = []
        h = x.to(self.dtype or x.dtype)
        for block in self.input_blocks:
            for layer in block:
                h = self._apply(layer, h, emb, context)
            hs.append(h)
        for layer in self.middle_block:
            h = self._apply(layer, h, emb, context)
        for block in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            for layer in block:
                h = self._apply(layer, h, emb, context)
        return self.out(h.to(x.dtype))
