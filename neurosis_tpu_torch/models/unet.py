"""SD-layout UNet, NHWC (port of neurosis_tpu/models/unet.py).

Submodules carry the reference's torch dotted paths (``input_blocks.1.0``,
``in_layers.2``...), so a JAX parameter tree converted by
``checkpoint.convert.jax_params_to_state_dict`` loads with ``strict=True``.
The UNet computes in ``dtype`` (bf16 under ``precision: bf16-mixed``) with
fp32 parameters and fp32 norms. It takes the reference's whole config
surface that the JAX package honours: the label embeddings (None; a class
count, an ``nn.Embedding``; ``continuous``; ``timestep``; SDXL's
``sequential``, the ADM embedding of the pooled text embedding and the size
conditioning), dropout, scale-shift norm, ResBlock up/down sampling,
``conv_resample``, per-level attention-block counts, disabled
self-attention, the middle transformer's switches and the per-level remat
policy of the transformer blocks. Dropout draws from the ``generator``
passed to ``forward``; without one the network is deterministic.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.attention import CrossAttention, SpatialTransformer
from ..modules.layers import (
    Conv2d,
    Dense,
    Downsample,
    Embed,
    GroupNorm32,
    Upsample,
    avg_pool_2x,
    compute_dtype,
    dropout,
    init_parameters,
    nearest_upsample_2x,
    timestep_embedding,
)
from ..ops.conv3x3 import gn_silu_conv3x3_supported


class ResBlock(nn.Module):
    """GN→SiLU→[up/down]→conv, +t-emb (or scale-shift of the second norm),
    GN→SiLU→dropout→zero-conv, +skip (openaimodel.py:200-342).

    Where the fused kernel takes the shape, each GN→SiLU→conv pair runs as
    one gn_silu_conv3x3 on the folded GroupNorm affine (scale-shift folded
    into it); not with up/down, nor the second pair while dropout draws."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None, dropout: float = 0.0,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.out_channels = out_ch
        self.dtype = dtype
        self.dropout = dropout
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, 32, device=device),
            nn.SiLU(),
            Conv2d(channels, out_ch, 3, dtype=dtype, device=device),
        )
        emb_out = 2 * out_ch if use_scale_shift_norm else out_ch
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_channels, emb_out, dtype=dtype, device=device))
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

    def forward(self, x: torch.Tensor, emb: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gn_in, conv_in = self.in_layers[0], self.in_layers[2]
        if not (self.up or self.down) and self._fuse_ok(x):
            h = conv_in(x, gn_affine=gn_in(x, fold=True))
        else:
            h = F.silu(gn_in(x))
            if self.up:
                h, x = nearest_upsample_2x(h), nearest_upsample_2x(x)
            elif self.down:
                h, x = avg_pool_2x(h), avg_pool_2x(x)
            h = conv_in(h)
        emb_out = self.emb_layers(emb)[:, None, None, :].to(h.dtype)
        gn_out, conv_out = self.out_layers[0], self.out_layers[3]
        fuse_out = (self.dropout == 0.0 or generator is None) and self._fuse_ok(h)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            if fuse_out:  # gn(h)·(1+scale)+shift folds into the affine, per (batch, channel)
                a, b = gn_out(h, fold=True)
                s = 1.0 + scale[:, 0, 0, :].float()
                h = conv_out(h, gn_affine=(a * s, b * s + shift[:, 0, 0, :].float()))
            else:
                h = F.silu(gn_out(h) * (1 + scale) + shift)
                h = conv_out(dropout(h, self.dropout, generator))
        else:
            h = h + emb_out
            if fuse_out:
                h = conv_out(h, gn_affine=gn_out(h, fold=True))
            else:
                h = conv_out(dropout(F.silu(gn_out(h)), self.dropout, generator))
        return self.skip_connection(x) + h


def _build_layout(model_channels, channel_mult, num_res_blocks, attention_resolutions,
                  num_heads, num_head_channels, transformer_depth, num_attention_blocks=None):
    """Static per-block layout (openaimodel.py:622-801 loops), as in JAX; an
    attention spec ends with its level."""
    input_blocks = [[("conv_in", model_channels)]]
    input_chans = [model_channels]
    ch = model_channels
    ds = 1
    for level, mult in enumerate(channel_mult):
        for nr in range(num_res_blocks[level]):
            layers = [("res", ch, mult * model_channels)]
            ch = mult * model_channels
            if ds in attention_resolutions and (num_attention_blocks is None or nr < num_attention_blocks[level]):
                layers.append(("attn", ch, *_heads(ch, num_heads, num_head_channels), transformer_depth[level],
                               level))
            input_blocks.append(layers)
            input_chans.append(ch)
        if level != len(channel_mult) - 1:
            input_blocks.append([("down", ch)])
            input_chans.append(ch)
            ds *= 2

    middle = [("res", ch, ch), ("attn", ch, *_heads(ch, num_heads, num_head_channels), transformer_depth[-1],
                                len(channel_mult) - 1), ("res", ch, ch)]

    output_blocks = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks[level] + 1):
            ich = input_chans.pop()
            layers = [("res", ch + ich, model_channels * mult)]
            ch = model_channels * mult
            if ds in attention_resolutions and (num_attention_blocks is None or i < num_attention_blocks[level]):
                layers.append(("attn", ch, *_heads(ch, num_heads, num_head_channels), transformer_depth[level],
                               level))
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

    ``forward(x, timesteps, context, y, generator)`` takes NHWC latents, [B]
    timesteps, [B, T, context_dim] cross-attention context and, iff
    ``num_classes`` is set, the label ``y`` ([B] class ids for a class count,
    [B] values for ``continuous`` and ``timestep``, [B, adm_in_channels] for
    ``sequential``); dropout draws from ``generator``. Builds on ``device``
    (CUDA unless told otherwise) and draws its initial weights from
    ``generator``. ``remat_policy`` is one policy or one per level
    (``modules.attention.REMAT_POLICIES``), read when ``use_checkpoint``.
    ``context_axis`` names the mesh axis whose ring every transformer's
    self-attention rides (sequence parallelism; the trainer sets it for
    ``context_parallel`` > 1, as JAX's loop clones the module with it).
    """

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: Union[int, Sequence[int]], attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_classes: Optional[Union[int, str]] = None,
                 use_checkpoint: bool = False, num_heads: int = -1, num_head_channels: int = -1,
                 transformer_depth: Union[int, Sequence[int]] = 1, context_dim: Optional[int] = None,
                 use_linear_in_transformer: bool = False, adm_in_channels: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, conv_resample: bool = True, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, disable_self_attentions: Optional[Sequence[bool]] = None,
                 num_attention_blocks: Optional[Sequence[int]] = None, disable_middle_self_attn: bool = False,
                 disable_middle_transformer: bool = False, remat_policy: Union[str, Sequence[str]] = "full",
                 context_axis: Optional[str] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        n_levels = len(channel_mult)
        res_blocks = [num_res_blocks] * n_levels if isinstance(num_res_blocks, int) else list(num_res_blocks)
        depth = [transformer_depth] * n_levels if isinstance(transformer_depth, int) else list(transformer_depth)
        self.in_channels = in_channels  # the latent channels a sampler draws noise for
        self.model_channels = model_channels
        emb_dim = model_channels * 4
        layout_in, layout_mid, layout_out = _build_layout(
            model_channels, channel_mult, res_blocks, attention_resolutions, num_heads, num_head_channels, depth,
            num_attention_blocks,
        )
        res = dict(dropout=dropout, use_scale_shift_norm=use_scale_shift_norm, dtype=dtype, device=device)

        def make(spec, middle=False):
            kind = spec[0]
            if kind == "conv_in":
                return Conv2d(in_channels, spec[1], 3, dtype=dtype, device=device)
            if kind == "res":
                return ResBlock(spec[1], emb_dim, spec[2], **res)
            if kind == "attn":
                _, ch, nh, dh, d, level = spec
                if middle:
                    if disable_middle_transformer:
                        return nn.Identity()
                    disable_sa = disable_middle_self_attn
                else:
                    disable_sa = bool(context_dim is not None and disable_self_attentions is not None
                                      and disable_self_attentions[level])
                policy = remat_policy if isinstance(remat_policy, str) else remat_policy[level]
                return SpatialTransformer(ch, nh, dh, d, context_dim, disable_self_attn=disable_sa,
                                          use_linear=use_linear_in_transformer, use_checkpoint=use_checkpoint,
                                          dtype=dtype, device=device, dropout=dropout, remat_policy=policy,
                                          context_axis=context_axis)
            if kind == "down":
                if resblock_updown:
                    return ResBlock(spec[1], emb_dim, spec[1], down=True, **res)
                return Downsample(spec[1], conv_resample, dtype=dtype, device=device)
            if kind == "up":
                if resblock_updown:
                    return ResBlock(spec[1], emb_dim, spec[1], up=True, **res)
                return Upsample(spec[1], conv_resample, dtype=dtype, device=device)
            raise ValueError(f"unknown layer kind {kind}")

        self.time_embed = nn.Sequential(
            Dense(model_channels, emb_dim, dtype=dtype, device=device),
            nn.SiLU(),
            Dense(emb_dim, emb_dim, dtype=dtype, device=device),
        )
        self.num_classes = num_classes
        if isinstance(num_classes, int) and not isinstance(num_classes, bool):
            self.label_emb = Embed(num_classes, emb_dim, device=device)
        elif num_classes == "continuous":
            self.label_emb = Dense(1, emb_dim, dtype=dtype, device=device)
        elif num_classes in ("timestep", "sequential"):
            if num_classes == "sequential" and adm_in_channels is None:
                raise ValueError("num_classes='sequential' needs adm_in_channels")
            # 'timestep': label_emb.0 is the reference's parameterless Timestep embedder
            first = nn.Identity() if num_classes == "timestep" else None
            in_ch = model_channels if num_classes == "timestep" else adm_in_channels
            mlp = nn.Sequential(
                Dense(in_ch, emb_dim, dtype=dtype, device=device),
                nn.SiLU(),
                Dense(emb_dim, emb_dim, dtype=dtype, device=device),
            )
            self.label_emb = nn.Sequential(first, mlp) if first is not None else nn.Sequential(mlp)
        elif num_classes is not None:
            raise ValueError(f"Unknown num_classes {num_classes}")
        self.input_blocks = nn.ModuleList(nn.ModuleList(make(s) for s in blk) for blk in layout_in)
        self.middle_block = nn.ModuleList(make(s, middle=True) for s in layout_mid)
        self.output_blocks = nn.ModuleList(nn.ModuleList(make(s) for s in blk) for blk in layout_out)
        self.out = nn.Sequential(
            GroupNorm32(model_channels, 32, device=device),
            nn.SiLU(),
            Conv2d(model_channels, out_channels, 3, zero_init=True, device=device),
        )
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    @property
    def context_axis(self) -> Optional[str]:
        return next((m.context_axis for m in self.modules() if isinstance(m, CrossAttention)), None)

    @context_axis.setter
    def context_axis(self, axis: Optional[str]) -> None:
        for m in self.modules():
            if isinstance(m, CrossAttention):
                m.context_axis = axis

    @staticmethod
    def _run_layer(layer: nn.Module, h, emb, context, generator):
        if isinstance(layer, ResBlock):
            return layer(h, emb, generator)
        if isinstance(layer, SpatialTransformer):
            return layer(h, context, generator)
        return layer(h)

    def _label_emb(self, y: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        if self.num_classes == "continuous":
            return self.label_emb(y[:, None].to(dt))
        if self.num_classes == "timestep":
            return self.label_emb[1](timestep_embedding(y, self.model_channels).to(dt))
        if self.num_classes == "sequential":
            return self.label_emb(y.to(dt))
        return self.label_emb(y)  # a class count: the fp32 table, as flax's Embed

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("y must be provided iff num_classes is set")
        t_emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed(t_emb.to(self.dtype or torch.float32))
        if y is not None:
            emb = emb + self._label_emb(y)

        hs = []
        h = x.to(self.dtype or x.dtype)
        for block in self.input_blocks:
            for layer in block:
                h = self._run_layer(layer, h, emb, context, generator)
            hs.append(h)
        for layer in self.middle_block:
            h = self._run_layer(layer, h, emb, context, generator)
        for block in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            for layer in block:
                h = self._run_layer(layer, h, emb, context, generator)
        return self.out(h.to(x.dtype))
