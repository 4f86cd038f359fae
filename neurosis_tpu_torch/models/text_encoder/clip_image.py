"""OpenCLIP vision tower and FrozenOpenCLIPImageEmbedder (port of
neurosis_tpu/models/text_encoder/clip_image.py; parity: clip.py:390-540).

A ViT image encoder in open_clip's key layout (``visual.conv1``,
``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.{i}``, ``ln_post``, ``proj``), NHWC. The embedder
resizes to 224 px with ATen's bicubic (``align_corners=True``, antialiased:
kornia's resize, as two matmuls in ``ops/resize.py``), maps [-1, 1] to
[0, 1], normalises with CLIP's mean and std, and runs the tower. Attention is
the plain matmul-softmax over 257 tokens, as JAX's einsum-softmax is (no
Pallas kernel reaches it).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ...modules.encoders.embedding import AbstractEmbModel
from ...modules.layers import Conv2d, Dense, LayerNorm32, init_parameters
from ...ops.attention import plain_attention
from ...ops.resize import bicubic_resize
from .clip import _OpenCLIPMLP

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class _BidirAttention(nn.Module):
    """Non-causal MHA, q/k/v split from open_clip's fused ``in_proj``."""

    def __init__(self, width: int, heads: int, dtype, device):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(width, width, dtype=dtype, device=device)
        self.k_proj = Dense(width, width, dtype=dtype, device=device)
        self.v_proj = Dense(width, width, dtype=dtype, device=device)
        self.out_proj = Dense(width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, width = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, width // self.heads).transpose(1, 2)

        out = plain_attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, s, width))


class _ViTBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device):
        super().__init__()
        self.ln_1 = LayerNorm32(width, device=device)
        self.attn = _BidirAttention(width, heads, dtype, device)
        self.ln_2 = LayerNorm32(width, device=device)
        self.mlp = _OpenCLIPMLP(width, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype, device):
        super().__init__()
        self.resblocks = nn.ModuleList(_ViTBlock(width, heads, dtype, device) for _ in range(layers))


class OpenCLIPVisionTower(nn.Module):
    """open_clip VisualTransformer on NHWC images; returns (pooled @ proj, tokens)."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1024, layers: int = 24,
                 heads: int = 16, output_dim: int = 768, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.width, self.dtype = width, dtype
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, padding=0, bias=False, dtype=dtype,
                            device=device)
        grid = image_size // patch_size
        self.class_embedding = nn.Parameter(torch.empty(width, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width, device=device))
        self.ln_pre = LayerNorm32(width, device=device)
        self.transformer = _Transformer(width, layers, heads, dtype, device)
        self.ln_post = LayerNorm32(width, device=device)
        self.proj = nn.Parameter(torch.empty(width, output_dim, device=device))  # x @ proj: [width, out]
        generator = generator if generator is not None else torch.Generator(device).manual_seed(0)
        init_parameters(self, generator)
        with torch.no_grad():
            for p in (self.class_embedding, self.positional_embedding, self.proj):
                p.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        x = self.conv1(x).reshape(b, -1, self.width)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        pooled = self.ln_post(x[:, 0])
        return pooled @ self.proj.to(pooled.dtype), x[:, 1:]


class FrozenOpenCLIPImageEmbedder(AbstractEmbModel):
    """Image → CLIP embedding (clip.py:390-540): resize and renormalise, then
    the pooled vector (``unsqueeze_dim``: [B, 1, D]), with the tokens when
    ``output_tokens``. ``arch`` is taken and unused: the widths say the
    architecture. The JAX registry resolves no path to it, nor does the
    port's."""

    def __init__(self, arch: str = "ViT-H-14", image_size: int = 224, patch_size: int = 14, width: int = 1280,
                 layers: int = 32, heads: int = 16, output_dim: int = 1024, antialias: bool = True,
                 unsqueeze_dim: bool = False, output_tokens: bool = False, input_key: str = "caption",
                 ucg_rate: float = 0.0, is_trainable: bool = False, base_lr: Optional[float] = None,
                 emb_name: Optional[str] = None, dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        device = resolve_device(device)
        self.image_size, self.antialias, self.dtype = image_size, antialias, dtype
        self.unsqueeze_dim, self.output_tokens = unsqueeze_dim, output_tokens
        self.model = nn.Module()
        self.model.visual = OpenCLIPVisionTower(image_size, patch_size, width, layers, heads, output_dim,
                                                dtype=dtype, device=device, generator=generator)
        self.register_buffer("mean", torch.from_numpy(CLIP_MEAN).to(device), persistent=False)
        self.register_buffer("std", torch.from_numpy(CLIP_STD).to(device), persistent=False)
        self.requires_grad_(is_trainable)

    def forward(self, image: torch.Tensor) -> tuple:
        x = bicubic_resize(image, (self.image_size, self.image_size), align_corners=True,
                           antialias=self.antialias)
        x = ((x + 1.0) / 2.0 - self.mean) / self.std
        pooled, tokens = self.model.visual(x.to(self.dtype or x.dtype))
        if self.unsqueeze_dim:
            pooled = pooled[:, None, :]
        return (pooled, tokens) if self.output_tokens else (pooled,)
