"""The DreamSim perceptual metric and VAE loss (port of
neurosis_tpu/losses/dreamsim.py; parity: modules/losses/dreamsim/{vit,model}.py).

ViT-B/16 feature extractors in timm's key layout (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1, attn.{q,k,v,proj}, norm2,
mlp.fc1, mlp.fc2}``, ``norm``, ``head``), NHWC, the fused ``attn.qkv`` split
by ``split_vit_qkv``; ``DreamsimModel`` (one tower) and ``DreamsimEnsemble``
(dino, clip1 with quick_gelu, clip2 with gelu): unit-normalised features less
their mean, then 1 - cosine similarity. The pairs are resized to 224 px with
``jax.image.resize``'s bicubic (Keys' a = -0.5, ``ops/resize.py``'s
``jax_image_resize``), as JAX's loss resizes them. Attention is the plain
matmul-softmax over 197 tokens (no Pallas kernel reaches it in JAX).

``AutoencoderDreamsim`` is the VAE trainer's loss: recon (L1 or L2) plus the
distance. Its towers are frozen (no parameter requires grad, so no optimizer
or EMA holds them) and start from the module's seeded init, as JAX's do; the
decoder's gradient flows through them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.layers import Conv2d, Dense, LayerNorm32, init_parameters
from ..ops.attention import plain_attention
from ..ops.resize import bicubic_resize, jax_image_resize

DINO_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
DINO_STD = np.array([0.229, 0.224, 0.225], np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _ViTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype, device):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, dtype=dtype, device=device)
        self.k = Dense(dim, dim, dtype=dtype, device=device)
        self.v = Dense(dim, dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape

        def split(t):
            return t.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

        out = plain_attention(split(self.q(x)), split(self.k(x)), split(self.v(x)))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, act, dtype, device):
        super().__init__()
        self.act = act
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden: int, act, eps: float, dtype, device):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=eps, device=device)
        self.attn = _ViTAttention(dim, num_heads, dtype, device)
        self.norm2 = LayerNorm32(dim, eps=eps, device=device)
        self.mlp = _Mlp(dim, hidden, act, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformerB16(nn.Module):
    """DreamSim ViT-B/16 (vit.py:202-357) on NHWC images; returns the CLS
    feature, through ``head`` (a Linear with bias) when ``num_classes`` > 0.
    ``final_norm`` says whether the tower ends in ``norm`` (JAX's call-time
    ``norm``: the dino towers are called without it, so they have none).
    ``pos_embed`` is sized for ``image_size`` and interpolated to another
    input's grid."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, num_classes: int = 0, pre_norm: bool = False,
                 act_layer: str = "gelu", layer_norm_eps: float = 1e-6, final_norm: bool = True,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.patch_size, self.embed_dim = patch_size, embed_dim
        self.patch_embed = nn.Module()
        # the CLIP towers' patch projection has no bias
        self.patch_embed.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size, padding=0, bias=not pre_norm,
                                       dtype=dtype, device=device)
        n_native = (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, n_native + 1, embed_dim, device=device))
        self.norm_pre = LayerNorm32(embed_dim, eps=layer_norm_eps, device=device) if pre_norm else None
        act = _quick_gelu if act_layer == "quick_gelu" else F.gelu
        hidden = int(embed_dim * mlp_ratio)
        self.blocks = nn.ModuleList(_Block(embed_dim, num_heads, hidden, act, layer_norm_eps, dtype, device)
                                    for _ in range(depth))
        self.norm = LayerNorm32(embed_dim, eps=layer_norm_eps, device=device) if final_norm else None
        self.head = Dense(embed_dim, num_classes, dtype=dtype, device=device) if num_classes > 0 else None
        generator = generator if generator is not None else torch.Generator(device).manual_seed(0)
        init_parameters(self, generator)
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, in_h, in_w = x.shape[:3]
        x = self.patch_embed.proj(x).reshape(b, -1, self.embed_dim)
        pos = interpolate_pos_encoding(self.pos_embed, x.shape[1], in_w // self.patch_size,
                                       in_h // self.patch_size)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim), x], dim=1) + pos.to(x.dtype)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        for block in self.blocks:
            x = block(x)
        if self.norm is not None:
            x = self.norm(x)
        feat = x[:, 0]
        return self.head(feat) if self.head is not None else feat


def interpolate_pos_encoding(pos: torch.Tensor, npatch: int, w0_patches: int, h0_patches: int) -> torch.Tensor:
    """vit.py:278-302: keep the CLS slot, resample the native patch grid to
    the input's with ATen's bicubic at the scale factor (h0 + 0.1)/√N (the
    reference's +0.1 against rounding; ATen maps coordinates by its inverse).
    Raises where the grid does not come out."""
    n = pos.shape[1] - 1
    if npatch == n and w0_patches == h0_patches:
        return pos
    dim = pos.shape[-1]
    gs = int(math.sqrt(n))
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:].reshape(1, gs, gs, dim)
    h0, w0 = h0_patches + 0.1, w0_patches + 0.1
    out = bicubic_resize(patch_pos, (h0_patches, w0_patches), align_corners=False, antialias=False,
                         scales=(gs / h0, gs / w0))
    if out.shape[1] != h0_patches or out.shape[2] != w0_patches:
        raise ValueError("Error in positional encoding interpolation.")
    return torch.cat([cls_pos, out.reshape(1, -1, dim)], dim=1)


def _unit_center(z: torch.Tensor) -> torch.Tensor:
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    return z - z.mean(dim=1, keepdim=True)


def _distance(z: torch.Tensor, pairs: int) -> torch.Tensor:
    """1 - cos of the two halves of the centred features [2·B, D] → [B]."""
    z = _unit_center(z).reshape(2, pairs, -1)
    cos = (z[0] * z[1]).sum(dim=1) / (torch.linalg.vector_norm(z[0], dim=1)
                                      * torch.linalg.vector_norm(z[1], dim=1) + 1e-8)
    return 1.0 - cos


def _flat_pair(x: torch.Tensor, do_resize: bool) -> torch.Tensor:
    """[2, B, H, W, 3] → [2·B, H', W', 3], resized to 224 as JAX's resize does."""
    pair = x.reshape((-1,) + tuple(x.shape[2:]))
    return jax_image_resize(pair, (224, 224), antialias=True) if do_resize else pair


class _Normalise(nn.Module):
    def __init__(self, mean: np.ndarray, std: np.ndarray, device):
        super().__init__()
        self.register_buffer("mean", torch.from_numpy(mean).to(device), persistent=False)
        self.register_buffer("std", torch.from_numpy(std).to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std  # a bf16 pair meets fp32 constants: fp32, as in JAX


class DreamsimModel(nn.Module):
    """One tower (model.py:34-90): x [2, B, H, W, 3] in [0, 1] → distance [B]."""

    def __init__(self, pre_norm: bool = False, act_layer: str = "gelu", layer_norm_eps: float = 1e-6,
                 do_resize: bool = False, dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.do_resize = do_resize
        self.normalise = _Normalise(DINO_MEAN, DINO_STD, device)
        self.extractor = VisionTransformerB16(num_classes=512 if pre_norm else 0, pre_norm=pre_norm,
                                              act_layer=act_layer, layer_norm_eps=layer_norm_eps,
                                              final_norm=pre_norm, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _distance(self.extractor(self.normalise(_flat_pair(x, self.do_resize))), x.shape[1])


class DreamsimEnsemble(nn.Module):
    """dino + clip1 (quick_gelu) + clip2 (gelu) (model.py:92-173): x [2, B,
    H, W, 3] in [0, 1] → distance [B] over the concatenated features."""

    def __init__(self, layer_norm_eps: Sequence[float] = (1e-6, 1e-5, 1e-5),
                 num_classes: Sequence[int] = (0, 512, 512), do_resize: bool = False,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.do_resize = do_resize
        self.dino_normalise = _Normalise(DINO_MEAN, DINO_STD, device)
        self.clip_normalise = _Normalise(CLIP_MEAN, CLIP_STD, device)
        common = dict(dtype=dtype, device=device, generator=generator)
        self.dino = VisionTransformerB16(num_classes=num_classes[0], pre_norm=False, act_layer="gelu",
                                         layer_norm_eps=layer_norm_eps[0], final_norm=False, **common)
        self.clip1 = VisionTransformerB16(num_classes=num_classes[1], pre_norm=True, act_layer="quick_gelu",
                                          layer_norm_eps=layer_norm_eps[1], final_norm=True, **common)
        self.clip2 = VisionTransformerB16(num_classes=num_classes[2], pre_norm=True, act_layer="gelu",
                                          layer_norm_eps=layer_norm_eps[2], final_norm=True, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pair = _flat_pair(x, self.do_resize)
        x_clip = self.clip_normalise(pair)
        z = torch.cat([self.dino(self.dino_normalise(pair)), self.clip1(x_clip), self.clip2(x_clip)], dim=1)
        return _distance(z, x.shape[1])


def split_vit_qkv(state_dict: dict) -> dict:
    """Split timm's fused ``attn.qkv.{weight,bias}`` into q/k/v (numpy arrays
    or tensors, split on their first axis)."""
    out = {}
    for k, v in state_dict.items():
        if ".attn.qkv." in k:
            suffix = k.rsplit(".", 1)[-1]
            base = k.rsplit("qkv." + suffix, 1)[0]
            q, kk, vv = np.split(np.asarray(v), 3, axis=0)
            out[f"{base}q.{suffix}"] = q
            out[f"{base}k.{suffix}"] = kk
            out[f"{base}v.{suffix}"] = vv
        else:
            out[k] = v
    return out


class AutoencoderDreamsim(nn.Module):
    """VAE loss: recon + DreamSim distance (autoencoding/losses/dreamsim.py:16+).
    ``forward(inputs, recons)`` → (per-sample loss [B], log under
    ``{split}/loss/{total,rec,dreamsim}``)."""

    def __init__(self, recon_type: str = "l1", recon_weight: float = 1.0, dreamsim_weight: float = 1.0,
                 ensemble: bool = True, device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.recon_type, self.recon_weight, self.dreamsim_weight = recon_type, recon_weight, dreamsim_weight
        self.ensemble = ensemble
        model = DreamsimEnsemble if ensemble else DreamsimModel
        self.dreamsim = model(do_resize=True, device=device, generator=generator).requires_grad_(False)

    def forward(self, inputs: torch.Tensor, recons: torch.Tensor, split: str = "train"):
        dims = tuple(range(1, inputs.ndim))
        diff = inputs - recons
        rec = diff.square().mean(dim=dims) if self.recon_type in ("l2", "mse") else diff.abs().mean(dim=dims)
        dtype = torch.promote_types(inputs.dtype, recons.dtype)  # each half in its own dtype, then stacked: JAX's order
        pair = torch.stack([((inputs + 1) / 2).to(dtype), ((recons + 1) / 2).to(dtype)])
        dist = self.dreamsim(pair)
        loss = rec * self.recon_weight + dist * self.dreamsim_weight
        log = {f"{split}/loss/total": loss.mean(), f"{split}/loss/rec": rec.mean(),
               f"{split}/loss/dreamsim": dist.mean()}
        return loss, {k: v.detach() for k, v in log.items()}
