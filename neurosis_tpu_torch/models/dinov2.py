"""DINOv2 vision transformer and ``create_dinov2`` (port of
neurosis_tpu/models/dinov2.py; parity: data/dinov2/acquire.py:26-120).

patch_embed (14×14 conv) → [cls | registers | patches] + pos → blocks of
pre-LN attention and MLP, each scaled by a LayerScale (``ls1``, ``ls2``) →
final LN; vitg14 uses the fused SwiGLU FFN (``mlp.w12``, ``mlp.w3``). NHWC.
The position embeddings are sized for the 518/14 = 37² training grid and
resampled by size (ATen's bicubic, antialiased for the registered
variants) to another grid: like the JAX module, and unlike upstream dinov2,
``interpolate_offset`` does not enter the mapping. Attention is the plain
matmul-softmax (JAX's einsum-softmax; no Pallas kernel).
"""

from __future__ import annotations

import logging
from enum import Enum
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.layers import Conv2d, Dense, LayerNorm32, init_parameters
from ..ops.attention import plain_attention
from ..ops.resize import bicubic_resize

logger = logging.getLogger(__name__)


class DinoV2Config(str, Enum):
    Small = "dinov2_vits14"
    Base = "dinov2_vitb14"
    Large = "dinov2_vitl14"
    Giant = "dinov2_vitg14"
    SmallRegistered = "dinov2_vits14_reg"
    BaseRegistered = "dinov2_vitb14_reg"
    LargeRegistered = "dinov2_vitl14_reg"
    GiantRegistered = "dinov2_vitg14_reg"


# embed_dim, depth, heads, ffn ('mlp' | 'swiglufused')
_ARCH = {
    "vits14": (384, 12, 6, "mlp"),
    "vitb14": (768, 12, 12, "mlp"),
    "vitl14": (1024, 24, 16, "mlp"),
    "vitg14": (1536, 40, 24, "swiglufused"),
}


class _AttentionProjections(nn.Module):
    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.q_proj = Dense(dim, dim, dtype=dtype, device=device)
        self.k_proj = Dense(dim, dim, dtype=dtype, device=device)
        self.v_proj = Dense(dim, dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)


class _Attention(nn.Module):
    """Holds its projections under ``attn`` (JAX's 'attn.q_proj' names)."""

    def __init__(self, dim: int, heads: int, dtype, device):
        super().__init__()
        self.heads = heads
        self.attn = _AttentionProjections(dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        a = self.attn

        def split(t):
            return t.reshape(b, s, self.heads, dim // self.heads).transpose(1, 2)

        out = plain_attention(split(a.q_proj(x)), split(a.k_proj(x)), split(a.v_proj(x)))
        return a.proj(out.transpose(1, 2).reshape(b, s, dim))


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float, device):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, ffn_layer: str, dtype, device):
        super().__init__()
        self.swiglu = ffn_layer == "swiglufused"
        if self.swiglu:  # SwiGLUFFNFused: hidden = round_to_8(2/3 · 4d), w12 fused
            h = (int(hidden * 2 / 3) + 7) // 8 * 8
            self.w12 = Dense(dim, 2 * h, dtype=dtype, device=device)
            self.w3 = Dense(h, dim, dtype=dtype, device=device)
        else:
            self.fc1 = Dense(dim, hidden, dtype=dtype, device=device)
            self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            x1, x2 = self.w12(x).chunk(2, dim=-1)
            return self.w3(F.silu(x1) * x2)
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_layer: str, init_values: float, mlp_ratio: float, dtype, device):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=1e-6, device=device)
        self.attn_wrap = _Attention(dim, heads, dtype, device)
        self.ls1 = _LayerScale(dim, init_values, device)
        self.norm2 = LayerNorm32(dim, eps=1e-6, device=device)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), ffn_layer, dtype, device)
        self.ls2 = _LayerScale(dim, init_values, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn_wrap(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):
    """NHWC images → {x_norm_clstoken, x_norm_regtokens, x_norm_patchtokens}."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, heads: int = 12, patch_size: int = 14,
                 img_size: int = 518, ffn_layer: str = "mlp", init_values: float = 1.0, num_register_tokens: int = 0,
                 interpolate_antialias: bool = False, interpolate_offset: float = 0.1,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim, self.patch_size, self.img_size = embed_dim, patch_size, img_size
        self.interpolate_antialias = interpolate_antialias
        self.interpolate_offset = interpolate_offset  # kept, unused: see the module doc
        self.num_register_tokens = num_register_tokens
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size, padding=0, dtype=dtype,
                                       device=device)
        n_train = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, n_train + 1, embed_dim, device=device))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim, device=device)) \
            if num_register_tokens else None
        self.blocks = nn.ModuleList(_Block(embed_dim, heads, ffn_layer, init_values, 4.0, dtype, device)
                                    for _ in range(depth))
        self.norm = LayerNorm32(embed_dim, eps=1e-6, device=device)
        generator = generator if generator is not None else torch.Generator(device).manual_seed(0)
        init_parameters(self, generator)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def _interp_pos(self, pos: torch.Tensor, grid: int) -> torch.Tensor:
        m = self.img_size // self.patch_size
        if grid == m:
            return pos
        patch = pos[:, 1:].reshape(1, m, m, self.embed_dim)
        patch = bicubic_resize(patch, (grid, grid), align_corners=False, antialias=self.interpolate_antialias)
        return torch.cat([pos[:, :1], patch.reshape(1, grid * grid, self.embed_dim)], dim=1)

    def forward(self, x: torch.Tensor) -> dict:
        b = x.shape[0]
        x = self.patch_embed.proj(x)
        grid = x.shape[1]
        x = x.reshape(b, -1, self.embed_dim)
        pos = self._interp_pos(self.pos_embed, grid)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim), x], dim=1) + pos.to(x.dtype)
        r = self.num_register_tokens
        if r:
            x = torch.cat([x[:, :1], self.register_tokens.to(x.dtype).expand(b, r, self.embed_dim), x[:, 1:]],
                          dim=1)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        return {"x_norm_clstoken": x[:, 0], "x_norm_regtokens": x[:, 1:1 + r], "x_norm_patchtokens": x[:, 1 + r:]}


def dinov2_keys(sd: dict) -> dict:
    """Official dinov2 checkpoint keys → this module's layout (the fused qkv
    split; attention under ``attn_wrap.attn``)."""
    from ..losses.dreamsim import split_vit_qkv

    out = {}
    for k, v in split_vit_qkv(dict(sd)).items():
        k = k.replace(".attn.q.", ".attn_wrap.attn.q_proj.")
        k = k.replace(".attn.k.", ".attn_wrap.attn.k_proj.")
        k = k.replace(".attn.v.", ".attn_wrap.attn.v_proj.")
        k = k.replace(".attn.proj.", ".attn_wrap.attn.proj.")
        out[k] = v
    return out


def load_state(path: Path) -> dict:
    """{name: numpy array} of a .safetensors file (the port's own reader) or a torch .pt file."""
    if path.suffix.lower() == ".safetensors":
        from ..checkpoint.safetensors import load_file

        return {k: v.numpy() for k, v in load_file(path).items()}
    return {k: v.numpy() for k, v in torch.load(str(path), map_location="cpu").items()}


def load_matching(module: nn.Module, sd: dict, what: str) -> dict:
    """Load the entries of ``sd`` (numpy, torch layout) that ``module`` has,
    warning of missing and unexpected keys as JAX's import does; returns the
    state dict loaded."""
    own = module.state_dict()
    state = {k: torch.as_tensor(v, dtype=own[k].dtype) for k, v in sd.items() if k in own}
    missing = [k for k in own if k not in state]
    unexpected = [k for k in sd if k not in own]
    module.load_state_dict(state, strict=False)
    if missing:
        logger.warning(f"{what} import: {len(missing)} missing keys (e.g. {missing[:3]})")
    if unexpected:
        logger.warning(f"{what} import: {len(unexpected)} unexpected keys (e.g. {unexpected[:3]})")
    return state


def create_dinov2(config, ckpt_path: Optional[str] = None, data_dir: str = "data/dinov2",
                  dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                  generator: Optional[torch.Generator] = None) -> Tuple[DinoVisionTransformer, Optional[dict]]:
    """A DINOv2 variant, with the weights of ``ckpt_path`` or of the file
    named for the config under ``data_dir`` loaded into it when there is one
    (acquire.py:47-120); else it keeps its default init and warns. Returns
    (module, the state dict loaded or None)."""
    config = DinoV2Config(config)
    arch_key = config.value.replace("dinov2_", "").replace("_reg", "")
    dim, depth, heads, ffn = _ARCH[arch_key]
    registered = config.value.endswith("_reg")
    model = DinoVisionTransformer(embed_dim=dim, depth=depth, heads=heads, ffn_layer=ffn, init_values=1.0,
                                  num_register_tokens=4 if registered else 0, interpolate_antialias=registered,
                                  interpolate_offset=0.0 if registered else 0.1, dtype=dtype, device=device,
                                  generator=generator)
    path = Path(ckpt_path) if ckpt_path else None
    if path is None:
        base = Path(data_dir)
        if base.is_dir():
            path = next((f for f in sorted(base.iterdir()) if f.stem == config.value), None)
    if path is None or not path.exists():
        logger.warning("No DINOv2 weights found, using default initialization")
        return model, None
    return model, load_matching(model, dinov2_keys(load_state(path)), "DINOv2")
