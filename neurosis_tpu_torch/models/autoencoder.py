"""AutoencoderKL: the VAE with its quant convs (port of
neurosis_tpu/models/autoencoder.py).

Children ``encoder``, ``decoder``, ``quant_conv`` and ``post_quant_conv``
carry the sgm checkpoint names. ``encode`` returns the moments
[B, h, w, 2·embed_dim]; ``decode`` takes latents.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.layers import Conv2d, init_parameters
from .vae import Decoder, Encoder


class AutoencoderKL(nn.Module):
    """Built on CUDA unless ``device`` says otherwise, with weights drawn
    from ``generator``."""

    def __init__(self, ddconfig: dict, embed_dim: int = 4, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dd = dict(ddconfig)
        attn_type = dd.pop("attn_type", "vanilla")
        double_z = dd.pop("double_z", True)
        z_ch = dd.get("z_channels", 4)
        common = dict(ch=dd["ch"], ch_mult=dd.get("ch_mult", [1, 2, 4, 8]), num_res_blocks=dd["num_res_blocks"],
                      attn_resolutions=dd.get("attn_resolutions", []), resolution=dd.get("resolution", 256),
                      z_channels=z_ch, dropout=dd.get("dropout", 0.0), attn_type=attn_type, dtype=dtype,
                      device=device)
        g = generator if generator is not None else torch.Generator(device).manual_seed(0)
        self.encoder = Encoder(in_channels=dd.get("in_channels", 3), double_z=double_z, generator=g, **common)
        self.decoder = Decoder(out_ch=dd.get("out_ch", 3), generator=g, **common)
        mult = 2 if double_z else 1
        self.quant_conv = Conv2d(mult * z_ch, mult * embed_dim, 1, padding=0, dtype=dtype, device=device)
        self.post_quant_conv = Conv2d(embed_dim, z_ch, 1, padding=0, dtype=dtype, device=device)
        init_parameters(self.quant_conv, g)
        init_parameters(self.post_quant_conv, g)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """image [B, H, W, C] in [-1, 1] → moments [B, h, w, 2·embed_dim]."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Encode, then decode the posterior mean."""
        mean, _ = self.encode(x).chunk(2, dim=-1)
        return self.decode(mean)
