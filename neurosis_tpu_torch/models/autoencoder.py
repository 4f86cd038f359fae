"""AutoencoderKL: the VAE with its quant convs, its inference wrapper,
IdentityFirstStage and AEIntegerWrapper (port of
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


class AutoencoderKLInferenceWrapper(AutoencoderKL):
    """``encode`` returns a latent: the posterior's sample drawn from
    ``generator``, or its mode without one (models/autoencoder.py:640-643)."""

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        from ..modules.distributions import DiagonalGaussian

        dist = DiagonalGaussian.from_moments(super().encode(x))
        return dist.sample(generator) if generator is not None else dist.mode()


class IdentityFirstStage:
    """Pass-through first stage for pixel-space diffusion
    (models/autoencoder.py:645-660): encode and decode are the identity. The
    builder reads its class path and sets the engine's
    ``identity_first_stage``, which still applies ``scale_factor``."""

    def __init__(self, input_key: str = "jpg", **_):
        self.input_key = input_key

    def get_input(self, batch: dict):
        return batch[self.input_key]

    def encode(self, x, *args, **kwargs):
        return x

    def decode(self, x, *args, **kwargs):
        return x


class AEIntegerWrapper:
    """A VQ autoencoder as a codec of integer tokens (models/autoencoder.py:662-700):
    ``encode`` gives each image's codebook indices, flat [B, h·w];
    ``decode`` looks them up in the quantizer's codebook (as [B, h, w] with
    ``shape`` (h, w)) and decodes. ``model`` has ``encode`` and ``decode``
    (an AutoencoderKL, or the VAE trainer's engine); ``variables`` and
    ``quantizer_variables``, JAX's arguments, are None (the modules keep
    their weights) or JAX parameter trees (``{"params": ...}``) loaded into
    ``model`` and ``quantizer`` with ``strict=True``."""

    def __init__(self, model, variables, quantizer, quantizer_variables, shape=(16, 16)):
        if not (hasattr(model, "encode") and hasattr(model, "decode")):
            raise ValueError("Need AE interface (encode and decode methods)")
        from ..checkpoint.convert import jax_params_to_state_dict

        for module, tree in ((model, variables), (quantizer, quantizer_variables)):
            if tree is not None:
                module.load_state_dict(jax_params_to_state_dict(tree["params"]), strict=True)
        self.model, self.quantizer = model, quantizer
        self.shape = tuple(shape) if shape is not None else None

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        _, log = self.quantizer(self.model.encode(x))
        idx = log["min_encoding_indices"]
        return idx.reshape(idx.shape[0], -1)

    @torch.no_grad()
    def decode(self, indices: torch.Tensor, shape=None) -> torch.Tensor:
        shape = shape or self.shape
        if shape is not None:
            if len(shape) != 2:
                raise ValueError(f"Invalid input shape: {shape}")
            indices = indices.reshape(indices.shape[0], shape[0], shape[1])
        return self.model.decode(self.quantizer.get_codebook_entry(indices))
