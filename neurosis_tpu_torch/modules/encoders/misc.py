"""Misc embedders (port of neurosis_tpu/modules/encoders/misc.py).

``ClassEmbedder`` (class labels → a vector, the last class the UCG class),
``ClassEmbedderForMultiCond``, ``GaussianEncoder`` (a VAE encoder as an
embedder), ``SpatialRescaler`` and ``LowScaleEncoder`` (noise-augmented
low-resolution conditioning). Images are NHWC. The resizes are JAX's
``jax.image.resize`` (an antialiased kernel when shrinking; ``nearest`` by
its own index rule), written here in torch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..._device import DeviceLike, resolve_device
from ...diffusion.discretization import LegacyDDPMDiscretization
from ...models.vae import Encoder
from ..distributions import DiagonalGaussian
from ..layers import Conv2d, Embed, init_parameters
from .embedding import AbstractEmbModel


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "triangle": _triangle, "cubic": _keys_cubic,
            "bicubic": _keys_cubic}


def _weight_mat(m: int, n: int, kernel, device) -> torch.Tensor:
    """[m, n] weights of jax.image's scale_and_translate (translation 0,
    antialiased): output j samples input (j + 0.5)·m/n − 0.5 with the kernel
    widened by m/n when shrinking, normalised, zero outside the input."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, size: tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), method)`` for NHWC ``x``."""
    if method == "nearest":
        for axis, n in ((1, size[0]), (2, size[1])):
            m = x.shape[axis]
            if m != n:
                idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).long().to(x.device)
                x = x.index_select(axis, idx)
        return x
    if method not in _KERNELS:
        raise ValueError(f"resize method {method!r} is not ported (nearest, linear, cubic)")
    dt = torch.promote_types(x.dtype, torch.float32) if not x.is_floating_point() else x.dtype
    x = x.to(dt)
    for axis, n in ((1, size[0]), (2, size[1])):
        m = x.shape[axis]
        if m != n:
            w = _weight_mat(m, n, _KERNELS[method], x.device).to(dt)
            x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x


class ClassEmbedder(AbstractEmbModel):
    """int class labels → an embedding vector; the table has exactly
    ``n_classes`` rows, and the last class doubles as the unconditional
    (UCG) one."""

    def __init__(self, embed_dim: int = 512, n_classes: int = 1000, add_sequence_dim: bool = False,
                 input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 base_lr: Optional[float] = None, emb_name: Optional[str] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        device = resolve_device(device)
        self.n_classes, self.add_sequence_dim = n_classes, add_sequence_dim
        self.embedding = Embed(n_classes, embed_dim, device=device)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))
        self.requires_grad_(is_trainable)

    def forward(self, c: torch.Tensor) -> tuple:
        emb = self.embedding(c.long())
        if self.add_sequence_dim:
            emb = emb[:, None, :]
        return (emb,)

    def uncond_class(self) -> int:
        return self.n_classes - 1


class ClassEmbedderForMultiCond(ClassEmbedder):
    """A ClassEmbedder that takes a list-valued batch entry and embeds its
    first element."""

    def forward(self, c) -> tuple:
        if isinstance(c, (list, tuple)):
            c = c[0]
        return super().forward(c)


class GaussianEncoder(AbstractEmbModel):
    """A VAE encoder as an embedder: image → latent tokens [B, h·w, z] (or
    the latent map without ``flatten_output``): the posterior's mean, or a
    sample drawn from ``generator``."""

    def __init__(self, ch: int = 64, ch_mult: Sequence[int] = (1, 2), num_res_blocks: int = 1, z_channels: int = 4,
                 resolution: int = 256, weight: float = 1.0, flatten_output: bool = True, input_key: str = "caption",
                 ucg_rate: float = 0.0, is_trainable: bool = False, base_lr: Optional[float] = None,
                 emb_name: Optional[str] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        self.weight, self.flatten_output = weight, flatten_output
        self.encoder = Encoder(ch, list(ch_mult), num_res_blocks, [], resolution=resolution, z_channels=z_channels,
                               device=device, generator=generator)
        self.requires_grad_(is_trainable)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> tuple:
        posterior = DiagonalGaussian.from_moments(self.encoder(x))
        z = posterior.sample(generator) if generator is not None else posterior.mode()
        if self.flatten_output:
            b, h, w, c = z.shape
            z = z.reshape(b, h * w, c)
        return (z,)


class SpatialRescaler(AbstractEmbModel):
    """``n_stages`` resizes by ``multiplier`` (``method`` as jax.image's),
    then an optional 1x1 conv to ``out_channels``."""

    def __init__(self, n_stages: int = 1, multiplier: float = 0.5, in_channels: int = 3,
                 out_channels: Optional[int] = None, method: str = "bilinear", input_key: str = "caption",
                 ucg_rate: float = 0.0, is_trainable: bool = False, base_lr: Optional[float] = None,
                 emb_name: Optional[str] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        device = resolve_device(device)
        self.n_stages, self.multiplier, self.method = n_stages, multiplier, method
        self.out_channels = out_channels
        if out_channels is not None:
            self.channel_mapper = Conv2d(in_channels, out_channels, 1, padding=0, device=device)
            init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))
        self.requires_grad_(is_trainable)

    def forward(self, x: torch.Tensor) -> tuple:
        for _ in range(self.n_stages):
            h, w = x.shape[1:3]
            x = resize(x, (max(int(h * self.multiplier), 1), max(int(w * self.multiplier), 1)), self.method)
        if self.out_channels is not None:
            x = self.channel_mapper(x)
        return (x,)


class LowScaleEncoder(AbstractEmbModel):
    """Noise-augmented low-resolution conditioning: (an optional first
    stage's posterior mode) × ``scale_factor``, noised to a DDPM level, then
    resized (nearest) to ``output_size``; returns (latent, noise level).
    The level is ``noise_level`` when given, else drawn in [0,
    ``max_noise_level``) from ``generator``, else 0; the noise is ``noise``
    when given, else drawn from ``generator``, else from a generator seeded
    0 (JAX draws it from ``PRNGKey(0)`` without a key)."""

    def __init__(self, model: Optional[nn.Module] = None, linear_start: float = 0.00085, linear_end: float = 0.0120,
                 timesteps: int = 1000, max_noise_level: int = 250, output_size: int = 64, scale_factor: float = 1.0,
                 input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 base_lr: Optional[float] = None, emb_name: Optional[str] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        self.model = model
        self.max_noise_level, self.output_size, self.scale_factor = max_noise_level, output_size, scale_factor
        disc = LegacyDDPMDiscretization(linear_start=linear_start, linear_end=linear_end, num_timesteps=timesteps)
        self.register_buffer("alphas_cumprod", torch.tensor(disc.alphas_cumprod, dtype=torch.float32),
                             persistent=False)
        self.requires_grad_(is_trainable)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise_level: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None) -> tuple:
        b = x.shape[0]
        if noise_level is None:
            noise_level = torch.zeros((b,), dtype=torch.int64, device=x.device) if generator is None else \
                torch.randint(0, self.max_noise_level, (b,), generator=generator, device=x.device)
        z = x
        if self.model is not None:
            z = DiagonalGaussian.from_moments(self.model.encode(x)).mode()
        z = z * self.scale_factor
        a = self.alphas_cumprod.to(z.device)[noise_level.long()].reshape((b,) + (1,) * (z.ndim - 1))
        if noise is None:
            gen = generator if generator is not None else torch.Generator(z.device).manual_seed(0)
            noise = torch.randn(z.shape, generator=gen, dtype=z.dtype, device=z.device)
        z_noisy = torch.sqrt(a) * z + torch.sqrt(1.0 - a) * noise.to(z.dtype)
        if self.output_size is not None and z_noisy.shape[1] != self.output_size:
            z_noisy = resize(z_noisy, (self.output_size, self.output_size), "nearest")
        return (z_noisy, noise_level)
