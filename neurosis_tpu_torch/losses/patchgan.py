"""Pix2pix PatchGAN discriminator, NHWC (port of neurosis_tpu/losses/patchgan.py).

``layers`` keeps the reference's torch indices (conv, norm, LeakyReLU
triples), with a conv bias only where no BatchNorm follows. Init as
weights_init: conv weights N(0, 0.02), BatchNorm scales N(1, 0.02), zero
biases.

The BatchNorm follows flax's, not torch's: statistics in fp32 with
var = max(0, E[x²] − E[x]²), and the running variance is the *biased* batch
variance (torch keeps the unbiased one), updated as
running = 0.9·running + 0.1·batch (flax momentum 0.9 is torch momentum 0.1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.layers import Conv2d


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NHWC channels."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x32 = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mean = x32.mean(dim=dims)
            var = (x32.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean.detach() * (1.0 - self.momentum))
                self.running_var.mul_(self.momentum).add_(var.detach() * (1.0 - self.momentum))
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)

        def conv(c_in, c_out, stride, bias=True):
            return Conv2d(c_in, c_out, 4, stride=stride, padding=1, bias=bias, dtype=dtype, device=device)

        layers = [conv(input_nc, ndf, 2), nn.LeakyReLU(0.2)]
        c_in = ndf
        for n in range(n_layers):
            layer_num = n + 1
            c_out = ndf * min(2 ** layer_num, 8)
            layers += [conv(c_in, c_out, 2 if layer_num < n_layers else 1, bias=False),
                       BatchNorm(c_out, device=device), nn.LeakyReLU(0.2)]
            c_in = c_out
        layers.append(conv(c_in, 1, 1))
        self.layers = nn.Sequential(*layers)
        self.reset_parameters(generator if generator is not None else torch.Generator(device).manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.layers:
            if isinstance(m, Conv2d):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.normal_(1.0, 0.02, generator=generator)
                m.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        for m in self.layers:
            x = m(x, train) if isinstance(m, BatchNorm) else m(x)
        return x
