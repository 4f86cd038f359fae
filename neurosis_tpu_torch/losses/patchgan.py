"""Pix2pix PatchGAN discriminator, NHWC (port of neurosis_tpu/losses/patchgan.py).

``layers`` keeps the reference's torch indices (conv, norm, LeakyReLU
triples), with a conv bias only where no BatchNorm follows. Init as
weights_init: conv weights N(0, 0.02), BatchNorm scales N(1, 0.02), zero
biases.

The BatchNorm follows flax's, not torch's: statistics in fp32 with
var = max(0, E[x²] − E[x]²), and the running variance is the *biased* batch
variance (torch keeps the unbiased one), updated as
running = 0.9·running + 0.1·batch (flax momentum 0.9 is torch momentum 0.1);
with ``train=False`` it normalises by the running statistics.

With ``use_actnorm`` an ``ActNorm`` takes each BatchNorm's place (and the
conv before it keeps its bias), as the reference's model.py:31-48.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.layers import Conv2d
from ..parallel import rows
from ..parallel.fsdp import assign, is_dtensor


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
            mean = rows.batch_mean(x32, dims)
            var = (rows.batch_mean(x32.square(), dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean.detach() * (1.0 - self.momentum))
                self.running_var.mul_(self.momentum).add_(var.detach() * (1.0 - self.momentum))
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class ActNorm(nn.Module):
    """Per-channel affine with a data-dependent init (modules/layers.py:10-86):
    ``loc`` and ``scale`` are set from the first batch it sees to −mean and
    1/(std + 1e-6) over every axis but the channels (JAX's ``init`` on the
    first batch; the global batch's on a mesh), then train as parameters.
    ``initialized`` records that (a loaded state dict counts as
    initialised). NHWC; a 2-D input is (B, C). Inside an FSDP2 forward the
    init lands on the gathered parameters; ``settle`` (after the backward)
    writes it into the sharded ones."""

    def __init__(self, channels: int, logdet: bool = False, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.logdet = logdet
        self.loc = nn.Parameter(torch.zeros(channels, device=device))
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.uint8, device=device), persistent=False)
        self.pending: Optional[tuple] = None  # the init's (loc, scale), until settled

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if prefix + "loc" in state_dict:
            self.initialized.fill_(1)

    @torch.no_grad()
    def initialize(self, x32: torch.Tensor) -> None:
        dims = tuple(range(x32.ndim - 1))
        if rows.current() is None:
            self.loc.copy_(-x32.mean(dim=dims))
            self.scale.copy_(1.0 / (x32.std(dim=dims, correction=0) + 1e-6))
        else:  # the global batch's mean and (two-pass) std
            mean = rows.batch_mean(x32, dims)
            self.loc.copy_(-mean)
            self.scale.copy_(1.0 / (rows.batch_mean((x32 - mean).square(), dims).sqrt() + 1e-6))
        self.initialized.fill_(1)
        self.pending = (self.loc.detach().clone(), self.scale.detach().clone())

    def settle(self) -> None:
        """Write a pending init into the parameters once they are the sharded
        (DTensor) ones again: FSDP2 drops the gathered copy the init wrote to.
        Plain parameters hold it already (the pending copy is then kept)."""
        if self.pending is not None and is_dtensor(self.loc):
            assign(self.loc, self.pending[0])
            assign(self.scale, self.pending[1])
            self.pending = None

    def forward(self, x: torch.Tensor, reverse: bool = False):
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, None, :]
        x32 = x.float()
        if not bool(self.initialized):
            self.initialize(x32)
        h = (x32 / self.scale - self.loc) if reverse else self.scale * (x32 + self.loc)
        h = h.to(x.dtype)
        if squeeze:
            h = h[:, 0, 0, :]
        if self.logdet and not reverse:
            ld = x.shape[1] * x.shape[2] * torch.log(self.scale.abs()).sum()
            return h, ld * torch.ones(x.shape[0], device=x.device)
        return h


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3, use_actnorm: bool = False,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)

        def conv(c_in, c_out, stride, bias=True):
            return Conv2d(c_in, c_out, 4, stride=stride, padding=1, bias=bias, dtype=dtype, device=device)

        layers = [conv(input_nc, ndf, 2), nn.LeakyReLU(0.2)]
        c_in = ndf
        for n in range(n_layers):
            layer_num = n + 1
            c_out = ndf * min(2 ** layer_num, 8)
            norm = ActNorm(c_out, device=device) if use_actnorm else BatchNorm(c_out, device=device)
            layers += [conv(c_in, c_out, 2 if layer_num < n_layers else 1, bias=use_actnorm), norm,
                       nn.LeakyReLU(0.2)]
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
