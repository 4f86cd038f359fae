"""LPIPS perceptual distance, NHWC (port of neurosis_tpu/losses/lpips.py).

AlexNet or VGG16 feature trunk in torchvision's ``features`` layout, unit
normalisation over channels at five ReLU taps, learned 1×1 lin heads, a
spatial mean summed over taps. The lin heads load from the port's own copy
of the LPIPS v0.1 weights (``assets/lpips``); the trunk weights are not in
the repository (the reference fetches torchvision's at run time), so the
trunk starts from the package's seeded init until a state dict is loaded.
Inputs in [-1, 1].
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..checkpoint.safetensors import load_file
from ..modules.layers import Conv2d, init_parameters

ASSETS = Path(__file__).resolve().parent.parent / "assets" / "lpips"

# ImageNet scaling (perceptual.py:189-199)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _MaxPool(nn.Module):
    """VALID max pool on NHWC."""

    def __init__(self, k: int, s: int):
        super().__init__()
        self.k, self.s = k, s

    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), self.k, self.s).permute(0, 2, 3, 1)


def _trunk(layout, device) -> tuple[nn.Sequential, tuple]:
    """torchvision ``features`` from (kind, args) entries; returns the
    Sequential and the indices of its tapped ReLUs."""
    layers, taps = [], []
    for kind, *args in layout:
        if kind == "conv":
            c_in, c_out, k, s, p = args
            layers.append(Conv2d(c_in, c_out, k, stride=s, padding=p, device=device))
        elif kind == "relu":
            layers.append(nn.ReLU())
            if args and args[0]:
                taps.append(len(layers) - 1)
        else:
            layers.append(_MaxPool(*args))
    return nn.Sequential(*layers), tuple(taps)


def _alex_layout():
    return [("conv", 3, 64, 11, 4, 2), ("relu", True), ("pool", 3, 2),
            ("conv", 64, 192, 5, 1, 2), ("relu", True), ("pool", 3, 2),
            ("conv", 192, 384, 3, 1, 1), ("relu", True),
            ("conv", 384, 256, 3, 1, 1), ("relu", True),
            ("conv", 256, 256, 3, 1, 1), ("relu", True)]


def _vgg_layout():
    out, c_in = [], 3
    for block, (n, c) in enumerate(((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))):
        for i in range(n):
            out += [("conv", c_in, c, 3, 1, 1), ("relu", i == n - 1)]
            c_in = c
        if block < 4:
            out.append(("pool", 2, 2))
    return out


ALEX_CHANNELS = (64, 192, 384, 256, 256)
VGG_CHANNELS = (64, 128, 256, 512, 512)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet.features; returns the ReLU taps 1/4/7/9/11."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self.features, self.taps = _trunk(_alex_layout(), resolve_device(device))

    def forward(self, x):
        return _run_taps(self.features, self.taps, x)


class VGG16Features(nn.Module):
    """torchvision VGG16.features; returns the ReLU taps 3/8/15/22/29."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self.features, self.taps = _trunk(_vgg_layout(), resolve_device(device))

    def forward(self, x):
        return _run_taps(self.features, self.taps, x)


def _run_taps(features: nn.Sequential, taps: tuple, x: torch.Tensor) -> list:
    out = []
    for i, layer in enumerate(features):
        x = layer(x)
        if i in taps:
            out.append(x)
        if i == taps[-1]:
            break
    return out


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return feat / (feat.square().sum(dim=-1, keepdim=True).sqrt() + eps)


class _NetLin(nn.Module):
    """1×1 conv to one channel, no bias (NetLinLayer); ``model.1`` as in
    the shipped weights."""

    def __init__(self, channels: int, device):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), Conv2d(channels, 1, 1, padding=0, bias=False, device=device))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """forward(x, y) → (B, 1, 1, 1) perceptual distance (perceptual.py:160-186)."""

    def __init__(self, pnet_type: str = "alex", device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, lin_path: Optional[Path] = None):
        super().__init__()
        device = resolve_device(device)
        alex = "alex" in pnet_type
        self.pnet = AlexNetFeatures(device) if alex else VGG16Features(device)
        for i, c in enumerate(ALEX_CHANNELS if alex else VGG_CHANNELS):
            self.add_module(f"lin{i}", _NetLin(c, device))
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device), persistent=False)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))
        heads = load_file(lin_path or ASSETS / f"{'alex' if alex else 'vgg'}_lpips_v0.1.safetensors")
        with torch.no_grad():
            for name, w in heads.items():
                self.get_parameter(name).copy_(w)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape[1] < 32 or x.shape[2] < 32:
            raise ValueError(f"LPIPS needs inputs >= 32px (got {x.shape[1]}x{x.shape[2]})")
        n = x.shape[0]
        both = (torch.cat([x.float(), y.float()]) - self.shift) / self.scale
        val = 0.0
        for i, f in enumerate(self.pnet(both)):
            f = _unit_normalize(f)
            diff = (f[:n] - f[n:]).square()
            val = val + getattr(self, f"lin{i}")(diff).mean(dim=(1, 2), keepdim=True)
        return val
