"""CFG guiders (port of neurosis_tpu/sampling/guidance.py; parity:
modules/guidance.py:10-40): the unconditional and conditional halves ride
one doubled batch through the denoiser."""

from __future__ import annotations

import torch

COND_KEYS = ("vector", "crossattn", "concat")


class Guider:
    def __call__(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def prepare_inputs(self, x, s, c: dict, uc: dict):
        raise NotImplementedError


class VanillaCFG(Guider):
    """uncond/cond batch doubling + lerp by scale (guidance.py:20-40)."""

    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        return x_u + self.scale * (x_c - x_u)

    def prepare_inputs(self, x, s, c: dict, uc: dict):
        c_out = {k: torch.cat([uc[k], c[k]], dim=0) if k in COND_KEYS else c[k] for k in c}
        return torch.cat([x, x]), torch.cat([s, s]), c_out


class IdentityGuider(Guider):
    def __call__(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        return x

    def prepare_inputs(self, x, s, c: dict, uc: dict):
        return x, s, dict(c)
