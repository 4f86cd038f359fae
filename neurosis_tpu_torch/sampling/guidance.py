"""CFG guiders (port of neurosis_tpu/sampling/guidance.py; parity:
modules/guidance.py:10-90): the unconditional and conditional halves ride
one doubled batch through the denoiser."""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils import append_dims

COND_KEYS = ("vector", "crossattn", "concat")


def _doubled(x, s, c: dict, uc: dict, keys) -> tuple:
    c_out = {k: torch.cat([uc[k], c[k]], dim=0) if k in keys else c[k] for k in c}
    return torch.cat([x, x]), torch.cat([s, s]), c_out


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
        return _doubled(x, s, c, uc, COND_KEYS)


class IdentityGuider(Guider):
    def __call__(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        return x

    def prepare_inputs(self, x, s, c: dict, uc: dict):
        return x, s, dict(c)


class LinearPredictionGuider(Guider):
    """Per-frame scale ramp for video batches (guidance.py:52-89): the batch
    is ``b`` clips of ``num_frames`` frames, frame t guided at the t-th of
    ``num_frames`` scales from ``min_scale`` to ``max_scale``."""

    def __init__(self, max_scale: float, num_frames: int, min_scale: float = 1.0,
                 additional_cond_keys: Sequence[str] = ()):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.num_frames = num_frames
        self.scale = torch.linspace(min_scale, max_scale, num_frames)[None, :]
        if isinstance(additional_cond_keys, str):
            additional_cond_keys = [additional_cond_keys]
        self.additional_cond_keys = list(additional_cond_keys)

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        x_u, x_c = x.chunk(2, dim=0)
        t = self.num_frames
        b = x_u.shape[0] // t
        x_u = x_u.reshape((b, t) + x_u.shape[1:])
        x_c = x_c.reshape((b, t) + x_c.shape[1:])
        scale = append_dims(self.scale.to(x.device, x.dtype).expand(b, t), x_u.ndim)
        out = x_u + scale * (x_c - x_u)
        return out.reshape((b * t,) + out.shape[2:])

    def prepare_inputs(self, x, s, c: dict, uc: dict):
        return _doubled(x, s, c, uc, set(COND_KEYS) | set(self.additional_cond_keys))
