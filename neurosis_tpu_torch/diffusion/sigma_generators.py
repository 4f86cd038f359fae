"""Train-time σ sampling (port of neurosis_tpu/diffusion/sigma_generators.py).

The loss draws one uniform t per sample and feeds every generator from it
(reference loss.py:116-120); a generator called without ``t`` draws its own
native distribution from ``generator``. ``EDMSigmaGenerator`` takes the
loss's uniform t in place of its normal draw, as the reference and JAX do.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..parallel import rows
from .discretization import Discretization


class SigmaGenerator:
    def _draw(self, n_samples: int, t: Optional[torch.Tensor], generator: Optional[torch.Generator],
              device: DeviceLike, normal: bool = False) -> torch.Tensor:
        if t is not None:
            return t.float()
        if generator is None:
            raise ValueError(f"{type(self).__name__} needs either a pre-drawn t or a generator")
        return rows.draw(torch.randn if normal else torch.rand, (n_samples,), generator=generator,
                         device=resolve_device(device or generator.device))


class EDMSigmaGenerator(SigmaGenerator):
    """σ = exp(p_mean + p_std·t)·scale; t ~ N(0, 1) when drawn here."""

    def __init__(self, p_mean: float = -1.2, p_std: float = 1.2, scale: float = 2.0):
        self.p_mean, self.p_std, self.scale = p_mean, p_std, scale

    def __call__(self, n_samples: int, t: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> torch.Tensor:
        t = self._draw(n_samples, t, generator, device, normal=True)
        return torch.exp(self.p_mean + self.p_std * t) * self.scale


class DiscreteSigmaGenerator(SigmaGenerator):
    """Uniform index into the flipped σ table. ``exclude_zero`` (default True,
    the JAX package's documented deviation) drops the table's leading σ=0,
    which eps weighting turns into a NaN loss. A fractional t in [0, 1) maps
    to index floor(t·num_idx); an integer t ≥ 1 is an index.
    ``do_append_zero`` is taken and, as in JAX, not read: the table's
    discretization decides."""

    def __init__(self, discretization: Discretization, num_idx: int = 1000, do_append_zero: bool = True,
                 flip: bool = True, exclude_zero: bool = True, device: DeviceLike = None):
        self.num_idx = num_idx
        table = discretization.table(num_idx, flip=flip)
        if exclude_zero and table.shape[0] > num_idx and table[0] == 0.0:
            table = table[1:]
        self.sigmas = torch.as_tensor(np.ascontiguousarray(table), device=resolve_device(device))

    def __call__(self, n_samples: int, t: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> torch.Tensor:
        if t is None:
            if generator is None:
                raise ValueError("DiscreteSigmaGenerator needs either a pre-drawn t or a generator")
            idx = rows.draw(lambda shape, **kw: torch.randint(0, self.num_idx, shape, **kw), (n_samples,),
                            generator=generator, device=self.sigmas.device)
            return self.sigmas[idx]
        t = t.float()
        idx = torch.where((t >= 0.0) & (t < 1.0), torch.floor(t * self.num_idx), t).to(torch.int64)
        return self.sigmas[idx.clamp(0, self.num_idx - 1)]


class CosineScheduleSigmaGenerator(SigmaGenerator):
    """iDDPM cosine schedule in logSNR space (reference sigma_generators.py:60-92)."""

    def __init__(self, s: float = 0.008, sigma_data: float = 1.0):
        self.s, self.sigma_data = s, sigma_data

    def __call__(self, n_samples: int, t: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None, shift: float = 1.0,
                 return_logSNR: bool = False) -> torch.Tensor:
        if t is None:
            t = torch.clamp(1.0 - self._draw(n_samples, None, generator, device) + 0.001, 0.001, 1.0)
        t = t.float()
        s = self.s
        min_var = math.cos(s / (1 + s) * math.pi * 0.5) ** 2
        var = torch.clamp(torch.cos((s + t) / (1 + s) * math.pi * 0.5), 0.0, 1.0) ** 2 / min_var
        var = 0.0001 + var * 0.9999
        log_snr = torch.log(var / (1 - var))
        if shift != 1:
            log_snr = log_snr + 2 * math.log(1 / shift)
        if return_logSNR:
            return log_snr
        return torch.exp(-log_snr / 2) * self.sigma_data


class TanScheduleSigmaGenerator(SigmaGenerator):
    """σ = scale·tan(π/2·t), the angle clipped to [start_shift, π/2 − end_shift]."""

    def __init__(self, start_shift: float = 0.001, end_shift: float = 0.001, scale: float = 1.0, clip: bool = True):
        self.start_shift, self.end_shift, self.scale, self.clip = start_shift, end_shift, scale, clip

    def __call__(self, n_samples: int, t: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> torch.Tensor:
        half_pi = math.pi / 2.0
        half_pi_t = half_pi * self._draw(n_samples, t, generator, device)
        if self.clip:
            half_pi_t = torch.clamp(half_pi_t, self.start_shift, half_pi - self.end_shift)
        return torch.tan(half_pi_t) * self.scale


class RectifiedFlowSigmaGenerator(SigmaGenerator):
    """σ = t/(1−t), t clipped to [start_shift, 1 − end_shift]."""

    def __init__(self, start_shift: float = 0.0, end_shift: float = 0.001, clip: bool = True):
        self.start_shift, self.end_shift, self.clip = start_shift, end_shift, clip

    def __call__(self, n_samples: int, t: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> torch.Tensor:
        t = self._draw(n_samples, t, generator, device)
        if self.clip:
            t = torch.clamp(t, self.start_shift, 1.0 - self.end_shift)
        return t / (1.0 - t)


class RectifiedFlowComfySigmaGenerator(SigmaGenerator):
    """σ = t clipped to [start_shift, 1 − end_shift] (the comfy convention)."""

    def __init__(self, start_shift: float = 0.0, end_shift: float = 0.001, clip: bool = True):
        self.start_shift, self.end_shift, self.clip = start_shift, end_shift, clip

    def __call__(self, n_samples: int, t: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None) -> torch.Tensor:
        t = self._draw(n_samples, t, generator, device)
        if self.clip:
            t = torch.clamp(t, self.start_shift, 1.0 - self.end_shift)
        return t
