"""Loss weightings w(σ) (port of neurosis_tpu/diffusion/weighting.py),
elementwise in σ's dtype; the loss casts the weight to fp32."""

from __future__ import annotations

import math

import torch


class DenoiserWeighting:
    def __call__(self, sigma: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class UnitWeighting(DenoiserWeighting):
    def __call__(self, sigma):
        return torch.ones_like(sigma)


class EpsWeighting(DenoiserWeighting):
    def __call__(self, sigma):
        return sigma**-2.0


class EDMWeighting(DenoiserWeighting):
    def __init__(self, sigma_data: float = 1.0):
        self.sigma_data = sigma_data

    def __call__(self, sigma):
        return (sigma**2 + self.sigma_data**2) / (sigma * self.sigma_data) ** 2


def _rf_weight(t: torch.Tensor, log_snr_arg: torch.Tensor, m: float, s: float) -> torch.Tensor:
    """CFM weight 1/(1−t)² times the logit-normal density over t."""
    cfm_weights = 1.0 / (1.0 - t) ** 2
    pi_weights = ((1.0 / (s * math.sqrt(4.0 * (math.pi / 2.0)))) * (1.0 / (t * (1.0 - t)))
                  * torch.exp(-0.5 * (torch.log(log_snr_arg) - m) ** 2 / s**2))
    return cfm_weights * pi_weights


class RectifiedFlowWeighting(DenoiserWeighting):
    """t = σ/(1+σ)."""

    def __init__(self, m: float = 0.0, s: float = 1.0):
        self.m, self.s = m, s

    def __call__(self, sigma):
        return _rf_weight(sigma / (1.0 + sigma), sigma, self.m, self.s)


class RectifiedFlowComfyWeighting(DenoiserWeighting):
    """σ is t in [0, 1]."""

    def __init__(self, m: float = 0.0, s: float = 1.0):
        self.m, self.s = m, s

    def __call__(self, sigma):
        return _rf_weight(sigma, sigma / (1.0 - sigma), self.m, self.s)


class MinSNRGammaModifier(DenoiserWeighting):
    """min-SNR-γ: the wrapped weight times min(snr, γ)/snr, or /(snr+1) for
    v-prediction, snr = 1/σ²."""

    def __init__(self, weighting: DenoiserWeighting, gamma: float = 5.0, v_pred: bool = False):
        self.weighting, self.gamma, self.v_pred = weighting, gamma, v_pred

    def __call__(self, sigma):
        weights = self.weighting(sigma)
        snr = 1.0 / sigma**2
        snr_weight = torch.clamp_max(snr, self.gamma)
        snr_weight = snr_weight / (snr + 1.0) if self.v_pred else snr_weight / snr
        return weights * snr_weight
