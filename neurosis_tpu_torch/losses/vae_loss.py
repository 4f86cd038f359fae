"""VAE training losses (port of neurosis_tpu/losses/vae_loss.py).

``forward(inputs, recons, ...)`` returns (loss, log): a per-sample (B,)
loss for the generator, a scalar for the discriminator, and a dict of 0-d
tensors under the reference's ``train/`` log names. Only the training
forward is ported (the discriminator in train mode, the gate on
``global_step``); the eval split waits for ``eval_step``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from .functions import get_discr_loss_fn
from .lpips import LPIPS
from .patchgan import NLayerDiscriminator


def _recon(inputs: torch.Tensor, recons: torch.Tensor, recon_type: str) -> torch.Tensor:
    dims = tuple(range(1, inputs.ndim))
    if recon_type in ("l2", "mse"):
        return (inputs - recons).square().mean(dim=dims)
    return (inputs - recons).abs().mean(dim=dims)


class AutoencoderPerceptual(nn.Module):
    """recon (L1 or L2) + LPIPS (vae_lpips_discr.py:25-137)."""

    def __init__(self, recon_type: str = "l1", recon_weight: float = 1.0, perceptual_weight: float = 1.0,
                 lpips_type: str = "alex", device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.recon_type, self.recon_weight, self.perceptual_weight = recon_type, recon_weight, perceptual_weight
        self.perceptual_loss = LPIPS(lpips_type, device=device, generator=generator).requires_grad_(False)

    def forward(self, inputs: torch.Tensor, recons: torch.Tensor):
        inputs = inputs.float().clamp(-1.0, 1.0)
        recons = recons.float().clamp(-1.0, 1.0)
        rec = _recon(inputs, recons, self.recon_type) * self.recon_weight
        p = F.relu(self.perceptual_loss(inputs, recons)).reshape(-1) * self.perceptual_weight
        loss = rec + p
        return loss, {"train/loss/total": loss.mean(), "train/loss/rec": rec.mean(), "train/loss/p": p.mean()}


class AutoencoderLPIPSWithDiscr(nn.Module):
    """recon + LPIPS + PatchGAN (vae_lpips_discr.py:140-387).

    optimizer_idx 0 (generator): recon·w + LPIPS·w + disc_factor·gate·(−E[D(recons)] + R1);
    optimizer_idx 1 (discriminator): disc_factor·disc_weight·gate·d_loss(D(inputs), D(recons)).
    gate is 1 from ``global_step >= disc_start`` on, else 0; ``disc_start <= 0``
    never starts the discriminator. The LPIPS trunk and heads are frozen;
    only ``discr`` trains (in the discriminator step).
    """

    def __init__(self, recon_type: str = "l1", recon_weight: float = 1.0, perceptual_weight: float = 1.0,
                 lpips_type: str = "alex", disc_start: int = -1, disc_factor: float = 1.0,
                 disc_weight: float = 1.0, disc_lambda_r1: float = 0.0, disc_loss: str = "hinge",
                 disc_input_nc: int = 3, disc_n_layers: int = 3, disc_ndf: int = 64,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator(device).manual_seed(0)
        self.recon_type, self.recon_weight, self.perceptual_weight = recon_type, recon_weight, perceptual_weight
        self.disc_start, self.disc_factor, self.disc_weight = disc_start, disc_factor, disc_weight
        self.disc_lambda_r1 = disc_lambda_r1
        self.d_fn = get_discr_loss_fn(disc_loss)
        self.discr = NLayerDiscriminator(disc_input_nc, disc_ndf, disc_n_layers, device=device, generator=g)
        if perceptual_weight > 0:
            self.perceptual_loss = LPIPS(lpips_type, device=device, generator=g).requires_grad_(False)

    def gate(self, global_step: int) -> float:
        start = self.disc_start if self.disc_start > 0 else 2**31 - 1
        return 1.0 if global_step >= start else 0.0

    def forward(self, inputs: torch.Tensor, recons: torch.Tensor, global_step: int, optimizer_idx: int = 0):
        inputs = inputs.float().clamp(-1.0, 1.0)
        recons = recons.float().clamp(-1.0, 1.0)
        gate = self.gate(global_step)
        if optimizer_idx == 0:
            rec = _recon(inputs, recons, self.recon_type)
            if self.perceptual_weight > 0:
                p = F.relu(self.perceptual_loss(inputs, recons)).reshape(-1)
                p_rec = rec * self.recon_weight + p * self.perceptual_weight
            else:
                p = torch.zeros_like(rec)
                p_rec = rec * self.recon_weight
            r1 = self.r1_penalty(inputs) if self.disc_lambda_r1 > 0 else torch.zeros((), device=rec.device)
            logits_fake = self.discr(recons, True)
            g_loss = (-logits_fake.mean() + r1) * gate
            loss = p_rec + g_loss * self.disc_factor
            log = {"train/loss/total": loss.mean(), "train/loss/rec": rec.mean(),
                   "train/loss/p": p.mean(), "train/loss/g": g_loss, "train/loss/r1_penalty": r1}
            return loss, {k: v.detach() for k, v in log.items()}
        if optimizer_idx == 1:
            logits_real = self.discr(inputs.detach(), True)
            logits_fake = self.discr(recons.detach(), True)
            d_loss = self.disc_factor * self.disc_weight * self.d_fn(logits_real, logits_fake) * gate
            log = {"train/loss/disc": d_loss, "train/logits/real": logits_real.mean(),
                   "train/logits/fake": logits_fake.mean()}
            return d_loss, {k: v.detach() for k, v in log.items()}
        raise ValueError(f"Unknown optimizer_idx {optimizer_idx}")

    def r1_penalty(self, inputs: torch.Tensor) -> torch.Tensor:
        """λ·E_b[Σ (∂ mean D(x) / ∂x)²] on the real inputs (vae_lpips_discr.py:303-308),
        detached: it contributes no generator grads."""
        x = inputs.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = self.discr(x, True)
            (grad,) = torch.autograd.grad(logits.mean(), x)
        dims = tuple(range(1, x.ndim))
        return (grad.square().sum(dim=dims).mean() * self.disc_lambda_r1).detach()
