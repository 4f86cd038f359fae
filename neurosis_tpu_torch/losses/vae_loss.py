"""VAE training losses (port of neurosis_tpu/losses/vae_loss.py).

``forward(inputs, recons, ...)`` returns (loss, log): a per-sample (B,)
loss for the generator, a scalar for the discriminator, and a dict of 0-d
tensors under the reference's ``train/`` log names. Only the training
forward is ported (the discriminator in train mode, the gate on
``global_step``); the eval split waits for ``eval_step``.
``AutoencoderLPIPSWithDiscr.log_images`` draws the discriminator's patch
logits for the image logger.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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

    @torch.no_grad()
    def log_images(self, inputs: torch.Tensor, recons: torch.Tensor) -> dict:
        """Discriminator-logit grids (vae_lpips_discr.py:202-309):
        {"vis_logits", "vis_logits_blended"}, (1, H, W, 3) numpy arrays in
        [-1, 1]: the real and fake patch logits (real row on top) in a
        diverging colour map, and the same over the images, each above a
        labelled colour bar. Empty while the discriminator is off."""
        from ..utils.image import diverging_colormap, make_grid_nhwc

        if self.disc_start < 0 or self.disc_factor == 0:
            return {}
        inputs = inputs.float().clamp(-1.0, 1.0)
        recons = recons.float().clamp(-1.0, 1.0)
        lr = self.discr(inputs, False).float().cpu().numpy()  # (b, h', w', 1), running statistics
        if lr.ndim < 4:
            return {}  # not a patch discriminator (vae_lpips_discr.py:214-216)
        lf = self.discr(recons, False).float().cpu().numpy()
        high = max(float(np.abs(lr).max()), float(np.abs(lf).max()), 1e-8)
        h, w = inputs.shape[1], inputs.shape[2]

        def upsample(lg):  # nearest, to the image size (vae_lpips_discr.py:231-243)
            reps_h, reps_w = (h + lg.shape[1] - 1) // lg.shape[1], (w + lg.shape[2] - 1) // lg.shape[2]
            return np.repeat(np.repeat(lg, reps_h, axis=1), reps_w, axis=2)[:, :h, :w]

        lr, lf = upsample(lr), upsample(lf)
        alpha = 0.8 * np.concatenate([make_grid_nhwc(np.abs(lr) / high, 4), make_grid_nhwc(np.abs(lf) / high, 4)],
                                     axis=0)
        cm_r = diverging_colormap(((lr + high) / (2 * high))[..., 0])
        cm_f = diverging_colormap(((lf + high) / (2 * high))[..., 0])
        grid_logits = np.concatenate([make_grid_nhwc(cm_r, 4), make_grid_nhwc(cm_f, 4)], axis=0)
        grid_images = np.concatenate([make_grid_nhwc(0.5 * inputs.cpu().numpy() + 0.5, 4),
                                      make_grid_nhwc(0.5 * recons.cpu().numpy() + 0.5, 4)], axis=0)
        grid_blend = alpha * grid_logits + (1 - alpha) * grid_images
        cbar = colorbar_strip(grid_logits.shape[1], high)
        return {"vis_logits": (2.0 * np.concatenate([grid_logits, cbar], axis=0) - 1.0)[None],
                "vis_logits_blended": (2.0 * np.concatenate([grid_blend, cbar], axis=0) - 1.0)[None]}

    def r1_penalty(self, inputs: torch.Tensor) -> torch.Tensor:
        """λ·E_b[Σ (∂ mean D(x) / ∂x)²] on the real inputs (vae_lpips_discr.py:303-308),
        detached: it contributes no generator grads."""
        x = inputs.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = self.discr(x, True)
            (grad,) = torch.autograd.grad(logits.mean(), x)
        dims = tuple(range(1, x.ndim))
        return (grad.square().sum(dim=dims).mean() * self.disc_lambda_r1).detach()


def colorbar_strip(width: int, high: float, height: int = 24) -> np.ndarray:
    """A horizontal colour bar, -high at the left and +high at the right, each
    labelled (vae_lpips_discr.py:281-303): float HxWx3 in [0, 1]."""
    from ..utils import font
    from ..utils.image import diverging_colormap

    ramp = diverging_colormap(np.linspace(0.0, 1.0, width))
    strip = (np.broadcast_to(ramp[None], (height, width, 3)) * 255).astype(np.uint8)
    size = max(10, height - 12)
    font.draw_text(strip, (2, 2), f"{-high:.2f}", (0, 0, 0), size)
    label = f"{high:.2f}"
    font.draw_text(strip, (width - font.text_length(label, size) - 2, 2), label, (0, 0, 0), size)
    return strip.astype(np.float32) / 255.0
