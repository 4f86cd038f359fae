"""sgm-style GAN losses of the autoencoder (port of
neurosis_tpu/losses/discriminator_loss.py).

``GeneralLPIPSWithDiscriminator`` weighs the reconstruction (L1 or L2 plus
LPIPS, per pixel) by a scalar ``logvar``: nll = Σ(rec/e^logvar + logvar)/B.
The gradient reaches ``logvar`` only with ``learn_logvar``; neither
optimizer of the engine holds it, as in the JAX package. The generator's
loss adds d_weight·disc_factor·gate·(−E[D(recons)]) and, for each key of
``regularization_weights`` the regularizer logged, its weighted mean. The
discriminator's loss is disc_factor·gate·(hinge or vanilla) of D on the
inputs and on the reconstructions. ``gate`` is 1 from ``disc_start`` on,
and always when ``train`` is False (the eval split, where the BatchNorm
reads its running statistics). ``VQLPIPSWithDiscriminator`` adds
codebook_weight × the regularizer's ``loss/vq``.

d_weight is ``disc_weight``, or the adaptive weight the engine computes with
``adaptive_disc_weight`` from the grads of ``nll_scalar`` and ``g_scalar``
at the decoder's last conv weight.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from .functions import get_discr_loss_fn
from .lpips import LPIPS
from .patchgan import NLayerDiscriminator


class GeneralLPIPSWithDiscriminator(nn.Module):
    def __init__(self, disc_start: int = -1, logvar_init: float = 0.0, disc_num_layers: int = 3,
                 disc_in_channels: int = 3, disc_factor: float = 1.0, disc_weight: float = 1.0,
                 perceptual_weight: float = 1.0, disc_loss: str = "hinge", rec_weight: float = 1.0,
                 rec_loss_type: str = "l1", learn_logvar: bool = False,
                 regularization_weights: Optional[Mapping[str, float]] = None, lpips_type: str = "vgg",
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator(device).manual_seed(0)
        self.disc_start, self.disc_factor, self.disc_weight = disc_start, disc_factor, disc_weight
        self.perceptual_weight, self.rec_weight, self.rec_loss_type = perceptual_weight, rec_weight, rec_loss_type
        self.learn_logvar = learn_logvar
        self.regularization_weights = dict(regularization_weights or {})
        self.disc_loss = disc_loss
        self.d_fn = get_discr_loss_fn(disc_loss)
        self.logvar = nn.Parameter(torch.full((), float(logvar_init), device=device))
        self.discriminator = NLayerDiscriminator(disc_in_channels, n_layers=disc_num_layers, device=device,
                                                 generator=g)
        if perceptual_weight > 0:
            self.perceptual_loss = LPIPS(lpips_type, device=device, generator=g).requires_grad_(False)

    def gate(self, global_step: int, train: bool = True) -> float:
        start = self.disc_start if self.disc_start > 0 else 2**31 - 1
        return 1.0 if (global_step >= start or not train) else 0.0

    def nll_loss(self, inputs: torch.Tensor, recons: torch.Tensor):
        """(Σ nll / B, the per-pixel reconstruction term) (discriminator_loss.py:212+)."""
        diff = inputs.float() - recons.float()
        rec = (diff.square() if self.rec_loss_type in ("l2", "mse") else diff.abs()) * self.rec_weight
        if self.perceptual_weight > 0:
            rec = rec + self.perceptual_weight * self.perceptual_loss(inputs, recons)
        logvar = self.logvar if self.learn_logvar else self.logvar.detach()
        nll = rec / torch.exp(logvar) + logvar
        return nll.sum() / nll.shape[0], rec

    def nll_scalar(self, inputs: torch.Tensor, recons: torch.Tensor) -> torch.Tensor:
        return self.nll_loss(inputs, recons)[0]

    def g_scalar(self, recons: torch.Tensor) -> torch.Tensor:
        """−E[D(recons)] with the BatchNorm on its running statistics (the
        adaptive weight's probe leaves them as they are)."""
        return -self.discriminator(recons, False).mean()

    def forward(self, inputs: torch.Tensor, recons: torch.Tensor, global_step: int, optimizer_idx: int = 0,
                regularization_log: Optional[Mapping[str, torch.Tensor]] = None,
                d_weight: Optional[torch.Tensor] = None, split: str = "train", train: bool = True):
        gate = self.gate(global_step, train)
        if optimizer_idx == 0:
            nll, rec = self.nll_loss(inputs, recons)
            g_loss = -self.discriminator(recons, train).mean()
            if d_weight is None:
                d_weight = torch.tensor(float(self.disc_weight), device=nll.device)
            loss = nll + d_weight * self.disc_factor * gate * g_loss
            log = {f"{split}/loss/nll": nll, f"{split}/loss/rec": rec.mean(), f"{split}/loss/g": g_loss,
                   f"{split}/scalars/d_weight": d_weight.float(), f"{split}/scalars/logvar": self.logvar}
            for key, weight in self.regularization_weights.items():
                if regularization_log and key in regularization_log:
                    term = regularization_log[key].mean()
                    loss = loss + weight * term
                    log[f"{split}/loss/{key}"] = term
            log[f"{split}/loss/total"] = loss
            return loss, {k: v.detach() for k, v in log.items()}
        if optimizer_idx == 1:
            logits_real = self.discriminator(inputs.detach(), train)
            logits_fake = self.discriminator(recons.detach(), train)
            d_loss = self.disc_factor * self.d_fn(logits_real, logits_fake) * gate
            log = {f"{split}/loss/disc": d_loss, f"{split}/logits/real": logits_real.mean(),
                   f"{split}/logits/fake": logits_fake.mean()}
            return d_loss, {k: v.detach() for k, v in log.items()}
        raise ValueError(f"unknown optimizer_idx {optimizer_idx}")


def adaptive_disc_weight(nll_grad_last: torch.Tensor, g_grad_last: torch.Tensor,
                         disc_weight: float = 1.0) -> torch.Tensor:
    """‖∂nll/∂w‖ / (‖∂g/∂w‖ + 1e-4), clipped to [0, 1e4], detached, times
    ``disc_weight`` (discriminator_loss.py:198-210)."""
    d = torch.linalg.vector_norm(nll_grad_last.float()) / (torch.linalg.vector_norm(g_grad_last.float()) + 1e-4)
    return d.clamp(0.0, 1e4).detach() * disc_weight


class VQLPIPSWithDiscriminator(GeneralLPIPSWithDiscriminator):
    """The VQ-GAN loss (vqperceptual.py:16): the sgm GAN loss, plus
    codebook_weight × the mean ``loss/vq`` of the regularizer's log, and its
    ``perplexity`` logged."""

    def __init__(self, *args, codebook_weight: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.codebook_weight = codebook_weight

    def forward(self, inputs, recons, global_step, optimizer_idx=0, regularization_log=None, d_weight=None,
                split="train", train=True):
        loss, log = super().forward(inputs, recons, global_step, optimizer_idx=optimizer_idx,
                                    regularization_log=None, d_weight=d_weight, split=split, train=train)
        if optimizer_idx == 0 and regularization_log:
            if "loss/vq" in regularization_log:
                q = regularization_log["loss/vq"].mean()
                loss = loss + self.codebook_weight * q
                log[f"{split}/loss/vq"] = q.detach()
                log[f"{split}/loss/total"] = loss.detach()
            if "perplexity" in regularization_log:
                log[f"{split}/scalars/perplexity"] = regularization_log["perplexity"].detach()
        return loss, log
