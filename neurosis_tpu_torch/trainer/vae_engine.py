"""AutoencodingEngine: VAE-GAN training (port of neurosis_tpu/trainer/vae_engine.py).

Two steps over disjoint trainable sets, alternated by
``train_step_schedule`` once the discriminator has started:

  - ``g_step``: grads of recon + LPIPS (+ the GAN term, + kl_weight·KL) for
    the encoder and decoder;
  - ``d_step``: grads of the hinge/vanilla loss on D(x) and D(recons) for
    the discriminator; the reconstruction runs without grad.

The latent is a ``DiagonalGaussian`` posterior (KL regularization), sampled
from the state's generator or from an explicit ``posterior_noise``. The
discriminator's BatchNorm runs in train mode in both steps and updates its
running statistics in place, as the JAX steps thread ``batch_stats``. With
``use_ema`` the generator step also updates EMA shadows of the encoder and
decoder, which ``log_images`` shows beside the live weights.

Not ported yet: VQ regularizers, the adaptive d_weight and ``eval_step``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..modules.distributions import DiagonalGaussian
from ..modules.ema import ema_init, ema_swapped_in, ema_update
from ..ops.dequant import dequant_image
from .state import VAETrainState

DIFF_BOOST = 3.0  # log_images' diff_boost brightens small errors by this factor (autoencoder.py:160)


def _zero_grads(params) -> None:
    for p in params:
        p.grad = None


class AutoencodingEngine:
    def __init__(self, encoder: nn.Module, decoder: nn.Module, loss: nn.Module,
                 g_optimizer: Callable[[list], torch.optim.Optimizer],
                 d_optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
                 kl_weight: float = 0.0, sample_posterior: bool = True,
                 input_key: str = "image", disc_start: int = -1, use_ema: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.encoder, self.decoder, self.loss = encoder, decoder, loss
        self.g_optimizer, self.d_optimizer = g_optimizer, d_optimizer
        self.kl_weight = kl_weight
        self.sample_posterior = sample_posterior
        self.input_key = input_key
        self.disc_start = disc_start
        self.use_ema = use_ema

    @property
    def has_discriminator(self) -> bool:
        return hasattr(self.loss, "discr")

    def g_parameters(self) -> list:
        return list(self.encoder.parameters()) + list(self.decoder.parameters())

    def d_parameters(self) -> list:
        return list(self.loss.discr.parameters()) if self.has_discriminator else []

    def init(self, seed: int = 0) -> VAETrainState:
        d_opt = None
        if self.has_discriminator and self.d_optimizer is not None:
            d_opt = self.d_optimizer(self.d_parameters())
        return VAETrainState(step=0, g_optimizer=self.g_optimizer(self.g_parameters()), d_optimizer=d_opt,
                             generator=torch.Generator(self.device).manual_seed(seed),
                             ema=ema_init(self.g_parameters()) if self.use_ema else None)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                posterior_noise: Optional[torch.Tensor] = None):
        """encode → posterior sample (or mode) → decode; returns
        (z, recons, {'kl_loss': (B,) KL})."""
        dist = DiagonalGaussian.from_moments(self.encoder(x))
        if self.sample_posterior and (posterior_noise is not None or generator is not None):
            z = dist.sample(generator, eps=posterior_noise)
        else:
            z = dist.mode()
        return z, self.decoder(z), {"kl_loss": dist.kl()}

    def g_step(self, state: VAETrainState, batch: dict, posterior_noise: Optional[torch.Tensor] = None):
        """Generator (autoencoder) update, optimizer_idx 0. Returns
        (state, log) with ``log['total']`` the optimized scalar."""
        x = dequant_image(batch[self.input_key])
        params = self.g_parameters()
        _zero_grads(params)
        discr = getattr(self.loss, "discr", None)
        if discr is not None:
            discr.requires_grad_(False)  # grads reach recons through D, not D's weights
        try:
            _, recons, reg_log = self.forward(x, state.generator, posterior_noise)
            loss, log = self.loss(x, recons, state.step, optimizer_idx=0) if self.has_discriminator \
                else self.loss(x, recons)
            total = loss.mean()
            if self.kl_weight > 0:
                kl = reg_log["kl_loss"].mean()
                total = total + self.kl_weight * kl
                log = dict(log, **{"train/loss/kl": kl.detach()})
            total.backward()
        finally:
            if discr is not None:
                discr.requires_grad_(True)
        state.g_optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, params)  # decay 0.9999, the JAX engine's
        state.step += 1
        return state, dict(log, total=total.detach())

    def d_step(self, state: VAETrainState, batch: dict, posterior_noise: Optional[torch.Tensor] = None):
        """Discriminator update, optimizer_idx 1."""
        if not self.has_discriminator:
            raise ValueError("engine has no discriminator")
        x = dequant_image(batch[self.input_key])
        with torch.no_grad():
            _, recons, _ = self.forward(x, state.generator, posterior_noise)
        params = self.d_parameters()
        _zero_grads(params)
        d_loss, log = self.loss(x, recons, state.step, optimizer_idx=1)
        d_loss.backward()
        state.d_optimizer.step()
        state.step += 1
        return state, dict(log, total=d_loss.detach())

    def ema_scope(self, state: VAETrainState):
        """The encoder and decoder hold the EMA shadows inside the block
        (autoencoder.py:264-277)."""
        return ema_swapped_in(state.ema, self.g_parameters())

    @torch.no_grad()
    def log_images(self, state: VAETrainState, batch: dict, num_img: int = 4,
                   generator: Optional[torch.Generator] = None,
                   posterior_noise: Optional[torch.Tensor] = None) -> dict:
        """inputs / reconstructions / diff maps, their ``_ema`` variants with
        ``use_ema``, and the loss's discriminator-logit grids
        (vae_engine.py:412-449, autoencoder.py:373-427): numpy NHWC float32
        images in [-1, 1]. The posterior is sampled with ``posterior_noise``
        or from ``generator``, the same draw for both sets of weights."""
        x = dequant_image(batch[self.input_key])[:num_img]
        drawn_from = generator.get_state() if generator is not None else None

        def recon_and_diffs(suffix: str = "") -> dict:
            if drawn_from is not None:
                generator.set_state(drawn_from)
            _, recons, _ = self.forward(x, generator, posterior_noise)
            recons = recons.float()
            diff = (0.5 * (recons.clamp(-1.0, 1.0) - x).abs()).clamp(0.0, 1.0)
            return {f"reconstructions{suffix}": recons.cpu().numpy(),
                    f"diff{suffix}": (2.0 * diff - 1.0).cpu().numpy(),
                    f"diff_boost{suffix}": (2.0 * (DIFF_BOOST * diff).clamp(0.0, 1.0) - 1.0).cpu().numpy()}

        log = {"inputs": x.float().cpu().numpy()}
        log.update(recon_and_diffs())
        if self.use_ema and state.ema is not None:
            with self.ema_scope(state):
                log.update(recon_and_diffs("_ema"))
        if hasattr(self.loss, "log_images"):
            log.update(self.loss.log_images(x, torch.as_tensor(log["reconstructions"], device=x.device)))
        return log

    def train_step_schedule(self, batch_idx: int, global_step: int) -> int:
        """optimizer_idx (autoencoder.py:280-293): 0 before the discriminator
        starts, then alternating."""
        if not self.has_discriminator or self.disc_start < 0 or global_step < self.disc_start:
            return 0
        return batch_idx % 2
