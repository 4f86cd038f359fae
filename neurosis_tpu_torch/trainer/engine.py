"""DiffusionEngine: the SD training step (port of neurosis_tpu/trainer/engine.py).

``init(seed)`` builds the optimizer over the trainable parameters, the EMA
shadows and the run's generator; ``train_step(state, batch)`` runs
[frozen encode →] conditioner → loss → backward → Adafactor → EMA and
updates the module parameters in place. The latents are
``batch['latents']`` (NHWC, already scaled) when the batch has them, else
the frozen first stage encodes ``batch[input_key]`` (uint8 or [-1, 1]
images, NHWC): moments → posterior sample → ·scale_factor, without grad
(models/diffusion.py:187-197).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .._device import DeviceLike, resolve_device
from ..diffusion.denoiser import DiscreteDenoiser
from ..diffusion.loss import StandardDiffusionLoss
from ..models.autoencoder import AutoencoderKL
from ..models.unet import UNetModel
from ..modules.distributions import DiagonalGaussian
from ..modules.ema import ema_init, ema_update
from ..modules.encoders.embedding import GeneralConditioner
from ..ops.dequant import dequant_image
from .state import TrainState, global_norm


class DiffusionEngine:
    def __init__(self, model: UNetModel, denoiser: DiscreteDenoiser, loss_fn: StandardDiffusionLoss,
                 conditioner: GeneralConditioner,
                 optimizer: Callable[[list], torch.optim.Optimizer],
                 use_ema: bool = False, ema_decay: float = 0.9999, latents_key: str = "latents",
                 trainable_embedders: Sequence[int] = (), first_stage: Optional[AutoencoderKL] = None,
                 scale_factor: float = 0.18215, input_key: str = "image", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.denoiser = denoiser
        self.loss_fn = loss_fn
        self.conditioner = conditioner
        self.optimizer = optimizer
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.latents_key = latents_key
        self.first_stage = first_stage.requires_grad_(False) if first_stage is not None else None
        self.scale_factor = scale_factor
        self.input_key = input_key
        for i, emb in enumerate(conditioner.embedders):
            emb.requires_grad_(i in set(trainable_embedders))

    def trainable_parameters(self) -> list:
        """UNet parameters, then those of the trainable embedders."""
        params = list(self.model.parameters())
        params += [p for p in self.conditioner.parameters() if p.requires_grad]
        return params

    def init(self, seed: int = 0) -> TrainState:
        params = self.trainable_parameters()
        generator = torch.Generator(self.device).manual_seed(seed)
        ema = ema_init(params) if self.use_ema else None
        return TrainState(step=0, optimizer=self.optimizer(params), ema=ema, generator=generator)

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                           posterior_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images → scale_factor · a posterior sample of the frozen VAE's
        encode, with noise ``posterior_noise`` or drawn from ``generator``."""
        if self.first_stage is None:
            raise ValueError("no first stage: pass pre-encoded latents")
        moments = self.first_stage.encode(dequant_image(x))
        return self.scale_factor * DiagonalGaussian.from_moments(moments).sample(generator, eps=posterior_noise)

    def loss(self, batch: dict, latents: torch.Tensor, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Batch-mean loss (models/diffusion.py:199-233 forward path)."""
        cond = self.conditioner(batch)

        def network_apply(x, c_noise, c):
            return self.model(x, c_noise, c.get("crossattn"), y=c.get("vector"))

        return self.loss_fn(network_apply, self.denoiser, cond, latents, generator, t=t, noise=noise).mean()

    def train_step(self, state: TrainState, batch: dict, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None, posterior_noise: Optional[torch.Tensor] = None):
        """One optimization step; returns (state, {'loss', 'grad_norm'}) with
        the metrics as 0-d device tensors. ``t``, ``noise`` and
        ``posterior_noise`` override the generator's draws (tests hold the
        port against JAX with them)."""
        if self.latents_key in batch:
            latents = batch[self.latents_key]
        else:
            latents = self.encode_first_stage(batch[self.input_key], state.generator, posterior_noise)
        params = self.trainable_parameters()
        for p in params:
            p.grad = None
        loss = self.loss(batch, latents, state.generator, t=t, noise=noise)
        loss.backward()
        grad_norm = global_norm([p.grad for p in params])
        state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, params, self.ema_decay)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}
