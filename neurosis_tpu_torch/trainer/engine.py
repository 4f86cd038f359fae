"""DiffusionEngine: the SD training step (port of neurosis_tpu/trainer/engine.py).

``init(seed)`` builds the optimizer over the trainable parameters, the EMA
shadows and the run's generator; ``train_step(state, batch)`` runs
[frozen encode →] conditioner → loss → backward → Adafactor → EMA and
updates the module parameters in place. The latents are
``batch['latents']`` (NHWC, already scaled) when the batch has them, else
the frozen first stage encodes ``batch[input_key]`` (uint8 or [-1, 1]
images, NHWC): moments → posterior sample → ·scale_factor, without grad
(models/diffusion.py:187-197). ``eval_step`` is the loss alone, without
grad or update, and under the EMA shadows too when ``use_ema`` is set.

Sampling (models/diffusion.py:298-445): ``denoiser_fn`` is the
preconditioned UNet as the sampler calls it, ``sample`` draws (or takes)
the initial noise and runs the configured sampler, ``decode_first_stage``
maps latents back to images, and ``log_images`` gives the image logger its
inputs, reconstructions, rendered captions and samples. Callers run them
inside ``eval_scope(state)``: the EMA shadows when the engine keeps them
(JAX's ``eval_params``), the live weights otherwise.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch

from .._device import DeviceLike, resolve_device
from ..diffusion.denoiser import DiscreteDenoiser
from ..diffusion.loss import StandardDiffusionLoss
from ..models.autoencoder import AutoencoderKL
from ..models.unet import UNetModel
from ..modules.distributions import DiagonalGaussian
from ..modules.ema import ema_init, ema_swapped_in, ema_update
from ..modules.encoders.embedding import GeneralConditioner
from ..ops.dequant import dequant_image
from .state import TrainState, global_norm


class DiffusionEngine:
    def __init__(self, model: UNetModel, denoiser: DiscreteDenoiser, loss_fn: StandardDiffusionLoss,
                 conditioner: GeneralConditioner,
                 optimizer: Callable[[list], torch.optim.Optimizer],
                 use_ema: bool = False, ema_decay: float = 0.9999, latents_key: str = "latents",
                 trainable_embedders: Sequence[int] = (), first_stage: Optional[AutoencoderKL] = None,
                 scale_factor: float = 0.18215, input_key: str = "image", sampler: Any = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.sampler = sampler
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

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """scaled latents → images in [-1, 1] (NHWC) by the frozen VAE's decoder."""
        if self.first_stage is None:
            raise ValueError("no first stage to decode with")
        return self.first_stage.decode(z / self.scale_factor)

    def network_apply(self, x: torch.Tensor, c_noise: torch.Tensor, cond: dict) -> torch.Tensor:
        return self.model(x, c_noise, cond.get("crossattn"), y=cond.get("vector"))

    def loss(self, batch: dict, latents: torch.Tensor, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Batch-mean loss (models/diffusion.py:199-233 forward path)."""
        cond = self.conditioner(batch)
        return self.loss_fn(self.network_apply, self.denoiser, cond, latents, generator, t=t, noise=noise).mean()

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

    def ema_scope(self, state: TrainState):
        """The trainable parameters hold the EMA shadows inside the block
        (models/diffusion.py:247-257)."""
        return ema_swapped_in(state.ema, self.trainable_parameters())

    def eval_scope(self, state: TrainState):
        """The weights sampling and plotting use: the EMA shadows when the
        engine keeps them, else the live weights (engine.py:235-243)."""
        if self.use_ema and state.ema is not None:
            return self.ema_scope(state)
        return contextlib.nullcontext()

    def denoiser_fn(self) -> Callable:
        """``denoise(x, sigma, cond)``: the D-output of the preconditioned UNet
        (engine.py:249-258), with the module's current weights."""
        def denoise(x, sigma, cond):
            return self.denoiser(self.network_apply, x, sigma, cond, "D")

        return denoise

    @torch.no_grad()
    def sample(self, cond: dict, uc: Optional[dict], shape: Sequence[int], num_steps: Optional[int] = None,
               generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents of ``shape`` from the configured sampler (engine.py:260-289),
        starting from ``noise`` or from a draw of ``generator``, which also
        feeds the sampler's own draws."""
        if self.sampler is None:
            raise ValueError("no sampler configured")
        if noise is None:
            noise = torch.randn(tuple(shape), generator=generator, device=self.device)
        return self.sampler(self.denoiser_fn(), noise, cond, uc, num_steps=num_steps, generator=generator)

    @torch.no_grad()
    def log_images(self, state: TrainState, batch: dict, num_img: int = 4,
                   generator: Optional[torch.Generator] = None, captions: Optional[Sequence[str]] = None,
                   num_steps: Optional[int] = None, posterior_noise: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> dict:
        """inputs / reconstructions / rendered captions (given ``captions``) /
        samples (with a sampler) (engine.py:291-329, models/diffusion.py:315-420)
        under ``eval_scope(state)``: numpy NHWC float32 images in [-1, 1]. The
        encode's posterior noise and the sampler's initial noise are drawn
        from ``generator`` unless given."""
        x = dequant_image(batch[self.input_key][:num_img])
        n = x.shape[0]
        log = {"inputs": x.float().cpu().numpy()}
        z = self.encode_first_stage(x, generator, posterior_noise)
        log["reconstructions"] = self.decode_first_stage(z).float().cpu().numpy()
        if captions is not None:
            from ..utils.sgm import log_txt_as_img

            log["conditioning"] = log_txt_as_img((x.shape[2], x.shape[1]), list(captions[:n]))
        if self.sampler is not None:
            small = {k: v[:n] if v.ndim >= 1 and v.shape[0] >= n else v for k, v in batch.items()
                     if isinstance(v, torch.Tensor)}
            with self.eval_scope(state):
                c, uc = self.conditioner.get_unconditional_conditioning(small)
                samples = self.sample(c, uc, z.shape, num_steps=num_steps, generator=generator, noise=noise)
            log["samples"] = self.decode_first_stage(samples).float().cpu().numpy()
        return log

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict):
        """The loss for ``validate``: no grad, no update. With ``use_ema`` the
        same draws of t and noise also give ``loss_ema`` under the shadows."""
        if self.latents_key in batch:
            latents = batch[self.latents_key]
        else:
            latents = self.encode_first_stage(batch[self.input_key], state.generator)
        t = torch.rand(latents.shape[0], generator=state.generator, device=latents.device)
        noise = torch.randn(latents.shape, generator=state.generator, device=latents.device, dtype=latents.dtype)
        metrics = {"loss": self.loss(batch, latents, t=t, noise=noise)}
        if self.use_ema and state.ema is not None:
            with self.ema_scope(state):
                metrics["loss_ema"] = self.loss(batch, latents, t=t, noise=noise)
        return state, metrics
