"""DiffusionEngine: the SD training step (port of neurosis_tpu/trainer/engine.py).

``init(seed)`` builds the optimizer over the trainable parameters, the EMA
shadows and the run's generator; ``train_step(state, batch)`` runs
[frozen encode →] conditioner → loss → backward → optimizer → EMA and
updates the module parameters in place. The latents are
``batch['latents']`` (NHWC, already scaled) when the batch has them, else
the frozen first stage encodes ``batch[input_key]`` (uint8 or [-1, 1]
images, NHWC): moments → posterior sample → ·scale_factor, without grad
(models/diffusion.py:187-197). The first stage is an ``AutoencoderKL``, a
separate encoder and decoder (``first_stage_encoder``/``_decoder``), or
none at all for pixel-space diffusion (``identity_first_stage``: the
images themselves, ·scale_factor). In training the run's generator feeds
the conditioner's UCG draws and the UNet's dropout; a per-sample
``batch['loss_scale']`` (a loss hook's) multiplies the loss, and with
``log_sigmas`` the step also reports ``loss_s0``, ``loss_smax`` and
``loss_smin`` (models/diffusion.py:216-232). ``eval_step`` is the loss
alone, without grad, update, UCG or dropout, and under the EMA shadows too
when ``use_ema`` is set.

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
from ..diffusion.denoiser import Denoiser
from ..diffusion.loss import StandardDiffusionLoss
from ..models.autoencoder import AutoencoderKL
from ..models.unet import UNetModel
from ..models.vae import Decoder, Encoder
from ..modules.distributions import DiagonalGaussian
from ..modules.ema import ema_init, ema_swapped_in, ema_update
from ..modules.encoders.embedding import GeneralConditioner
from ..ops.dequant import dequant_image
from ..parallel import rows
from ..parallel.fsdp import resharded
from .state import TrainState, global_norm


class DiffusionEngine:
    def __init__(self, model: UNetModel, denoiser: Denoiser, loss_fn: StandardDiffusionLoss,
                 conditioner: GeneralConditioner,
                 optimizer: Callable[[list], torch.optim.Optimizer],
                 use_ema: bool = False, ema_decay: float = 0.9999, latents_key: str = "latents",
                 trainable_embedders: Sequence[int] = (), first_stage: Optional[AutoencoderKL] = None,
                 scale_factor: float = 0.18215, input_key: str = "image", sampler: Any = None,
                 lr_scales: Optional[dict] = None, device: DeviceLike = None,
                 first_stage_encoder: Optional[Encoder] = None, first_stage_decoder: Optional[Decoder] = None,
                 identity_first_stage: bool = False, log_sigmas: bool = False):
        self.device = resolve_device(device)
        self.first_stage_encoder = first_stage_encoder.requires_grad_(False) if first_stage_encoder else None
        self.first_stage_decoder = first_stage_decoder.requires_grad_(False) if first_stage_decoder else None
        self.identity_first_stage = identity_first_stage
        self.log_sigmas = log_sigmas
        self.loss_hooks: list = []
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
        self.lr_scales = dict(lr_scales or {})  # trainable embedder index -> its base_lr over the engine's
        for i, emb in enumerate(conditioner.embedders):
            emb.requires_grad_(i in set(trainable_embedders))

    def named_trainable_parameters(self) -> list:
        """(name, parameter): the UNet's as ``model.*``, then the trainable
        embedders' as ``conditioner.*`` (JAX's ``state.params``)."""
        return [("model." + n, p) for n, p in self.model.named_parameters()] + \
            [("conditioner." + n, p) for n, p in self.conditioner.named_parameters() if p.requires_grad]

    def trainable_parameters(self) -> list:
        """UNet parameters, then those of the trainable embedders."""
        return [p for _, p in self.named_trainable_parameters()]

    def param_groups(self) -> list:
        """The optimizer's param groups: everything at the optimizer's lr, and
        one group (with its ``lr_scale``) per embedder that has its own base_lr."""
        embedders = self.conditioner.embedders
        scaled = [{"params": [p for p in embedders[i].parameters() if p.requires_grad], "lr_scale": s}
                  for i, s in sorted(self.lr_scales.items())]
        default = list(self.model.parameters()) + [p for i, emb in enumerate(embedders) if i not in self.lr_scales
                                                   for p in emb.parameters() if p.requires_grad]
        return [{"params": default}] + [g for g in scaled if g["params"]]

    def init(self, seed: int = 0) -> TrainState:
        generator = torch.Generator(self.device).manual_seed(seed)
        ema = ema_init(self.trainable_parameters()) if self.use_ema else None
        return TrainState(step=0, optimizer=self.optimizer(self.param_groups()), ema=ema, generator=generator)

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
        if self.identity_first_stage:
            return z / self.scale_factor
        if self.first_stage is not None:
            return self.first_stage.decode(z / self.scale_factor)
        if self.first_stage_decoder is not None:
            return self.first_stage_decoder(z / self.scale_factor)
        raise ValueError("no first stage to decode with")

    def network_apply(self, x: torch.Tensor, c_noise: torch.Tensor, cond: dict,
                      generator: Optional[torch.Generator] = None, **extra) -> torch.Tensor:
        """The UNet on (x, c_noise) with the conditioning; the loss's
        ``input_keys`` arrive as ``extra`` (a ``y`` among them takes the place
        of ``cond['vector']``, so class labels can reach a class-count UNet);
        dropout draws from ``generator``."""
        kwargs = {"y": cond.get("vector"), **extra}
        return self.model(x, c_noise, cond.get("crossattn"), generator=generator, **kwargs)

    def loss(self, batch: dict, latents: torch.Tensor, generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             offset: Optional[torch.Tensor] = None, ucg: Optional[Sequence[torch.Tensor]] = None):
        """(batch-mean loss, metrics) (models/diffusion.py:199-233 forward
        path): the conditioner's UCG and the UNet's dropout draw from
        ``generator`` (none: neither applies); ``t``, ``noise``, ``offset``
        and ``ucg`` stand in for the draws."""
        cond = self.conditioner(batch, generator=generator, ucg=ucg)

        def network_apply(x, c_noise, c, **extra):
            return self.network_apply(x, c_noise, c, generator, **extra)

        per_sample = self.loss_fn(network_apply, self.denoiser, cond, latents, generator, t=t, noise=noise,
                                  batch=batch, offset=offset)
        if "loss_scale" in batch:  # per-sample multipliers from loss hooks
            per_sample = per_sample * batch["loss_scale"].to(per_sample.dtype)
        loss = per_sample.mean()
        metrics = {"loss": loss.detach()}
        if self.log_sigmas:
            d = rows.gather(per_sample.detach())
            metrics.update(loss_s0=d[0], loss_smax=d.max(), loss_smin=d.min())
        return loss, metrics

    def train_step(self, state: TrainState, batch: dict, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None, posterior_noise: Optional[torch.Tensor] = None,
                   offset: Optional[torch.Tensor] = None, ucg: Optional[Sequence[torch.Tensor]] = None):
        """One optimization step; returns (state, {'loss', 'grad_norm'[, the
        log_sigmas metrics]}) with the metrics as 0-d device tensors. ``t``,
        ``noise``, ``posterior_noise``, ``offset`` and ``ucg`` override the
        generator's draws (tests hold the port against JAX with them)."""
        if self.latents_key in batch:
            latents = batch[self.latents_key]
        else:
            latents = self.encode_first_stage(batch[self.input_key], state.generator, posterior_noise)
        params = self.trainable_parameters()
        for p in params:
            p.grad = None
        loss, metrics = self.loss(batch, latents, state.generator, t=t, noise=noise, offset=offset, ucg=ucg)
        loss.backward()
        grad_norm = global_norm([p.grad for p in params if p.grad is not None])  # JAX: an unused one's is 0
        state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, params, self.ema_decay)
        state.step += 1
        return state, dict(metrics, grad_norm=grad_norm)

    @contextlib.contextmanager
    def ema_scope(self, state: TrainState):
        """The trainable parameters hold the EMA shadows inside the block
        (models/diffusion.py:247-257); wrapped ones sharded around the swap."""
        with resharded(self), ema_swapped_in(state.ema, self.trainable_parameters()):
            yield

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
        """The loss for ``validate``: no grad, no update, no UCG, no dropout.
        With ``use_ema`` the same draws of t, noise and offset also give the
        ``*_ema`` metrics under the shadows."""
        if self.latents_key in batch:
            latents = batch[self.latents_key]
        else:
            latents = self.encode_first_stage(batch[self.input_key], state.generator)
        t = rows.draw(torch.rand, latents.shape[:1], generator=state.generator, device=latents.device)
        noise = rows.draw(torch.randn, latents.shape, generator=state.generator, device=latents.device,
                          dtype=latents.dtype)
        offset = self.loss_fn.draw_offset(latents, state.generator)
        _, metrics = self.loss(batch, latents, t=t, noise=noise, offset=offset)
        if self.use_ema and state.ema is not None:
            with self.ema_scope(state):
                _, ema_metrics = self.loss(batch, latents, t=t, noise=noise, offset=offset)
            metrics.update({f"{k}_ema": v for k, v in ema_metrics.items()})
        return state, metrics
