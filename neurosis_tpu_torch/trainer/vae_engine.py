"""AutoencodingEngine: VAE-GAN training (port of neurosis_tpu/trainer/vae_engine.py).

Two steps over disjoint trainable sets, alternated by
``train_step_schedule`` once the discriminator has started:

  - ``g_step``: grads of the generator's loss for the encoder and decoder
    (less a frozen one) and a regularizer module's parameters (a VQ
    codebook);
  - ``d_step``: grads of the hinge/vanilla loss on D(x) and D(recons) for
    the discriminator; the reconstruction runs without grad.

The bottleneck is the diagonal-Gaussian posterior (KL, sampled from the
state's generator or from an explicit ``posterior_noise``), or the
configured ``regularizer``: a plain one (identity, KL) or a module of the
VQ family. A loss that takes ``regularization_log`` (the sgm GAN losses)
gets the regularizer's log; otherwise the regularizer's ``loss_key`` term
is added to the generator's loss, as JAX's ``g_step`` does.
``EMAVectorQuantizer``'s codebook is ``VAETrainState.reg_stats``, updated in
the generator step only. With ``adaptive_disc_weight`` (and a loss that has
``nll_scalar``) the GAN term's weight is ‖∂nll/∂w‖/(‖∂g/∂w‖ + 1e-4) at the
decoder's last conv weight w, both grads taken on the step's own graph.

The discriminator's BatchNorm runs in train mode in both steps and updates
its running statistics in place. Dropout draws from the state's generator
in the generator step only (JAX's engine runs its networks deterministic
in every step). With ``use_ema``
the generator step also updates EMA shadows (decay ``ema_decay``) of the
generator's parameters; ``eval_step`` reports the loss with the live
weights and again under the shadows (``*_ema``).
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Optional

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..losses.discriminator_loss import adaptive_disc_weight
from ..modules.distributions import DiagonalGaussian
from ..modules.ema import ema_init, ema_swapped_in, ema_update
from ..ops.dequant import dequant_image
from ..parallel import rows
from ..parallel.fsdp import resharded
from .state import VAETrainState


def _zero_grads(params) -> None:
    for p in params:
        p.grad = None


def _settle_actnorm(module: Optional[nn.Module]) -> None:
    """A first-batch ActNorm init made in an FSDP2 forward, into its sharded parameters."""
    from ..losses.patchgan import ActNorm

    for m in module.modules() if module is not None else ():
        if isinstance(m, ActNorm):
            m.settle()


def _takes(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def _val_key(k: str) -> str:
    return k.replace("train", "val", 1) if k.startswith("train") else k


class AutoencodingEngine:
    def __init__(self, encoder: nn.Module, decoder: nn.Module, loss: nn.Module,
                 g_optimizer: Callable[[list], torch.optim.Optimizer],
                 d_optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
                 kl_weight: float = 0.0, regularizer=None, sample_posterior: bool = True,
                 input_key: str = "image", use_ema: bool = False, ema_decay: float = 0.9999,
                 disc_start: int = -1, freeze_encoder: bool = False, freeze_decoder: bool = False,
                 adaptive_disc_weight: bool = False, diff_boost_factor: float = 3.0, device: DeviceLike = None):
        if freeze_encoder and freeze_decoder:
            raise ValueError("both encoder and decoder frozen — nothing to train")
        self.device = resolve_device(device)
        self.encoder, self.decoder, self.loss, self.regularizer = encoder, decoder, loss, regularizer
        self.g_optimizer, self.d_optimizer = g_optimizer, d_optimizer
        self.kl_weight = kl_weight
        self.sample_posterior = sample_posterior
        self.input_key = input_key
        self.use_ema, self.ema_decay = use_ema, ema_decay
        self.disc_start = disc_start
        self.freeze_encoder, self.freeze_decoder = freeze_encoder, freeze_decoder
        self.adaptive_disc_weight = adaptive_disc_weight
        self.diff_boost_factor = diff_boost_factor
        encoder.requires_grad_(not freeze_encoder)
        decoder.requires_grad_(not freeze_decoder)

    @property
    def discriminator(self) -> Optional[nn.Module]:
        discr = getattr(self.loss, "discr", None)
        return discr if discr is not None else getattr(self.loss, "discriminator", None)

    @property
    def has_discriminator(self) -> bool:
        return self.discriminator is not None

    @property
    def _reg_is_module(self) -> bool:
        return isinstance(self.regularizer, nn.Module)

    def named_g_parameters(self) -> list:
        """(name, parameter) of what the generator step trains, in the order
        of JAX's ``_g_keys``: the encoder and decoder unless frozen, then a
        regularizer module's."""
        tops = [t for t, frozen in (("encoder", self.freeze_encoder), ("decoder", self.freeze_decoder))
                if not frozen]
        if self._reg_is_module:
            tops.append("regularizer")
        return [(f"{t}.{n}", p) for t in tops for n, p in getattr(self, t).named_parameters()]

    def g_parameters(self) -> list:
        return [p for _, p in self.named_g_parameters()]

    def d_parameters(self) -> list:
        return list(self.discriminator.parameters()) if self.has_discriminator else []

    def init(self, seed: int = 0) -> VAETrainState:
        d_opt = None
        if self.has_discriminator and self.d_optimizer is not None:
            d_opt = self.d_optimizer(self.d_parameters())
        reg_stats = dict(self.regularizer.named_buffers()) if self._reg_is_module else {}
        return VAETrainState(step=0, g_optimizer=self.g_optimizer(self.g_parameters()), d_optimizer=d_opt,
                             generator=torch.Generator(self.device).manual_seed(seed),
                             ema=ema_init(self.g_parameters()) if self.use_ema else None,
                             reg_stats=reg_stats or None)

    def regularize(self, moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                   posterior_noise: Optional[torch.Tensor] = None, train: bool = False):
        """moments → (z, regularization log) through the bottleneck; an EMA
        codebook updates only with ``train``."""
        reg = self.regularizer
        if reg is None:
            dist = DiagonalGaussian.from_moments(moments)
            if self.sample_posterior and (posterior_noise is not None or generator is not None):
                z = dist.sample(generator, eps=posterior_noise)
            else:
                z = dist.mode()
            return z, {"kl_loss": dist.kl()}
        call = reg.forward if self._reg_is_module else reg.__call__
        kwargs = {}
        if generator is not None and _takes(call, "generator"):
            kwargs["generator"] = generator
        if posterior_noise is not None and _takes(call, "eps"):
            kwargs["eps"] = posterior_noise
        if _takes(call, "train"):
            kwargs["train"] = train
        return reg(moments, **kwargs)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                posterior_noise: Optional[torch.Tensor] = None, train: bool = False):
        """encode → regularize → decode; returns (z, recons, regularization
        log). ``train`` draws dropout from ``generator`` and updates an EMA
        codebook."""
        drop = generator if train else None
        z, reg_log = self.regularize(self.encoder(x, drop), generator, posterior_noise, train)
        return z, self.decoder(z, drop), reg_log

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """image → the encoder's output (moments, or z before quantizing)."""
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def _loss_takes_reg(self) -> bool:
        return self.has_discriminator and _takes(self.loss.forward, "regularization_log")

    def _adaptive_weight(self, x: torch.Tensor, recons: torch.Tensor) -> torch.Tensor:
        """The GAN term's weight from the grads of the loss's ``nll_scalar``
        and ``g_scalar`` at the decoder's last conv weight, on this graph."""
        w = self.decoder.conv_out.weight
        (nll_grad,) = torch.autograd.grad(self.loss.nll_scalar(x, recons), w, retain_graph=True)
        (g_grad,) = torch.autograd.grad(self.loss.g_scalar(recons), w, retain_graph=True)
        # the global batch's grads: each rank's is that of its rows' mean
        return adaptive_disc_weight(rows.all_mean(nll_grad), rows.all_mean(g_grad),
                                    getattr(self.loss, "disc_weight", 1.0))

    def g_step(self, state: VAETrainState, batch: dict, posterior_noise: Optional[torch.Tensor] = None):
        """Generator (autoencoder) update, optimizer_idx 0. Returns
        (state, log) with ``log['total']`` the optimized scalar."""
        x = dequant_image(batch[self.input_key])
        params = self.g_parameters()
        _zero_grads(params)
        _zero_grads(self.loss.parameters())
        discr = self.discriminator
        adaptive = self.adaptive_disc_weight and hasattr(self.loss, "nll_scalar")
        last = self.decoder.conv_out.weight if adaptive else None
        frozen_last = last is not None and not last.requires_grad
        if discr is not None:
            discr.requires_grad_(False)  # grads reach recons through D, not D's weights
        if frozen_last:
            last.requires_grad_(True)
        try:
            _, recons, reg_log = self.forward(x, state.generator, posterior_noise, train=True)
            extra = {"d_weight": self._adaptive_weight(x, recons)} if adaptive else {}
            _settle_actnorm(discr)  # the weight's grads reshard a wrapped discriminator
            takes_reg = self._loss_takes_reg()
            if takes_reg:
                extra["regularization_log"] = reg_log
            loss, log = self.loss(x, recons, state.step, optimizer_idx=0, **extra) if self.has_discriminator \
                else self.loss(x, recons)
            total = loss.mean()
            if self.kl_weight > 0 and "kl_loss" in reg_log:
                kl = reg_log["kl_loss"].mean()
                total = total + self.kl_weight * kl
                log = dict(log, **{"train/loss/kl": kl.detach()})
            elif self.regularizer is not None and not takes_reg:
                key = getattr(self.regularizer, "loss_key", None)
                if key and key in reg_log:
                    q = reg_log[key].mean()
                    total = total + q
                    log = dict(log, **{f"train/{key}": q.detach()})
            total.backward()
            _settle_actnorm(discr)
        finally:
            if discr is not None:
                discr.requires_grad_(True)
            if frozen_last:
                last.requires_grad_(False)
                last.grad = None
        state.g_optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, params, self.ema_decay)
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
        _settle_actnorm(self.discriminator)
        state.d_optimizer.step()
        state.step += 1
        return state, dict(log, total=d_loss.detach())

    @contextlib.contextmanager
    def ema_scope(self, state: VAETrainState):
        """The generator's parameters hold the EMA shadows inside the block
        (autoencoder.py:264-277; JAX's ``eval_params``); wrapped ones sharded
        around the swap."""
        if state.ema is None:
            yield
            return
        with resharded(self), ema_swapped_in(state.ema, self.g_parameters()):
            yield

    @torch.no_grad()
    def eval_step(self, state: VAETrainState, batch: dict, posterior_noise: Optional[torch.Tensor] = None):
        """validation_step (autoencoder.py:295-301): the generator's loss
        with the live weights, then under the EMA shadows (``*_ema``), on
        the same posterior draw, the discriminator on its running statistics
        and the GAN gate open; ``train`` log names become ``val``."""
        x = dequant_image(batch[self.input_key])
        drawn_from = state.generator.get_state()

        def metrics() -> dict:
            state.generator.set_state(drawn_from)
            _, recons, reg_log = self.forward(x, state.generator, posterior_noise)
            loss, log = self.loss(x, recons, state.step, optimizer_idx=0, train=False) if self.has_discriminator \
                else self.loss(x, recons)
            total = loss.mean()
            if self.kl_weight > 0 and "kl_loss" in reg_log:
                total = total + self.kl_weight * reg_log["kl_loss"].mean()
            return dict(log, total=total)

        out = {_val_key(k): v for k, v in metrics().items()}
        if self.use_ema and state.ema is not None:
            with self.ema_scope(state):
                out.update({_val_key(k) + "_ema": v for k, v in metrics().items()})
        return state, out

    @torch.no_grad()
    def log_images(self, state: VAETrainState, batch: dict, num_img: int = 4,
                   generator: Optional[torch.Generator] = None,
                   posterior_noise: Optional[torch.Tensor] = None) -> dict:
        """inputs / reconstructions / diff maps (brightened by
        ``diff_boost_factor``), their ``_ema`` variants with ``use_ema``,
        and the loss's discriminator-logit grids (vae_engine.py:412-449,
        autoencoder.py:373-427): numpy NHWC float32 images in [-1, 1]. The
        posterior is sampled with ``posterior_noise`` or from ``generator``,
        the same draw for both sets of weights."""
        x = dequant_image(batch[self.input_key])[:num_img]
        drawn_from = generator.get_state() if generator is not None else None

        def recon_and_diffs(suffix: str = "") -> dict:
            if drawn_from is not None:
                generator.set_state(drawn_from)
            _, recons, _ = self.forward(x, generator, posterior_noise)
            recons = recons.float()
            diff = (0.5 * (recons.clamp(-1.0, 1.0) - x).abs()).clamp(0.0, 1.0)
            boost = (2.0 * (self.diff_boost_factor * diff).clamp(0.0, 1.0) - 1.0)
            return {f"reconstructions{suffix}": recons.cpu().numpy(),
                    f"diff{suffix}": (2.0 * diff - 1.0).cpu().numpy(),
                    f"diff_boost{suffix}": boost.cpu().numpy()}

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
