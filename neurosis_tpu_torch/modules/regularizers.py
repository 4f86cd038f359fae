"""Latent regularizers of the autoencoder (port of
neurosis_tpu/modules/regularizers.py): the KL posterior, the identity and
the VQ family, NHWC. Each returns (z, log).

The quantizers find the nearest code in JAX's form and order,
‖z‖² + ‖e‖² − 2·z·eᵀ in fp32, take the first of tied minima, and pass the
gradient straight through (z + sg(z_q − z)). The modules with parameters
(the codebooks, the Gumbel projection, the input projections) are
``nn.Module``s that train with the generator; ``EMAVectorQuantizer``'s
codebook is buffers (``embedding.weight``, ``embedding.cluster_size``,
``embedding.embed_avg``, the reference's names), updated only when called
with ``train=True``. Randomness (the posterior sample, the Gumbel noise)
comes from a ``torch.Generator`` or is passed in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..parallel import rows
from .distributions import DiagonalGaussian
from .layers import Dense, Embed, init_parameters


def _default_generator(generator: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device).manual_seed(0)


class IdentityRegularizer:
    """modules/regularizers.py IdentityRegularizer."""

    def __call__(self, z: torch.Tensor, generator: Optional[torch.Generator] = None):
        return z, {}


class DiagonalGaussianRegularizer:
    """modules/regularizers.py:23-60: the posterior's sample when ``sample``
    and a draw is given (``generator`` or ``eps``), else its mode; the log
    holds the batch mean of the KL."""

    def __init__(self, sample: bool = True):
        self.sample = sample

    def __call__(self, moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None):
        dist = DiagonalGaussian.from_moments(moments)
        drawn = generator is not None or eps is not None
        z = dist.sample(generator, eps=eps) if self.sample and drawn else dist.mode()
        return z, {"kl_loss": dist.kl().mean()}


def nearest_codes(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the nearest code of each row of ``z`` [N, e_dim]:
    argmin of ‖z‖² + ‖e‖² − 2·z·eᵀ, in fp32."""
    z = z.float()
    e = codebook.float()
    d = z.square().sum(dim=1, keepdim=True) + e.square().sum(dim=1) - 2.0 * (z @ e.T)
    return d.argmin(dim=1)


class VectorQuantizer(nn.Module):
    """VQ-VAE bottleneck (quantize.py:162-290): nearest code, the loss
    β·‖z − sg(z_q)‖² + ‖sg(z) − z_q‖² (means), straight-through."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, log_perplexity: bool = False,
                 loss_key: str = "loss/vq", device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.log_perplexity, self.loss_key = log_perplexity, loss_key
        self.embedding = Embed(n_e, e_dim, device=device)
        with torch.no_grad():
            self.embedding.weight.uniform_(-1.0 / n_e, 1.0 / n_e, generator=_default_generator(generator, device))

    def get_codebook_entry(self, indices: torch.Tensor, shape=None) -> torch.Tensor:
        """indices → codebook vectors [..., e_dim] (quantize.py:292-318)."""
        h = self.embedding.weight[indices]
        return h.reshape(shape) if shape is not None else h

    def forward(self, z: torch.Tensor):
        emb = self.embedding.weight
        shape = z.shape
        idx = nearest_codes(z.reshape(-1, self.e_dim), emb)
        z_q = emb[idx].reshape(shape)
        loss = self.beta * (z_q.detach() - z).square().mean() + (z_q - z.detach()).square().mean()
        z_q = z + (z_q - z).detach()
        log = {self.loss_key: loss}
        if self.log_perplexity:
            probs = rows.all_mean(F.one_hot(idx, self.n_e).float().mean(dim=0))
            log["perplexity"] = torch.exp(-(probs * torch.log(probs + 1e-10)).sum())
        log["indices"] = idx.reshape(shape[:-1])
        log["min_encoding_indices"] = log["indices"]  # the reference's key (quantize.py:282)
        return z_q, log


class GumbelQuantizer(nn.Module):
    """Gumbel-softmax VQ (quantize.py:59-160): with a draw (``generator``,
    or the noise itself as ``gumbel``) the soft assignment of
    softmax((logits + g)/temp), made hard straight-through; without one, or
    ``deterministic``, the argmax of the logits. The loss is kl_weight × the
    KL of softmax(logits) to the uniform."""

    def __init__(self, n_e: int, e_dim: int, num_hiddens: int, straight_through: bool = True,
                 kl_weight: float = 5e-4, temp_init: float = 1.0, loss_key: str = "loss/vq",
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_e, self.straight_through, self.kl_weight = n_e, straight_through, kl_weight
        self.temp_init, self.loss_key = temp_init, loss_key
        self.embed = Embed(n_e, e_dim, device=device)
        self.proj = Dense(num_hiddens, n_e, device=device)
        g = _default_generator(generator, device)
        init_parameters(self, g)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0, generator=g)

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None, temp: Optional[float] = None,
                deterministic: bool = False, gumbel: Optional[torch.Tensor] = None):
        temp = temp or self.temp_init
        logits = self.proj(z)
        if deterministic or (generator is None and gumbel is None):
            soft = torch.softmax(logits / temp, dim=-1)
            idx = logits.argmax(dim=-1)
            assign = F.one_hot(idx, self.n_e).to(logits.dtype) if self.straight_through else soft
        else:
            if gumbel is None:
                u = rows.draw(torch.rand, logits.shape, generator=generator, device=logits.device)
                gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
            soft = torch.softmax((logits + gumbel) / temp, dim=-1)
            idx = soft.argmax(dim=-1)
            if self.straight_through:
                assign = F.one_hot(idx, self.n_e).to(soft.dtype) + soft - soft.detach()
            else:
                assign = soft
        z_q = assign @ self.embed.weight
        probs = torch.softmax(logits, dim=-1)
        kl = self.kl_weight * (probs * torch.log(probs * self.n_e + 1e-10)).sum(dim=-1).mean()
        return z_q, {self.loss_key: kl, "indices": idx}


class _EmbeddingEMA(nn.Module):
    def __init__(self, n_e: int, e_dim: int, device):
        super().__init__()
        self.register_buffer("weight", torch.zeros(n_e, e_dim, device=device))
        self.register_buffer("cluster_size", torch.zeros(n_e, device=device))
        self.register_buffer("embed_avg", torch.zeros(n_e, e_dim, device=device))


class EMAVectorQuantizer(nn.Module):
    """EMA-codebook VQ (quantize.py:321-410): the codebook follows the EMA of
    the latents assigned to each code instead of gradients. It starts at
    zeros, as JAX's ``ema_stats`` do."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25, decay: float = 0.99, eps: float = 1e-5,
                 loss_key: str = "loss/vq", device: DeviceLike = None):
        super().__init__()
        self.n_e, self.e_dim, self.beta, self.decay, self.eps = n_e, e_dim, beta, decay, eps
        self.loss_key = loss_key
        self.embedding = _EmbeddingEMA(n_e, e_dim, resolve_device(device))

    def forward(self, z: torch.Tensor, train: bool = False):
        stats = self.embedding
        shape = z.shape
        zf = z.reshape(-1, self.e_dim)
        idx = nearest_codes(zf, stats.weight)
        z_q = stats.weight[idx].reshape(shape)
        if train:
            with torch.no_grad():
                onehot = F.one_hot(idx, self.n_e).float()
                counts, sums = rows.all_sum(onehot.sum(dim=0)), rows.all_sum(onehot.T @ zf.float())
                stats.cluster_size.copy_(self.decay * stats.cluster_size + (1 - self.decay) * counts)
                stats.embed_avg.copy_(self.decay * stats.embed_avg + (1 - self.decay) * sums)
                total = stats.cluster_size.sum()
                cs = (stats.cluster_size + self.eps) / (total + self.n_e * self.eps) * total
                stats.weight.copy_(stats.embed_avg / cs[:, None])
        loss = self.beta * (z_q.detach() - z).square().mean()
        z_q = z + (z_q - z).detach()
        return z_q, {self.loss_key: loss, "indices": idx.reshape(shape[:-1])}


class VectorQuantizerWithInputProjection(nn.Module):
    """VQ between in and out projections (quantize.py:412-461): a 4-D input
    [B, H, W, C] is quantized as [B, H·W, C] tokens, and given back as
    [B, H, W, output_dim] when ``output_dim`` is set."""

    def __init__(self, input_dim: int, n_codes: int, codebook_dim: int, beta: float = 1.0,
                 output_dim: Optional[int] = None, log_perplexity: bool = False, loss_key: str = "loss/vq",
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = _default_generator(generator, device)
        self.output_dim = output_dim
        self.proj_in = Dense(input_dim, codebook_dim, device=device)
        init_parameters(self.proj_in, g)
        self.quantizer = VectorQuantizer(n_codes, codebook_dim, beta, log_perplexity, loss_key, device=device,
                                         generator=g)
        if output_dim is not None:
            self.proj_out = Dense(codebook_dim, output_dim, device=device)
            init_parameters(self.proj_out, g)

    def get_codebook_entry(self, indices: torch.Tensor, shape=None) -> torch.Tensor:
        return self.quantizer.get_codebook_entry(indices, shape)

    def forward(self, z: torch.Tensor):
        in_shape = z.shape
        rearr = False
        if z.ndim > 3:
            rearr = self.output_dim is not None
            z = z.reshape(in_shape[0], -1, in_shape[-1])
        z_q, log = self.quantizer(self.proj_in(z))
        if self.output_dim is not None:
            z_q = self.proj_out(z_q)
        if rearr:
            z_q = z_q.reshape(in_shape[:-1] + (z_q.shape[-1],))
        return z_q, log
