"""8-bit AdamW: blockwise-quantized moments (port of
neurosis_tpu/optimizers/adamw8bit.py; the reference's configs name it
``bitsandbytes.optim.AdamW8bit``).

The state layout and codebooks are the JAX package's, not bitsandbytes':
each moment of a leaf is kept as 8-bit codes in blocks of ``block_size``
(256) with one fp32 absmax scale per block, on an analytic log-spaced
codebook (x normalised by the block's absmax, so |x| ≤ 1):

  - signed (m):   code k ∈ [-127, 127], |x| ≈ 10**(7·(|k|-1)/126 - 7), 0 exact;
  - unsigned (v): code k ∈ [0, 255],    x ≈ 10**(10·(k-1)/254 - 10), 0 exact.

The blocks run over a leaf in the JAX package's layout (a parameter's
``jax_layout``, set by the port's Dense and Conv2d: JAX's kernels are (in,
out) and HWIO), so every block holds the elements JAX's does and takes its
scale. Leaves under ``min_8bit_size`` (4096) elements keep fp32 moments. The update
is optax's chain ``scale_by_adam_8bit`` → ``add_decayed_weights`` →
``scale_by_learning_rate``: bias correction by the count of updates,
m̂/(√v̂ + eps), plus weight_decay·p, times −lr. It runs leaf by leaf in
plain torch, as the JAX version is jnp: no kernel of its own.

A parameter that FSDP2 shards (a DTensor) keeps its state whole
(``full_layout``): a shard's own flatten would cut other blocks than the
whole leaf's, and the codes would differ. Its step gathers the gradient and
the parameter, updates the whole leaf as on one card, and keeps its part.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.fsdp import assign, full

SIGNED_DECADES = 7.0
UNSIGNED_DECADES = 10.0
# exp2 factors as the JAX package forms them: float32(decades · float32(log2 10))
_LOG2_10 = np.float32(np.log2(np.float32(10.0)))
_SIGNED_EXP = float(np.float32(np.float32(SIGNED_DECADES) * _LOG2_10))
_UNSIGNED_EXP = float(np.float32(np.float32(UNSIGNED_DECADES) * _LOG2_10))


def _blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.view(-1, block_size)


def _log_code(n: torch.Tensor, decades: float, top: float) -> torch.Tensor:
    """clip(round((log10(max(n, 1e-38)) + decades)·(top - 1)/decades) + 1, 0, top),
    0 where n < 10**-decades."""
    k = n.clamp_min(1e-38).log10_().add_(decades).mul_(top - 1.0).div_(decades).round_().add_(1.0).clamp_(0.0, top)
    return k.masked_fill_(n < 10.0 ** (-decades), 0.0)


def quantize_signed(x: torch.Tensor, block_size: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x → (int8 codes (nblocks, block_size), fp32 absmax scales (nblocks, 1))."""
    blocks = _blocks(x, block_size)
    a = blocks.abs()
    scale = a.amax(dim=1, keepdim=True)
    mag = _log_code(a / scale.clamp_min(1e-30), SIGNED_DECADES, 127.0)
    return blocks.sign().mul_(mag).to(torch.int8), scale


def dequantize_signed(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    k = codes.float()
    mag = k.abs().sub_(1.0).div_(126.0).sub_(1.0).mul_(_SIGNED_EXP).exp2_().masked_fill_(k == 0.0, 0.0)
    return k.sign_().mul_(mag).mul_(scale).view(-1)[: int(np.prod(shape))].view(shape)


def quantize_unsigned(x: torch.Tensor, block_size: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x ≥ 0 → (uint8 codes (nblocks, block_size), fp32 max scales (nblocks, 1))."""
    blocks = _blocks(x, block_size)
    scale = blocks.amax(dim=1, keepdim=True)
    return _log_code(blocks / scale.clamp_min(1e-30), UNSIGNED_DECADES, 255.0).to(torch.uint8), scale


def dequantize_unsigned(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    k = codes.float()
    mag = (k - 1.0).div_(254.0).sub_(1.0).mul_(_UNSIGNED_EXP).exp2_().masked_fill_(k == 0.0, 0.0)
    return mag.mul_(scale).view(-1)[: int(np.prod(shape))].view(shape)


class AdamW8bit(torch.optim.Optimizer):
    """optax-style AdamW with 8-bit blockwise moments (the JAX package's
    ``adamw8bit``; its argument names, ``learning_rate`` as the configs' ``lr``).

    ``count`` (the updates made) is part of ``state_dict()``, so a resumed
    run keeps its bias correction."""

    full_layout = True  # the state of a sharded parameter is the whole leaf's

    def __init__(self, params, learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, block_size: int = 256, min_8bit_size: int = 4096):
        defaults = dict(lr=learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.block_size = block_size
        self.min_8bit_size = min_8bit_size
        self.count = 0

    def state_dict(self) -> dict:
        return dict(super().state_dict(), count=self.count)

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's, but each state tensor keeps its dtype (torch would cast the
        8-bit codes to the parameter's fp32) and only moves to its parameter's
        device."""
        super().load_state_dict(dict(state_dict, state={}))
        params = [p for group in self.param_groups for p in group["params"]]
        for index, state in state_dict["state"].items():
            p = params[int(index)]
            self.state[p] = {k: v.to(device=p.device) for k, v in state.items()}
        self.count = int(state_dict["count"])

    def _init_state(self, p: torch.Tensor, state: dict) -> None:
        if p.numel() >= self.min_8bit_size:
            nb = -(-p.numel() // self.block_size)
            state["mu_codes"] = torch.zeros((nb, self.block_size), dtype=torch.int8, device=p.device)
            state["nu_codes"] = torch.zeros((nb, self.block_size), dtype=torch.uint8, device=p.device)
            state["mu_scale"] = torch.zeros((nb, 1), dtype=torch.float32, device=p.device)
            state["nu_scale"] = torch.zeros((nb, 1), dtype=torch.float32, device=p.device)
        else:
            state["mu"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            state["nu"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    @torch.no_grad()
    def step(self, closure=None):
        count = self.count + 1
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
            c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    self._init_state(p, state)
                g = full(p.grad).float()
                whole = full(p)  # p itself unless FSDP2 shards it
                quantized = "mu_codes" in state
                perm = getattr(p, "jax_layout", None)
                if quantized:
                    shape = p.shape if perm is None else tuple(p.shape[a] for a in perm)
                    mu = dequantize_signed(state["mu_codes"], state["mu_scale"], shape)
                    nu = dequantize_unsigned(state["nu_codes"], state["nu_scale"], shape)
                    if perm is not None:  # views in the parameter's layout; the blocks stay in JAX's
                        inverse = tuple(int(a) for a in np.argsort(perm))
                        mu, nu = mu.permute(inverse), nu.permute(inverse)
                else:
                    mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_(g * (1.0 - b1))
                nu.mul_(b2).add_(g.square().mul_(1.0 - b2))
                update = (mu / c1).div_((nu / c2).sqrt_().add_(group["eps"]))
                if group["weight_decay"]:
                    update.add_(whole.float() * group["weight_decay"])
                whole.add_(update.mul_(-group["lr"]).to(p.dtype))
                if whole is not p:
                    assign(p, whole)
                if quantized:
                    if perm is not None:
                        mu, nu = mu.permute(perm), nu.permute(perm)
                    state["mu_codes"], state["mu_scale"] = quantize_signed(mu, self.block_size)
                    state["nu_codes"], state["nu_scale"] = quantize_unsigned(nu, self.block_size)
        self.count = count
