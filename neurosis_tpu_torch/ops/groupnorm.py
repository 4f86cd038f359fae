"""Memory-saving GroupNorm (port of neurosis_tpu/ops/groupnorm.py).

The same math as ``modules.layers.GroupNorm32``'s plain path (fp32 statistics
with var = max(0, E[x²] − E[x]²), normalised in fp32, cast back to x's
dtype), as a ``torch.autograd.Function`` that saves only x (bf16 when the
network runs bf16) and the per-(batch, group) fp32 mean and rstd; the
backward recomputes x̂ instead of keeping an fp32 copy of it:

    t      = dy · scale
    dx     = rstd · (t − mean_g(t) − x̂ · mean_g(t · x̂))
    dscale = Σ_{B,H,W} dy · x̂,   dbias = Σ_{B,H,W} dy

This is plain PyTorch on every device, as JAX's is plain jnp: it moves no
work into a kernel of its own.
"""

from __future__ import annotations

import torch


def _stats(x: torch.Tensor, num_groups: int, eps: float):
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf.square().mean(dim=(1, 3)) - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def _expand(stat: torch.Tensor, c: int) -> torch.Tensor:
    """(B, G) → (B, 1, 1, C), each group's value repeated C/G times."""
    b, g = stat.shape
    return stat.repeat_interleave(c // g, dim=1).reshape(b, 1, 1, c)


def _xhat(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    c = x.shape[-1]
    return (x.float() - _expand(mean, c)) * _expand(rstd, c)


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float):
        mean, rstd = _stats(x, num_groups, eps)
        out = (_xhat(x, mean, rstd) * scale.float() + bias.float()).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        b, h, w, c = x.shape
        g = mean.shape[1]
        n = h * w * (c // g)
        dyf = dy.float()
        xhat = _xhat(x, mean, rstd)
        dbias = dyf.sum(dim=(0, 1, 2))
        dscale = (dyf * xhat).sum(dim=(0, 1, 2))
        t = dyf * scale.float()
        tg = t.reshape(b, h * w, g, c // g)
        sum_t = tg.sum(dim=(1, 3))
        sum_txhat = (tg * xhat.reshape(b, h * w, g, c // g)).sum(dim=(1, 3))
        dx = _expand(rstd, c) * (t - _expand(sum_t / n, c) - xhat * _expand(sum_txhat / n, c))
        return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype), None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int,
               eps: float) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of NHWC ``x``; fp32 math,
    output in x's dtype; per-channel fp32 ``scale`` and ``bias``."""
    return _GroupNorm.apply(x, scale, bias, num_groups, eps)
