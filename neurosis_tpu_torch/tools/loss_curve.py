"""Statistical loss-curve check of the port (its copy of what it needs from
tools/loss_curve_stat.py).

A reduced-depth SD1.5 UNet (every per-level width of SD1.5: 320/640/1280
channels, heads of d = 40/80/160, a 768-wide context) trains for a few
hundred Adam steps on a fixed data stream, eps-preconditioned with LegacyDDPM
sigmas. Two seeds of the σ/noise draws give the noise band; a curve made by
JAX from the same initial weights passes when its bias-corrected EMA stays
within 1.5 × band of seed 0's after the warmup.

The initial weights are drawn with numpy (``numpy_init_``), not with torch's
generator, so a curve made by JAX and the port's arm on any torch version
start from the same weights: what the port's init leaves at zero stays zero,
norm scales stay one, every other tensor is uniform in ±1/√fan_in, drawn in
``named_parameters`` order.

Usage:
  python -m neurosis_tpu_torch.tools.loss_curve --seed 0 --res 32 --out s0.json
  python -m neurosis_tpu_torch.tools.loss_curve --seed 1 --res 32 --out s1.json
  python -m neurosis_tpu_torch.tools.loss_curve --analyze s0.json s1.json \\
      neurosis_tpu_torch/assets/loss_curve/jax_bf16_r32_seed0.json

At ``res`` 32 level 0's self- and cross-attention (2×8×1024×1024×40 and
2×8×1024×77×40) run the bf16 flash kernels on the card; at 16 nothing
reaches a kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch

CFG = dict(
    in_channels=4,
    model_channels=320,
    out_channels=4,
    num_res_blocks=1,
    attention_resolutions=[4, 2, 1],
    channel_mult=[1, 2, 4],
    num_heads=8,
    transformer_depth=1,
    context_dim=768,
)
BATCH = 2
RES = 32  # the card's resolution; the tool's own is 16
LR = 1e-4
DATA_SEED = 123  # the shared data stream; the seed varies only the σ/noise draws
CONTEXT_LEN = 77
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "loss_curve")
JAX_CURVE = os.path.join(ASSETS, "jax_bf16_r32_seed0.json")


def ddpm_sigmas(num_steps: int = 1000) -> np.ndarray:
    """The LegacyDDPM table as the trainer draws from it (exclude_zero)."""
    from ..diffusion.discretization import LegacyDDPMDiscretization
    from ..diffusion.sigma_generators import DiscreteSigmaGenerator

    gen = DiscreteSigmaGenerator(LegacyDDPMDiscretization(), num_idx=num_steps, device="cpu")
    return np.asarray(gen.sigmas.numpy(), np.float64)


def data_stream(steps: int, res: int = RES, context_dim: int = 768) -> Iterator[tuple]:
    """Deterministic (x0 NCHW, ctx) stream shared by every run."""
    rng = np.random.RandomState(DATA_SEED)
    for _ in range(steps):
        yield (
            rng.randn(BATCH, 4, res, res).astype(np.float32),
            rng.randn(BATCH, CONTEXT_LEN, context_dim).astype(np.float32),
        )


def sigma_noise_stream(steps: int, seed: int, sigmas: np.ndarray, res: int = RES) -> Iterator[tuple]:
    """A run's σ and noise (NCHW) draws: the statistical part."""
    rng = np.random.RandomState(1000 + seed)
    for _ in range(steps):
        idx = rng.randint(0, len(sigmas), size=(BATCH,))
        yield sigmas[idx].astype(np.float32), rng.randn(BATCH, 4, res, res).astype(np.float32)


def _checksum_term(index: int, arr: np.ndarray) -> float:
    a = arr.astype(np.float64).ravel()
    return (index + 1) * float(a.sum()) + float(np.square(a).sum())


@torch.no_grad()
def numpy_init_(model: torch.nn.Module, seed: int = 0) -> float:
    """Redraw ``model``'s parameters with numpy (see the module docstring) and
    return the float64 checksum of the result: Σᵢ (i+1)·Σ pᵢ + Σ pᵢ²."""
    rng = np.random.RandomState(seed)
    total = 0.0
    for i, (_, p) in enumerate(model.named_parameters()):
        if bool((p == 0).all()) or bool((p == 1).all()):
            arr = p.detach().float().cpu().numpy()
        else:
            fan_in = p[0].numel() if p.ndim > 1 else p.numel()
            bound = 1.0 / math.sqrt(fan_in)
            arr = rng.uniform(-bound, bound, size=tuple(p.shape)).astype(np.float32)
            p.copy_(torch.from_numpy(arr))
        total += _checksum_term(i, arr)
    return total


def build_unet(dtype: Optional[torch.dtype], device, cfg: Optional[dict] = None, init_seed: int = 0):
    """The port's ``UNetModel(**cfg)`` computing in ``dtype`` (fp32 weights),
    with the numpy init; returns (model, checksum)."""
    from ..models.unet import UNetModel

    model = UNetModel(**(cfg or CFG), dtype=dtype, device=device)
    model.train()
    return model, numpy_init_(model, init_seed)


def _nhwc(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1))).to(device)


class Arm:
    """The tool's training step on ``model``'s device: eps preconditioning,
    eps weighting, optax.adam(lr, 0.9, 0.999, 1e-8), the UNet's input in
    ``dtype`` (bf16 for the card's arm, None for fp32)."""

    def __init__(self, model: torch.nn.Module, dtype: Optional[torch.dtype] = None, lr: float = LR):
        from ..diffusion.preconditioning import EpsPreconditioning
        from ..diffusion.weighting import EpsWeighting
        from ..optimizers.adamw import adam

        self.model, self.dtype = model, dtype
        self.device = next(model.parameters()).device
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt = adam(self.params, lr, b1=0.9, b2=0.999, eps=1e-8)
        self.pc, self.w_fn = EpsPreconditioning(), EpsWeighting()

    def step(self, x0: np.ndarray, ctx: np.ndarray, sig: np.ndarray, noise: np.ndarray, update: bool = True) -> tuple:
        """One step on a batch of the streams (NCHW numpy): (loss, the
        global grad norm), device tensors; ``update`` False stops before
        the optimizer (a reference's step 0)."""
        x = _nhwc(x0, self.device)
        sig_t = torch.from_numpy(sig).to(self.device)
        s = sig_t[:, None, None, None]
        z_t = x + s * _nhwc(noise, self.device)
        c_skip, c_out, c_in, c_noise = self.pc(s)
        inp = z_t * c_in
        out = self.model(inp.to(self.dtype) if self.dtype is not None else inp, c_noise.reshape(-1),
                         torch.from_numpy(ctx).to(self.device))
        denoised = out.float() * c_out + z_t * c_skip
        loss = (((denoised - x) ** 2).mean(dim=(1, 2, 3)) * self.w_fn(sig_t)).mean()
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm([p.grad for p in self.params])))
        if update:
            self.opt.step()
        return loss.detach(), norm


def batches(steps: int, seed: int, res: int = RES, context_dim: int = 768) -> Iterator[tuple]:
    """(x0, ctx, σ, noise) of each step: the data stream beside the seed's draws."""
    for (x0, ctx), (sig, noise) in zip(data_stream(steps, res, context_dim),
                                       sigma_noise_stream(steps, seed, ddpm_sigmas(), res)):
        yield x0, ctx, sig, noise


def train(model: torch.nn.Module, steps: int, seed: int, res: int = RES, dtype: Optional[torch.dtype] = None,
          context_dim: int = 768, lr: float = LR, log_every: int = 0) -> dict:
    """``steps`` of ``Arm`` on the seed's streams: the per-step losses and
    global grad norms and the seconds (the device synchronised at the end)."""
    arm = Arm(model, dtype, lr)
    losses, norms = [], []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches(steps, seed, res, context_dim)):
        loss, norm = arm.step(*batch)
        losses.append(loss)
        norms.append(norm)
        if log_every and i % log_every == 0:
            print(f"port[{seed}] step {i}: {float(loss):.4f} ({time.perf_counter() - t0:.0f}s)", flush=True)
    losses, norms = torch.stack(losses).tolist(), torch.stack(norms).tolist()  # one sync
    return {"losses": losses, "grad_norms": norms, "seconds": time.perf_counter() - t0}


def ema(xs: np.ndarray, decay: float = 0.98) -> np.ndarray:
    """Bias-corrected EMA."""
    out = np.empty_like(xs)
    m = xs[0]
    for i, x in enumerate(xs):
        m = decay * m + (1 - decay) * x
        out[i] = m / (1 - decay ** (i + 1))
    return out


def analyze(runs: list) -> dict:
    """The tool's rule: the band is the first two band runs' ("side" other
    than "jax") EMA gap after a warmup of a quarter of the steps; each JAX
    run passes when its EMA stays within 1.5 × band of the first band run's."""
    band_runs = [r for r in runs if r["side"] != "jax"]
    jax_runs = [r for r in runs if r["side"] == "jax"]
    assert len(band_runs) >= 2, "need two seeds for the noise band"
    emas = {f"{r['side']}[{r.get('dtype', 'fp32')}#{r['seed']}]": ema(np.asarray(r["losses"])) for r in runs}
    t_emas = [ema(np.asarray(r["losses"])) for r in band_runs]
    warm = len(t_emas[0]) // 4
    band = float(np.abs(t_emas[0][warm:] - t_emas[1][warm:]).max())
    report = {"noise_band": band, "warmup": warm, "checks": []}
    for r in jax_runs:
        je = ema(np.asarray(r["losses"]))
        dev = float(np.abs(je[warm:] - t_emas[0][warm:]).max())
        report["checks"].append({"run": f"jax[{r.get('dtype')}]", "max_ema_dev": dev, "limit": 1.5 * band,
                                 "pass": dev <= 1.5 * band})
    report["final_ema"] = {k: float(v[-1]) for k, v in emas.items()}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--res", type=int, default=RES)
    ap.add_argument("--device", default=None, help="cuda unless given (cpu for a CPU run)")
    ap.add_argument("--out")
    ap.add_argument("--analyze", nargs="+")
    args = ap.parse_args(argv)
    if args.analyze:
        runs = []
        for p in args.analyze:
            with open(p) as f:
                runs.append(json.load(f))
        report = analyze(runs)
        print(json.dumps(report, indent=2))
        return 0 if all(c["pass"] for c in report["checks"]) else 1
    from .._device import resolve_device

    device = resolve_device(args.device)
    model, checksum = build_unet(torch.bfloat16, device)
    run = train(model, args.steps, args.seed, args.res, torch.bfloat16, log_every=20)
    payload = {"side": "torch", "dtype": "bf16", "seed": args.seed, "steps": args.steps, "res": args.res,
               "init_checksum": checksum, "device": str(device), **run}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
