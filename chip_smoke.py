#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neurosis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure:
  1. environment: Python, torch and CUDA versions, the card's name and power limit;
  2. build: nvcc compiles every source of neurosis_tpu_torch/csrc for sm_90a;
  3. kernels: each kernel wrapper against its plain PyTorch version on the card,
     on the same bf16 inputs at the shapes of the SD1.5 train step, with the
     kernel's time, the plain version's, one library call's (a yardstick only:
     the port never calls it) and the least time an H100 could take;
  4. reference: a small engine whose layers all take the kernels, one train step
     on the card against the same step on the CPU (plain versions throughout);
  5. slice: three DiffusionEngine.train_steps of SD1.5 at full width (batch 4 of
     64x64x4 latents and 77 token ids, bf16 UNet, fp32 CLIP-L, Adafactor, EMA),
     with every kernel's launch count read around them;
  6. profile: a fourth step under torch.profiler, device time by kernel and by
     kind (the port's kernels, library matmuls and convs, the rest) and the
     device's busy share of a step.
Then one JSON line of kernels, the nvidia-smi line and, last, the result line.
Everything measured also goes to chiprun_out/chip_smoke.json.

Exits non-zero without a result line when CUDA is absent or the port's package
cannot be imported (the script alone, outside a checkout).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# published H100 SXM peaks: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
OUT_FILE = Path("chiprun_out") / "chip_smoke.json"

# Every shape the SD1.5 step hands each kernel, with the kernel's launches per
# step at that shape (run_slice holds their sums against the counters).
# Flash (B, H, Sq, Skv, D): self and cross (kv = 77, masked tail) attention of
# the 5 transformer blocks at each of level 0 and level 1; the forward runs
# twice a step (the blocks are recomputed in the backward), the backward once.
FLASH_SHAPES = {(4, 8, 4096, 4096, 40): (10, 5), (4, 8, 4096, 77, 40): (10, 5),
                (4, 8, 1024, 1024, 80): (10, 5), (4, 8, 1024, 77, 80): (10, 5)}
# 3x3 convs (B, H, W, C, F) -> (forward, dgrad) launches: the upsample convs
# into 32x32 and into 64x64, and the dgrads of the fused ResBlock convs
CONV_SHAPES = {(4, 32, 32, 640, 640): (0, 6), (4, 32, 32, 1280, 640): (0, 1),
               (4, 32, 32, 1280, 1280): (1, 1), (4, 64, 64, 640, 640): (1, 1)}
# fused GroupNorm+SiLU->conv: the ResBlock in/out pairs at 32x32 (the dgrad of
# a 1920-channel input stays on the library: JAX's dgrad gate takes c_in <= 1280)
GN_CONV_SHAPES = {(4, 32, 32, 640, 640): 6, (4, 32, 32, 1280, 640): 1, (4, 32, 32, 1920, 640): 1}

# tolerances on max|kernel - plain| / max|plain|, same bf16 inputs on both sides
TOL = {
    "flash_fwd": 2e-2,  # kernel rounds P to bf16 before P.V; both round O to bf16
    "flash_lse": 1e-3,  # fp32 both sides, absolute in log2 units
    "flash_bwd": 5e-2,  # kernel rounds P and dS to bf16 and sums dQ with fp32 atomics
    "conv3x3": 1e-2,  # fp32 accumulation in another order, bf16 output rounding
    "gn_silu_conv3x3": 1e-2,
    "gn_silu_conv3x3_bwd": 2e-2,  # adds the dgrad kernel's rounding of dact
}

KERNELS = {
    "flash_fwd": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                      replaces="neurosis_tpu/ops/flash_attention.py:575"),
    "flash_bwd": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                      replaces="neurosis_tpu/ops/flash_attention.py:843"),
    "conv3x3": dict(source="neurosis_tpu_torch/csrc/conv3x3.cu",
                    replaces="neurosis_tpu/ops/conv3x3.py:42"),
    "gn_silu_conv3x3": dict(source="neurosis_tpu_torch/csrc/conv3x3.cu",
                            replaces="neurosis_tpu/ops/conv3x3.py:179"),
}


class PhaseError(RuntimeError):
    pass


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return (r.stdout.strip() or r.stderr.strip()).splitlines()[0]


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: operations over the bf16 peak or
    bytes over the memory rate, whichever is larger."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error over max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def check(name: str, rel: float, tol: float, log: list, abs_err: float | None = None) -> None:
    ok = rel <= tol
    abs_part = "" if abs_err is None else f"max abs err {abs_err:.3e}, "
    log.append(f"{name}: {abs_part}rel err {rel:.3e} (tolerance {tol:.1e}) {'ok' if ok else 'FAILED'}")
    print(log[-1], flush=True)
    if not ok:
        raise PhaseError(f"{name} disagrees with its plain version: {rel:.3e} > {tol:.1e}")


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(torch, log: list) -> dict:
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops import flash_attention as fa

    rows = {"flash_fwd": [], "flash_bwd": []}
    for shape, (n_fwd, n_bwd) in FLASH_SHAPES.items():
        b, h, sq, skv, d = shape
        g = torch.Generator("cuda").manual_seed(sum(shape))
        q, do = (torch.randn(b, h, sq, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(b, h, skv, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        qs = (q * (scale * fa.LOG2_E)).to(q.dtype)
        tag = "x".join(map(str, shape))

        o, lse = fa.flash_fwd(qs, k, v)
        o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v)
        err, rel = rel_err(o, o_ref)
        check(f"flash_fwd {tag} O", rel, TOL["flash_fwd"], log, err)
        lse_err = float((lse - lse_ref).abs().max())
        check(f"flash_fwd {tag} LSE (abs)", lse_err, TOL["flash_lse"], log)
        bh_in = b * h * (sq + 2 * skv) * d * 2
        t, by = bound_ms(4.0 * b * h * sq * skv * d, bh_in + b * h * sq * (d * 2 + 4))
        rows["flash_fwd"].append(dict(
            shape=tag, per_step=n_fwd, max_abs_err=err, rel_err=rel,
            ms=time_ms(torch, lambda: fa.flash_fwd(qs, k, v)),
            plain_ms=time_ms(torch, lambda: fa.flash_fwd_plain(qs, k, v), iters=3, warmup=1),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            bound_ms=t, bound_by=by))

        di = (do.float() * o_ref.float()).sum(-1)
        grads = fa.flash_bwd(qs, k, v, do, lse_ref, di, scale)
        grads_ref = fa.flash_bwd_plain(qs, k, v, do, lse_ref, di, scale)
        errs = []
        for gname, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
            e, r = rel_err(got, want)
            check(f"flash_bwd {tag} {gname}", r, TOL["flash_bwd"], log, e)
            errs.append((e, r))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg)
        # reads q~, k, v, dO (bf16) and LSE, Di (fp32); writes dq, dk, dv (bf16)
        t, by = bound_ms(10.0 * b * h * sq * skv * d,
                         bh_in + b * h * sq * (d * 2 + 8) + b * h * (sq + 2 * skv) * d * 2)
        rows["flash_bwd"].append(dict(
            shape=tag, per_step=n_bwd, max_abs_err=max(e for e, _ in errs), rel_err=max(r for _, r in errs),
            ms=time_ms(torch, lambda: fa.flash_bwd(qs, k, v, do, lse_ref, di, scale)),
            plain_ms=time_ms(torch, lambda: fa.flash_bwd_plain(qs, k, v, do, lse_ref, di, scale),
                             iters=3, warmup=1),
            library_ms=time_ms(torch, lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                                  retain_graph=True)),
            bound_ms=t, bound_by=by))
        del q, k, v, do, qs, o, o_ref, grads, grads_ref, lib_out
        torch.cuda.empty_cache()
    return rows


def check_conv(torch, log: list) -> dict:
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops import conv3x3 as cv

    rows = {"conv3x3": [], "gn_silu_conv3x3": []}
    for shape, (n_fwd, n_dgrad) in CONV_SHAPES.items():
        b, hh, ww, c, f = shape
        g = torch.Generator("cuda").manual_seed(sum(shape))
        x = torch.randn(b, hh, ww, c, generator=g, device="cuda").bfloat16()
        dy = torch.randn(b, hh, ww, f, generator=g, device="cuda").bfloat16()
        w = (torch.randn(f, c, 3, 3, generator=g, device="cuda") / math.sqrt(9 * c)).bfloat16()
        w_k = cv._kernel_filter(w)  # [3, 3, C, F]
        w_flip = w.flip(2, 3).permute(2, 3, 0, 1).contiguous()  # dgrad filter [3, 3, F, C]
        for kind, n, inp, filt, lib_w, (ci, fo) in (
            ("fwd", n_fwd, x, w_k, w, (c, f)),
            ("dgrad", n_dgrad, dy, w_flip, w_flip.permute(3, 2, 0, 1), (f, c)),
        ):
            tag = f"{kind} {b}x{hh}x{ww}x{ci}->{fo}"
            out = cv.conv3x3_nhwc(inp, filt)
            err, rel = rel_err(out, cv.conv3x3_plain(inp, filt))
            check(f"conv3x3 {tag}", rel, TOL["conv3x3"], log, err)
            inp_nchw = inp.permute(0, 3, 1, 2)
            t, by = bound_ms(2.0 * 9 * b * hh * ww * ci * fo, 2 * (b * hh * ww * (ci + fo) + 9 * ci * fo))
            rows["conv3x3"].append(dict(
                shape=tag, per_step=n, max_abs_err=err, rel_err=rel,
                ms=time_ms(torch, lambda: cv.conv3x3_nhwc(inp, filt)),
                plain_ms=time_ms(torch, lambda: cv.conv3x3_plain(inp, filt), iters=3, warmup=1),
                library_ms=time_ms(torch, lambda: F.conv2d(inp_nchw, lib_w, padding=1)),
                bound_ms=t, bound_by=by))

    for shape, n in GN_CONV_SHAPES.items():
        b, hh, ww, c, f = shape
        g = torch.Generator("cuda").manual_seed(sum(shape) + 7)
        x = torch.randn(b, hh, ww, c, generator=g, device="cuda").bfloat16()
        dy = torch.randn(b, hh, ww, f, generator=g, device="cuda").bfloat16()
        w = (torch.randn(f, c, 3, 3, generator=g, device="cuda") / math.sqrt(9 * c)).bfloat16()
        a = 1.0 + 0.2 * torch.randn(b, c, generator=g, device="cuda")
        bb = 0.3 * torch.randn(b, c, generator=g, device="cuda")
        w_k = cv._kernel_filter(w)
        tag = f"fwd {b}x{hh}x{ww}x{c}->{f}"
        out = cv.gn_silu_conv3x3_nhwc(x, a, bb, w_k)
        err, rel = rel_err(out, cv.gn_silu_conv3x3_plain(x, a, bb, w_k))
        check(f"gn_silu_conv3x3 {tag}", rel, TOL["gn_silu_conv3x3"], log, err)
        got = cv.gn_silu_conv3x3_bwd(x, a, bb, w, dy)
        want = cv.gn_silu_conv3x3_bwd(x, a, bb, w, dy, conv=cv.conv3x3_plain)
        for gname, gk, gp in zip(("dx", "da", "db", "dw"), got, want):
            e, r = rel_err(gk, gp)
            check(f"gn_silu_conv3x3 bwd {b}x{hh}x{ww}x{c}->{f} {gname}", r, TOL["gn_silu_conv3x3_bwd"], log, e)
        t, by = bound_ms(2.0 * 9 * b * hh * ww * c * f, 2 * (b * hh * ww * (c + f) + 9 * c * f) + 8 * b * c)
        rows["gn_silu_conv3x3"].append(dict(
            shape=tag, per_step=n, max_abs_err=err, rel_err=rel,
            ms=time_ms(torch, lambda: cv.gn_silu_conv3x3_nhwc(x, a, bb, w_k)),
            plain_ms=time_ms(torch, lambda: cv.gn_silu_conv3x3_plain(x, a, bb, w_k), iters=3, warmup=1),
            library_ms=None, bound_ms=t, bound_by=by))
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: engines
# ---------------------------------------------------------------------------


def make_engine(torch, device, seed: int, unet: dict, clip: dict, use_ema: bool = True):
    """DiffusionEngine on the latents path with the SD1.5 config's classes:
    bf16 UNet with fp32 parameters, fp32 frozen CLIP embedder, DiscreteDenoiser
    with EpsPreconditioning over LegacyDDPM, DiscreteSigmaGenerator,
    EpsWeighting, Adafactor(scale_parameter, relative_step, warmup_init)."""
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import EpsWeighting
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenCLIPEmbedder, GeneralConditioner
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor
    from neurosis_tpu_torch.trainer.engine import DiffusionEngine

    g = torch.Generator(device).manual_seed(seed)
    model = UNetModel(**unet, use_checkpoint=True, dtype=torch.bfloat16, device=device, generator=g)
    conditioner = GeneralConditioner([FrozenCLIPEmbedder(**clip, device=device, generator=g)])
    disc = LegacyDDPMDiscretization()
    return DiffusionEngine(
        model=model,
        denoiser=DiscreteDenoiser(EpsPreconditioning(), 1000, disc, device=device),
        loss_fn=StandardDiffusionLoss(DiscreteSigmaGenerator(disc, 1000, device=device), EpsWeighting()),
        conditioner=conditioner,
        optimizer=lambda params: Adafactor(params, scale_parameter=True, relative_step=True, warmup_init=True),
        use_ema=use_ema,
        device=device,
    )


def make_batch(torch, device, batch: int, side: int, seed: int) -> dict:
    g = torch.Generator("cpu").manual_seed(seed)
    ids = torch.randint(1, 49406, (batch, 77), generator=g)
    ids[:, 0] = 49406  # BOS
    eos = torch.randint(4, 77, (batch,), generator=g)
    for i in range(batch):
        ids[i, eos[i]:] = 49407  # EOS, then padding with the EOS id
    latents = torch.randn(batch, side, side, 4, generator=g)
    return {"latents": latents.to(device), "caption_ids": ids.to(device)}


SMALL_UNET = dict(in_channels=4, model_channels=128, out_channels=4, num_res_blocks=1,
                  attention_resolutions=[1], channel_mult=[1, 1], num_heads=2, context_dim=64)
SMALL_CLIP = dict(width=64, layers=2, heads=2)


def reference_step(torch, log: list) -> dict:
    """One train step of a small engine on the card against the same step on
    the CPU. At 32x32 latents with 128 channels and 2 heads of 64 every
    kernel takes part: flash (S=1024 self, kv=77 cross), conv3x3 (upsample
    conv, dgrad), gn_silu_conv3x3 (ResBlock pairs)."""
    from neurosis_tpu_torch import ops

    engines, metrics = {}, {}
    for device in ("cpu", "cuda"):
        eng = make_engine(torch, device, 1, SMALL_UNET, SMALL_CLIP)
        engines[device] = eng
    # perturb the weights (zero-init output layers included) identically
    g = torch.Generator("cpu").manual_seed(2)
    for p_cpu, p_gpu in zip(engines["cpu"].model.parameters(), engines["cuda"].model.parameters()):
        with torch.no_grad():
            p_cpu.add_(0.02 * torch.randn(p_cpu.shape, generator=g))
            p_gpu.copy_(p_cpu)
    for p_cpu, p_gpu in zip(engines["cpu"].conditioner.parameters(), engines["cuda"].conditioner.parameters()):
        with torch.no_grad():
            p_gpu.copy_(p_cpu)
    batch = make_batch(torch, "cpu", 2, 32, 3)
    t = torch.tensor([0.3, 0.8])
    noise = torch.randn(batch["latents"].shape, generator=torch.Generator("cpu").manual_seed(4))
    counts_before = ops.launch_counts()
    for device, eng in engines.items():
        state = eng.init(seed=0)
        b = {k: v.to(device) for k, v in batch.items()}
        _, m = eng.train_step(state, b, t=t.to(device), noise=noise.to(device))
        metrics[device] = {k: float(v) for k, v in m.items()}
    launched = {k: ops.launch_counts()[k] - counts_before[k] for k in counts_before}
    print(f"reference step launches: {launched}", flush=True)
    if not all(launched.values()):
        raise PhaseError(f"the small engine did not launch every kernel: {launched}")
    for key, tol in (("loss", 2e-2), ("grad_norm", 5e-2)):
        cpu, gpu = metrics["cpu"][key], metrics["cuda"][key]
        check(f"small engine {key}: cuda {gpu:.6g} vs cpu {cpu:.6g}", abs(gpu - cpu) / abs(cpu), tol, log)
    return metrics


SD15_UNET = dict(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
                 attention_resolutions=[4, 2, 1], channel_mult=[1, 2, 4, 4], num_heads=8,
                 transformer_depth=1, context_dim=768)
SD15_CLIP = dict(width=768, layers=12, heads=12)


def step_totals(rows: dict) -> dict:
    """Per kernel, from the shape tables and phase 3's times: launches per
    SD1.5 step, their summed time and their summed bound."""
    return {name: dict(launches=sum(r["per_step"] for r in rs),
                       ms=sum(r["per_step"] * r["ms"] for r in rs),
                       bound_ms=sum(r["per_step"] * r["bound_ms"] for r in rs))
            for name, rs in rows.items()}


def run_slice(torch, rows: dict, steps: int = 3) -> dict:
    from neurosis_tpu_torch import ops

    t0 = time.perf_counter()
    engine = make_engine(torch, "cuda", 0, SD15_UNET, SD15_CLIP)
    n_unet = sum(p.numel() for p in engine.model.parameters())
    n_clip = sum(p.numel() for p in engine.conditioner.parameters())
    state = engine.init(seed=0)
    batch = make_batch(torch, "cuda", 4, 64, 5)
    torch.cuda.synchronize()
    print(f"SD1.5 engine built in {time.perf_counter() - t0:.1f} s: UNet {n_unet} params, "
          f"CLIP-L {n_clip} params", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_rows = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = engine.train_step(state, batch)
        loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        step_rows.append(dict(step=i, loss=loss, grad_norm=grad_norm, ms=ms))
        print(f"train_step {i}: loss {loss:.6f} grad_norm {grad_norm:.6f} {ms:.1f} ms", flush=True)
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            raise PhaseError(f"step {i} is not finite: loss {loss}, grad_norm {grad_norm}")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"slice launches: {launches}", flush=True)
    print(f"peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise PhaseError(f"the slice never launched {missing}")
    totals = step_totals(rows)
    for name, tot in totals.items():
        print(f"{name} per step: {tot['launches']} launches, {tot['ms']:.3f} ms at the phase-3 times, "
              f"bound {tot['bound_ms']:.3f} ms", flush=True)
    unlisted = {k: n for k, n in launches.items() if n != steps * totals[k]["launches"]}
    if unlisted:
        raise PhaseError(f"launches {unlisted} differ from the shape tables' per-step counts x {steps}")
    ema_ok = all(bool(torch.isfinite(s).all()) for s in state.ema.params)
    if not ema_ok:
        raise PhaseError("EMA shadows are not finite")
    step_ms = statistics.median(r["ms"] for r in step_rows[1:])
    return dict(steps=step_rows, launches=launches, per_step=totals, peak_bytes=peak, unet_params=n_unet,
                clip_params=n_clip, profile=profile_step(torch, engine, state, batch, step_ms))


def kernel_kind(name: str) -> str:
    """Which layer a device kernel belongs to, by its name."""
    low = name.lower()
    if "flash_" in low or "conv3x3_kernel" in low:
        return "port kernels"
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn")):
        return "library conv"
    if any(s in low for s in ("gemm", "nvjet", "cublas", "cutlass")):
        return "library matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, norms, reductions, optimizer)"


def profile_step(torch, engine, state, batch, step_ms: float, top: int = 15) -> dict:
    """One more train step under torch.profiler: device time by kernel and by
    kind, and the device's busy share of the median unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.train_step(state, batch)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    spans = []
    for e in prof.events():
        # device-side events are kernels, copies and (skipped) annotation ranges
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        print("profile: the profiler recorded no device kernels: device time not measured", flush=True)
        return dict(device_ms=None)
    busy_us, end = 0.0, -math.inf  # union of the kernels' intervals
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    kinds: dict = {}
    for name, (_, us) in by_name.items():
        kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + us / 1e3
    rows = sorted(((us / 1e3, n, name) for name, (n, us) in by_name.items()), reverse=True)
    device_ms = busy_us / 1e3
    print(f"profile: device busy {device_ms:.3f} ms in one step; median unprofiled step {step_ms:.3f} ms, "
          f"busy share {device_ms / step_ms:.4f}", flush=True)
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"profile: {kind}: {ms:.3f} ms", flush=True)
    for ms, n, name in rows[:top]:
        print(f"profile: {ms:9.3f} ms {n:6d} x {name[:110]}", flush=True)
    return dict(device_ms=device_ms, step_ms=step_ms, busy_share=device_ms / step_ms, kinds_ms=kinds,
                launches=sum(n for _, n, _ in rows),
                kernels=[dict(name=name, ms=ms, count=n) for ms, n, name in rows[:40]])


# ---------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py drives the port on a CUDA card", file=sys.stderr)
        return 1
    try:
        from neurosis_tpu_torch import _nvcc, ops
    except ImportError as e:
        print(f"neurosis_tpu_torch is not importable (run from the repository root): {e}", file=sys.stderr)
        return 1

    # the plain versions compute in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    report: dict = {"card": smi}
    log: list = []
    try:
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
        print(smi, flush=True)

        t0 = time.perf_counter()
        compile_s = _nvcc.build_all(_nvcc.SOURCES, verbose=True)
        report["build_s"] = time.perf_counter() - t0
        print(f"build: {report['build_s']:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in compile_s.items())})",
              flush=True)

        rows = {**check_flash(torch, log), **check_conv(torch, log)}
        report["kernel_rows"] = rows
        for name, rs in rows.items():
            for r in rs:
                lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
                print(f"{name} {r['shape']}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library {lib} ms, "
                      f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)

        report["reference"] = reference_step(torch, log)
        report["slice"] = run_slice(torch, rows)
    except Exception as e:  # any failed phase ends the run without a result line
        report["error"] = repr(e)
        _write(report, log)
        print(f"FAILED: {e!r}", file=sys.stderr, flush=True)
        raise

    _write(report, log)
    kernels = []
    for name, meta in KERNELS.items():
        head = max(rows[name], key=lambda r: r["per_step"] * r["ms"])  # the shape that costs the step most
        kernels.append(dict(name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
                            launches=report["slice"]["launches"][name], max_abs_err=head["max_abs_err"],
                            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                            bound_by=head["bound_by"], library_ms=head["library_ms"], shape=head["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _write(report: dict, log: list) -> None:
    OUT_FILE.parent.mkdir(parents=True, exist_ok=True)
    OUT_FILE.write_text(json.dumps(dict(report, checks=log), indent=1, default=str))


if __name__ == "__main__":
    sys.exit(main())
