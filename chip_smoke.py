#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neurosis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Six paths run at full width: the SD1.5 train step from images (the frozen
fp32 VAE encode in front of the UNet step) with a bf16 UNet and with the fp32
UNet of configs/sd15/sd15.example.yaml as written, the VAE-GAN trainer
(alternating generator and discriminator steps) with a bf16 and with an fp32
encoder and decoder, the SDXL train step from 1024 px images, and the
flash-overlap tool.

Phases, each fatal on failure:
  1. environment: Python, torch and CUDA versions, the card's name and power limit;
  2. build: nvcc compiles every source of neurosis_tpu_torch/csrc for sm_90a, one
     process per source, all at once;
  3. kernels: each kernel wrapper against its plain PyTorch version on the card,
     on the same inputs at every shape a path gives it (and, for the fp32
     flash kernels, the rows of the fp32 SDXL UNet of sdxl.example.yaml and of
     the smoke VAEs, which no path here drives), with the kernel's time, the
     plain version's, one library call's (a yardstick only: the port never
     calls it) and the least time an H100 could take;
  4. reference: small engines whose layers all take the kernels, on the card
     against the same computation on the CPU (plain versions throughout): one
     SD train step, one SDXL-layout train step (two text towers, size
     embedders, the label embedding), one VAE-GAN generator and discriminator
     pair in bf16, one in fp32 and one in fp32 at configs/smoke/vae-tiny.yaml's
     dims (the fp32 flash kernels at head dim 64), one fp32 frozen encode;
  5. slice: three DiffusionEngine.train_steps of SD1.5 at full width (batch 4 of
     uint8 512x512 images and 77 token ids; frozen fp32 VAE encode, bf16 UNet,
     fp32 CLIP-L, Adafactor, EMA), with every kernel's launch count read around
     them;
  6. profile: a fourth step under torch.profiler, device time by kernel and by
     kind (the port's kernels, library matmuls and convs, the rest) and the
     device's busy share of a step; the frozen encode profiled on its own;
  6b. SD1.5 in fp32: the same three steps, profiled step and encode for
     configs/sd15/sd15.example.yaml as written (no precision key: fp32 UNet,
     256 px, batch 1, no EMA); its kernels are the fp32 flash forward and
     backward at head dim 40 (padded to 64) and the encode's at 512;
  7. VAE-GAN: one warm generator/discriminator pair, then three timed pairs of
     the VAE-GAN trainer at full width (batch 8 of uint8 256x256 images, bf16
     encoder and decoder, fp32 LPIPS alex and PatchGAN, AdamW), with the launch
     counts read around the three pairs, and a fourth pair profiled;
  8. fp32 VAE-GAN: the same trainer as configs/vae/vae.example.yaml is written
     (no precision key: fp32 encoder and decoder), one warm pair, three timed,
     one profiled; its kernels are the fp32 flash forward and backward;
  9. SDXL: one warm and three timed DiffusionEngine.train_steps of
     configs/sdxl/sdxl.example.yaml at full width (batch 2 of uint8 1024x1024
     images, 77 token ids and the three size conditionings; frozen fp32 VAE
     encode, fp32 CLIP-L and OpenCLIP bigG, bf16 UNet with the label embedding,
     Adafactor, no EMA), launch counts read around the three, then a profiled
     step, and the encode and each text tower profiled on their own;
 10. overlap: python -m neurosis_tpu_torch.tools.overlap_bench's cases, with
     the launch counts read around them.
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

# published H100 SXM peaks: dense bf16 tensor-core rate, fp32 FFMA rate on the
# CUDA cores (the fp32 flash kernels' units) and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 66.9e12
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
# the SD1.5 step's frozen fp32 encode: the VAE's mid attention over 64x64 latents
FLASH_F32_SHAPES = {(4, 1, 4096, 4096, 512): 1}
# The SD1.5 step of configs/sd15/sd15.example.yaml as written: fp32 UNet, 256 px
# (32x32 latents), batch 1. Level 0 (1024 tokens, 320 channels in 8 heads of 40)
# is the only level past the flash gate: its 5 transformer blocks' self and cross
# (kv = 77) attention, forward twice a step and backward once, in the fp32
# kernels at head dim 40 (padded to 64); the frozen encode's mid attention over
# 32x32 latents at 512. Every conv is fp32, so it goes to the library.
SD15_F32_FLASH_SHAPES = {(1, 8, 1024, 1024, 40): (10, 5), (1, 8, 1024, 77, 40): (10, 5),
                         (1, 1, 1024, 1024, 512): (1, 0)}

# The VAE-GAN trainer (256 px, batch 8, bf16 encoder and decoder), launches per
# generator + discriminator pair. The mid attention (1024 tokens, d=512) runs in
# the encoder and the decoder of both steps, backward in the generator step.
VAE_FLASH_SHAPES = {(8, 1, 1024, 1024, 512): (4, 2)}
# convs: the decoder's upsample conv into 64x64 in both steps; the generator
# step's dgrads of every fused ResnetBlock conv (the C -> F conv's dgrad is
# listed under (B, H, W, C, F)) and of the upsample conv
VAE_CONV_SHAPES = {(8, 64, 64, 512, 512): (2, 10), (8, 64, 64, 256, 512): (0, 1),
                   (8, 32, 32, 512, 512): (0, 18)}
# fused GroupNorm+SiLU->conv: the ResnetBlock pairs at 64x64 (encoder level 2,
# decoder level 2) and at 32x32 (encoder level 3, both mid blocks, decoder
# level 3), forward in both steps
VAE_GN_CONV_SHAPES = {(8, 64, 64, 256, 512): 2, (8, 64, 64, 512, 512): 18, (8, 32, 32, 512, 512): 36}
# The same trainer with an fp32 encoder and decoder (the config as written):
# the conv gate wants bf16, so every conv goes to the library and the mid
# attention is the path's only kernel work, forward and backward in fp32.
VAE_F32_FLASH_SHAPES = {(8, 1, 1024, 1024, 512): (4, 2)}

# The SDXL step (batch 2, 1024 px, 128x128 latents; UNet 320 x [1, 2, 4], two
# ResBlocks a level, transformer depth [1, 2, 10] at 64 heads channels).
# Attention lives at level 1 (64x64, 640 ch, 10 heads, depth 2: two input and
# three output blocks = 10 transformer blocks) and at level 2 with the middle
# (32x32, 1280 ch, 20 heads, depth 10: two input, the middle, three output =
# 60 blocks); each block has one self and one cross (kv = 77) attention, run
# forward twice a step (recomputed in the backward) and backward once.
SDXL_FLASH_SHAPES = {(2, 10, 4096, 4096, 64): (20, 10), (2, 10, 4096, 77, 64): (20, 10),
                     (2, 20, 1024, 1024, 64): (120, 60), (2, 20, 1024, 77, 64): (120, 60)}
# fused GroupNorm+SiLU->conv (128-multiple channels at 64x64 and 32x32; level 0
# is 128x128 = 16384 pixels and 320 and 960 channels are no 128-multiples:
# library). 64x64: the input blocks' 640->640 pairs (3) and the output blocks'
# out_layers (3), the output blocks' in_layers from 1920 and 1280 channels;
# 32x32: 640->1280 once, 1280->1280 in the input blocks (3), the middle (4) and
# the output blocks' out_layers (3), the output blocks' in_layers from 2560
# (twice) and 1920 channels.
SDXL_GN_CONV_SHAPES = {(2, 64, 64, 640, 640): 6, (2, 64, 64, 1280, 640): 1, (2, 64, 64, 1920, 640): 1,
                       (2, 32, 32, 640, 1280): 1, (2, 32, 32, 1280, 1280): 10, (2, 32, 32, 1920, 1280): 1,
                       (2, 32, 32, 2560, 1280): 2}
# conv3x3: the upsample conv into 64x64 (1280 channels), forward and dgrad, and
# the dgrads of the fused convs whose input has at most 1280 channels
SDXL_CONV_SHAPES = {(2, 64, 64, 1280, 1280): (1, 1), (2, 64, 64, 640, 640): (0, 6), (2, 64, 64, 1280, 640): (0, 1),
                    (2, 32, 32, 640, 1280): (0, 1), (2, 32, 32, 1280, 1280): (0, 10)}
# the SDXL step's frozen fp32 encode: the VAE's mid attention over 128x128 latents
SDXL_FLASH_F32_SHAPES = {(2, 1, 16384, 16384, 512): 1}
# fp32 rows no path here drives, checked and timed at kernel level: the SDXL
# step's attention with the fp32 UNet of configs/sdxl/sdxl.example.yaml as
# written (the shapes and counts of SDXL_FLASH_SHAPES, head dim 64), the frozen
# encode of configs/smoke/sd15-tiny.yaml (ch 32 x [1, 2] at 64 px: 64 channels
# over 32x32) and configs/smoke/vae-tiny.yaml's training (the same mid attention
# at batch 2, forward in the encoder and decoder of both steps, backward in the
# generator step)
UNDRIVEN_F32_FLASH_SHAPES = {"sdxl_f32": SDXL_FLASH_SHAPES, "sd15_tiny": {(1, 1, 1024, 1024, 64): (1, 0)},
                             "vae_tiny": {(2, 1, 1024, 1024, 64): (4, 2)}}

# path -> (its key in the report, the unit its launch tables count)
PATHS = {"sd15": ("slice", "SD1.5 train step"),
         "sd15_f32": ("sd15_f32", "SD1.5 train step, fp32 UNet (sd15.example.yaml as written, 256 px, batch 1)"),
         "vae_gan": ("vae_gan", "VAE-GAN generator + discriminator pair, bf16"),
         "vae_gan_f32": ("vae_gan_f32", "VAE-GAN generator + discriminator pair, fp32"),
         "sdxl": ("sdxl", "SDXL train step"), "overlap": ("overlap", "one run of the flash-overlap tool")}

# tolerances on max|kernel - plain| / max|plain|, same bf16 inputs on both sides
TOL = {
    "flash_fwd": 2e-2,  # kernel rounds P to bf16 before P.V; both round O to bf16
    "flash_fwd_f32": 2e-5,  # fp32 throughout on both sides (FFMA, no TF32), sums in another order
    "flash_lse": 1e-3,  # fp32 both sides, absolute in log2 units
    "flash_bwd": 5e-2,  # kernel rounds P and dS to bf16 and sums dQ with fp32 atomics
    "flash_bwd_f32": 1e-4,  # fp32 throughout on both sides; dQ summed by atomics in a changing order
    "flash_overlap": 1e-2,  # P rounded to bf16 on both sides; bf16 output rounding, sums in another order
    "conv3x3": 1e-2,  # fp32 accumulation in another order, bf16 output rounding
    "gn_silu_conv3x3": 1e-2,
    "gn_silu_conv3x3_bwd": 2e-2,  # adds the dgrad kernel's rounding of dact
}

KERNELS = {
    "flash_fwd": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                      replaces="neurosis_tpu/ops/flash_attention.py:575"),
    "flash_bwd": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                      replaces="neurosis_tpu/ops/flash_attention.py:843"),
    "flash_fwd_f32": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                          replaces="neurosis_tpu/ops/flash_attention.py:297"),
    "flash_bwd_f32": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                          replaces="neurosis_tpu/ops/flash_attention.py:751"),
    "flash_fwd_split2": dict(source="neurosis_tpu_torch/csrc/flash_overlap.cu",
                             replaces="tools/overlap_bench.py:37"),
    "flash_fwd_chunked": dict(source="neurosis_tpu_torch/csrc/flash_overlap.cu",
                              replaces="tools/overlap_bench.py:66"),
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


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take: operations over the peak of the
    units that do them (bf16 tensor cores unless given) or bytes over the
    memory rate, whichever is larger."""
    t_ops = flops / peak_flops * 1e3
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
    """Device ms of one ``fn()``, the mean of ``iters`` back to back. The card
    first sleeps ~25 ms while the host queues the calls, so a small call is
    timed on the card, not by how fast this host issues its launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def overlap_launches() -> dict:
    """Launches of each kernel in one run of the overlap tool, by shape:
    {kernel: {(B, H, Sq, Skv, D) or (..., chunks): launches}} from its case
    list, plus the one base and one split2 call of its opening check."""
    from neurosis_tpu_torch.tools.overlap_bench import CASES, HEAD_DIM, ITERS, WARMUP

    names = {"base": "flash_fwd", "split2": "flash_fwd_split2", "chunked": "flash_fwd_chunked"}
    out = {name: {} for name in names.values()}
    for _label, variant, chunks, sq, skv, batch, heads in CASES:
        key = (batch, heads, sq, skv, HEAD_DIM) + ((chunks,) if variant == "chunked" else ())
        out[names[variant]][key] = out[names[variant]].get(key, 0) + WARMUP + ITERS
    out["flash_fwd"][(1, 2, 1024, 1024, HEAD_DIM)] = 1
    out["flash_fwd_split2"][(1, 2, 1024, 1024, HEAD_DIM)] = 1
    return out


def check_flash(torch, log: list) -> dict:
    """Each flash shape of every path in its dtype: forward and backward in
    bf16, and in fp32 (the frozen encodes run the forward only; fp32 plain
    version with TF32 off, SDPA on the same inputs as the yardstick), and the
    fp32 rows of UNDRIVEN_F32_FLASH_SHAPES."""
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops import flash_attention as fa

    rows = {"flash_fwd": [], "flash_bwd": [], "flash_fwd_f32": [], "flash_bwd_f32": []}
    bf16, f32 = torch.bfloat16, torch.float32
    tables = [("sd15", sh, n, bf16) for sh, n in FLASH_SHAPES.items()] + \
             [("vae_gan", sh, n, bf16) for sh, n in VAE_FLASH_SHAPES.items()] + \
             [("sdxl", sh, n, bf16) for sh, n in SDXL_FLASH_SHAPES.items()] + \
             [("overlap", sh, (n, 0), bf16) for sh, n in overlap_launches()["flash_fwd"].items()] + \
             [("sd15", sh, (n, 0), f32) for sh, n in FLASH_F32_SHAPES.items()] + \
             [("sd15_f32", sh, n, f32) for sh, n in SD15_F32_FLASH_SHAPES.items()] + \
             [("vae_gan_f32", sh, n, f32) for sh, n in VAE_F32_FLASH_SHAPES.items()] + \
             [("sdxl", sh, (n, 0), f32) for sh, n in SDXL_FLASH_F32_SHAPES.items()] + \
             [(path, sh, n, f32) for path, table in UNDRIVEN_F32_FLASH_SHAPES.items() for sh, n in table.items()]
    for path, shape, (n_fwd, n_bwd), dtype in tables:
        is_f32 = dtype == f32
        name, bwd_name = ("flash_fwd_f32", "flash_bwd_f32") if is_f32 else ("flash_fwd", "flash_bwd")
        fwd = fa.flash_fwd_f32 if is_f32 else fa.flash_fwd
        bwd = fa.flash_bwd_f32 if is_f32 else fa.flash_bwd
        peak = PEAK_FP32_FLOPS if is_f32 else PEAK_BF16_FLOPS  # fp32 FFMA or bf16 tensor cores
        b, h, sq, skv, d = shape
        g = torch.Generator("cuda").manual_seed(sum(shape) + is_f32)
        q, do = (torch.randn(b, h, sq, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(b, h, skv, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        qs = (q * (scale * fa.LOG2_E)).to(dtype)
        tag = "x".join(map(str, shape)) + (" fp32" if is_f32 else "")

        o, lse = fwd(qs, k, v)
        o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v)
        err, rel = rel_err(o, o_ref)
        check(f"{name} {tag} O", rel, TOL[name], log, err)
        lse_err = float((lse - lse_ref).abs().max())
        check(f"{name} {tag} LSE (abs)", lse_err, TOL["flash_fwd_f32" if is_f32 else "flash_lse"], log)
        # reads q~, k, v; writes O and the fp32 LSE
        elem = q.element_size()
        bh_in = b * h * (sq + 2 * skv) * d * elem
        t, by = bound_ms(4.0 * b * h * sq * skv * d, bh_in + b * h * sq * (d * elem + 4), peak)
        rows[name].append(dict(
            path=path, shape=tag, per_step=n_fwd, max_abs_err=err, rel_err=rel,
            ms=time_ms(torch, lambda: fwd(qs, k, v)),
            plain_ms=time_ms(torch, lambda: fa.flash_fwd_plain(qs, k, v), iters=3, warmup=1),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            bound_ms=t, bound_by=by))
        if not n_bwd:  # a forward-only shape: a frozen encode, the overlap tool's base cases
            del q, k, v, do, qs, o, o_ref
            torch.cuda.empty_cache()
            continue

        di = (do.float() * o_ref.float()).sum(-1)
        grads = bwd(qs, k, v, do, lse_ref, di, scale)
        grads_ref = fa.flash_bwd_plain(qs, k, v, do, lse_ref, di, scale)
        errs = []
        for gname, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
            e, r = rel_err(got, want)
            check(f"{bwd_name} {tag} {gname}", r, TOL[bwd_name], log, e)
            errs.append((e, r))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg)
        # reads q~, k, v, dO and LSE, Di (fp32); writes dq, dk, dv
        t, by = bound_ms(10.0 * b * h * sq * skv * d,
                         bh_in + b * h * sq * (d * elem + 8) + b * h * (sq + 2 * skv) * d * elem, peak)
        rows[bwd_name].append(dict(
            path=path, shape=tag, per_step=n_bwd, max_abs_err=max(e for e, _ in errs), rel_err=max(r for _, r in errs),
            ms=time_ms(torch, lambda: bwd(qs, k, v, do, lse_ref, di, scale)),
            plain_ms=time_ms(torch, lambda: fa.flash_bwd_plain(qs, k, v, do, lse_ref, di, scale),
                             iters=3, warmup=1),
            library_ms=time_ms(torch, lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                                  retain_graph=True)),
            bound_ms=t, bound_by=by))
        del q, k, v, do, qs, o, o_ref, grads, grads_ref, lib_out
        torch.cuda.empty_cache()
    return rows


def check_overlap(torch, log: list) -> dict:
    """The split2 and chunked forwards at every shape and chunk count of the
    overlap tool's cases, against their plain version (the same chunk loop)
    and against the unchunked softmax; SDPA as the yardstick."""
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops import flash_attention as fa
    from neurosis_tpu_torch.ops import flash_overlap as fo

    rows = {"flash_fwd_split2": [], "flash_fwd_chunked": []}
    launches = overlap_launches()
    for name in rows:
        for shape, n in launches[name].items():
            b, h, sq, skv, d = shape[:5]
            chunks = shape[5] if name == "flash_fwd_chunked" else 2
            kernel = (lambda qs, k, v: fo.flash_fwd_split2(qs, k, v)) if name == "flash_fwd_split2" else \
                     (lambda qs, k, v: fo.flash_fwd_chunked(qs, k, v, chunks))
            g = torch.Generator("cuda").manual_seed(sum(shape))
            q = torch.randn(b, h, sq, d, generator=g, device="cuda").bfloat16()
            k, v = (torch.randn(b, h, skv, d, generator=g, device="cuda").bfloat16() for _ in range(2))
            qs = (q * (fa.LOG2_E / math.sqrt(d))).to(q.dtype)
            tag = "x".join(map(str, shape[:5])) + f" in {chunks} chunks"
            o = kernel(qs, k, v)
            err, rel = rel_err(o, fo.flash_fwd_chunked_plain(qs, k, v, chunks))
            check(f"{name} {tag}", rel, TOL["flash_overlap"], log, err)
            _, rel_whole = rel_err(o, fa.flash_fwd_plain(qs, k, v)[0])
            check(f"{name} {tag} against the unchunked softmax", rel_whole, TOL["flash_fwd"], log)
            # reads q~, k, v and writes O, all bf16
            t, by = bound_ms(4.0 * b * h * sq * skv * d, 2 * b * h * (2 * sq + 2 * skv) * d)
            rows[name].append(dict(
                path="overlap", shape=tag, per_step=n, max_abs_err=err, rel_err=rel,
                ms=time_ms(torch, lambda: kernel(qs, k, v)),
                plain_ms=time_ms(torch, lambda: fo.flash_fwd_chunked_plain(qs, k, v, chunks), iters=3, warmup=1),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
                bound_ms=t, bound_by=by))
            del q, k, v, qs, o
            torch.cuda.empty_cache()
    return rows


def check_conv(torch, log: list) -> dict:
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops import conv3x3 as cv

    rows = {"conv3x3": [], "gn_silu_conv3x3": []}
    tables = [("sd15", sh, n) for sh, n in CONV_SHAPES.items()] + \
             [("vae_gan", sh, n) for sh, n in VAE_CONV_SHAPES.items()] + \
             [("sdxl", sh, n) for sh, n in SDXL_CONV_SHAPES.items()]
    for path, shape, (n_fwd, n_dgrad) in tables:
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
                path=path, shape=tag, per_step=n, max_abs_err=err, rel_err=rel,
                ms=time_ms(torch, lambda: cv.conv3x3_nhwc(inp, filt)),
                plain_ms=time_ms(torch, lambda: cv.conv3x3_plain(inp, filt), iters=3, warmup=1),
                library_ms=time_ms(torch, lambda: F.conv2d(inp_nchw, lib_w, padding=1)),
                bound_ms=t, bound_by=by))

    gn_tables = [("sd15", sh, n) for sh, n in GN_CONV_SHAPES.items()] + \
                [("vae_gan", sh, n) for sh, n in VAE_GN_CONV_SHAPES.items()] + \
                [("sdxl", sh, n) for sh, n in SDXL_GN_CONV_SHAPES.items()]
    for path, shape, n in gn_tables:
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
            path=path, shape=tag, per_step=n, max_abs_err=err, rel_err=rel,
            ms=time_ms(torch, lambda: cv.gn_silu_conv3x3_nhwc(x, a, bb, w_k)),
            plain_ms=time_ms(torch, lambda: cv.gn_silu_conv3x3_plain(x, a, bb, w_k), iters=3, warmup=1),
            library_ms=None, bound_ms=t, bound_by=by))
        del x, dy, w, w_k, got, want
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: engines
# ---------------------------------------------------------------------------


def make_engine(torch, device, seed: int, unet: dict, clip: dict, use_ema: bool = True, vae: dict = None,
                bigg: dict = None, size_outdim: int = 256, unet_fp32: bool = False):
    """DiffusionEngine with the SD configs' classes: bf16 UNet with fp32
    parameters (``unet_fp32``: computing in fp32, a config without a
    precision key), fp32 frozen embedders, DiscreteDenoiser with
    EpsPreconditioning over LegacyDDPM, DiscreteSigmaGenerator, EpsWeighting,
    Adafactor(scale_parameter, relative_step, warmup_init); with ``vae`` (a
    ddconfig) a frozen fp32 AutoencoderKL encodes images in front, else the
    batch carries latents. Without ``bigg`` the conditioner is SD1.5's (CLIP-L
    ``layer: last``, scale factor 0.18215); with it SDXL's five embedders
    (CLIP-L hidden layer 11 or the tower's last if it is shallower, OpenCLIP
    penultimate + pooled, three size embedders; scale factor 0.13025)."""
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import EpsWeighting
    from neurosis_tpu_torch.models.autoencoder import AutoencoderKL
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.modules.encoders.embedding import (
        ConcatTimestepEmbedderND,
        FrozenCLIPEmbedder,
        FrozenOpenCLIPEmbedder2,
        GeneralConditioner,
    )
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor
    from neurosis_tpu_torch.trainer.engine import DiffusionEngine

    g = torch.Generator(device).manual_seed(seed)
    model = UNetModel(**unet, use_checkpoint=True, dtype=None if unet_fp32 else torch.bfloat16, device=device,
                      generator=g)
    if bigg is None:
        embedders = [FrozenCLIPEmbedder(**clip, device=device, generator=g)]
    else:
        embedders = [FrozenCLIPEmbedder(layer="hidden", layer_idx=min(11, clip["layers"] - 1), **clip, device=device,
                                        generator=g),
                     FrozenOpenCLIPEmbedder2(layer="penultimate", always_return_pooled=True, legacy=False, **bigg,
                                             device=device, generator=g)]
        embedders += [ConcatTimestepEmbedderND(outdim=size_outdim, input_key=key) for key in SIZE_KEYS]
    first_stage = None if vae is None else AutoencoderKL(vae, embed_dim=4, device=device, generator=g)
    disc = LegacyDDPMDiscretization()
    return DiffusionEngine(
        model=model,
        first_stage=first_stage,
        scale_factor=0.18215 if bigg is None else 0.13025,
        denoiser=DiscreteDenoiser(EpsPreconditioning(), 1000, disc, device=device),
        loss_fn=StandardDiffusionLoss(DiscreteSigmaGenerator(disc, 1000, device=device), EpsWeighting()),
        conditioner=GeneralConditioner(embedders),
        optimizer=lambda params: Adafactor(params, scale_parameter=True, relative_step=True, warmup_init=True),
        use_ema=use_ema,
        device=device,
    )


SIZE_KEYS = ("original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple")


def make_batch(torch, device, batch: int, side: int, seed: int, images: bool = False, sizes: bool = False) -> dict:
    """Token ids and either latents (side x side x 4) or uint8 images
    (side x side x 3), from a seed; with ``sizes`` SDXL's three size
    conditionings (original size, crop offset, target size) as float [B, 2]."""
    g = torch.Generator("cpu").manual_seed(seed)
    ids = torch.randint(1, 49406, (batch, 77), generator=g)
    ids[:, 0] = 49406  # BOS
    eos = torch.randint(4, 77, (batch,), generator=g)
    for i in range(batch):
        ids[i, eos[i]:] = 49407  # EOS, then padding with the EOS id
    out = {"caption_ids": ids.to(device)}
    if sizes:
        px = side if images else side * 8
        out["original_size_as_tuple"] = torch.randint(px, 2 * px, (batch, 2), generator=g).float().to(device)
        out["crop_coords_top_left"] = torch.randint(0, px // 4, (batch, 2), generator=g).float().to(device)
        out["target_size_as_tuple"] = torch.full((batch, 2), float(px), device=device)
    if images:
        out["image"] = make_images(torch, device, batch, side, g)
    else:
        out["latents"] = torch.randn(batch, side, side, 4, generator=g).to(device)
    return out


def make_images(torch, device, batch: int, side: int, g) -> "torch.Tensor":
    """uint8 NHWC images: smooth random fields (as photos are smoother than
    noise) with some pixel noise, drawn from ``g``."""
    import torch.nn.functional as F

    coarse = torch.rand(batch, 3, max(side // 32, 2), max(side // 32, 2), generator=g)
    img = F.interpolate(coarse, size=(side, side), mode="bilinear", align_corners=False)
    img = (img + 0.05 * torch.randn(batch, 3, side, side, generator=g)).clamp(0, 1)
    return (img * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous().to(device)


SMALL_UNET = dict(in_channels=4, model_channels=128, out_channels=4, num_res_blocks=1,
                  attention_resolutions=[1], channel_mult=[1, 1], num_heads=2, context_dim=64)
SMALL_CLIP = dict(width=64, layers=2, heads=2)
# SDXL's layout at small widths: 64-channel heads, linear projections, per-level
# depth, the label embedding of 64 pooled + 3 x 2 x 32 size features
SMALL_SDXL_UNET = dict(in_channels=4, model_channels=128, out_channels=4, num_res_blocks=1,
                       attention_resolutions=[1], channel_mult=[1, 1], num_head_channels=64,
                       transformer_depth=[1, 2], context_dim=128, use_linear_in_transformer=True,
                       num_classes="sequential", adm_in_channels=64 + 3 * 2 * 32)
SMALL_BIGG = dict(width=64, layers=2, heads=2)


def reference_step(torch, log: list, sdxl: bool = False) -> dict:
    """One train step of a small engine on the card against the same step on
    the CPU. At 32x32 latents with 128 channels and 2 heads of 64 every
    kernel takes part: flash (S=1024 self, kv=77 cross), conv3x3 (upsample
    conv, dgrad), gn_silu_conv3x3 (ResBlock pairs). With ``sdxl`` the engine
    has SDXL's layout: two text towers, the size embedders and the UNet's
    label embedding of the vector conditioning."""
    from neurosis_tpu_torch import ops

    label = "small SDXL engine" if sdxl else "small engine"
    engines, metrics = {}, {}
    for device in ("cpu", "cuda"):
        if sdxl:
            eng = make_engine(torch, device, 1, SMALL_SDXL_UNET, SMALL_CLIP, use_ema=False, bigg=SMALL_BIGG,
                              size_outdim=32)
        else:
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
    batch = make_batch(torch, "cpu", 2, 32, 3, sizes=sdxl)
    t = torch.tensor([0.3, 0.8])
    noise = torch.randn(batch["latents"].shape, generator=torch.Generator("cpu").manual_seed(4))
    counts_before = ops.launch_counts()
    for device, eng in engines.items():
        state = eng.init(seed=0)
        b = {k: v.to(device) for k, v in batch.items()}
        if sdxl:
            cond = eng.conditioner(b)
            want = {"crossattn": (2, 77, 128), "vector": (2, SMALL_SDXL_UNET["adm_in_channels"])}
            if {k: tuple(v.shape) for k, v in cond.items()} != want:
                raise PhaseError(f"{label}: conditioning {({k: tuple(v.shape) for k, v in cond.items()})}, not {want}")
        _, m = eng.train_step(state, b, t=t.to(device), noise=noise.to(device))
        metrics[device] = {k: float(v) for k, v in m.items()}
    launched = {k: ops.launch_counts()[k] - counts_before[k] for k in counts_before}
    print(f"{label} step launches: {launched}", flush=True)
    missing = [k for k in ("flash_fwd", "flash_bwd", "conv3x3", "gn_silu_conv3x3") if not launched[k]]
    if missing:
        raise PhaseError(f"the {label} did not launch {missing}: {launched}")
    for key, tol in (("loss", 2e-2), ("grad_norm", 5e-2)):
        cpu, gpu = metrics["cpu"][key], metrics["cuda"][key]
        check(f"{label} {key}: cuda {gpu:.6g} vs cpu {cpu:.6g}", abs(gpu - cpu) / abs(cpu), tol, log)
    return metrics


# A small VAE whose every level takes the kernels: 64x64 at 128 channels (fused
# convs, dgrads), 32x32 at 512 (fused convs, the decoder's upsample conv into
# 64x64) and the mid attention over 1024 tokens at head dim 512.
SMALL_VAE = dict(ch=128, ch_mult=[1, 4], num_res_blocks=1, attn_resolutions=[], resolution=64, z_channels=4,
                 dropout=0.0)
SMALL_LOSS = dict(perceptual_weight=1.0, lpips_type="alex", disc_start=1, disc_weight=0.5, disc_n_layers=1)
# configs/smoke/vae-tiny.yaml as written (fp32, 64 px, batch 2): the mid attention
# over 1024 tokens at head dim 64
TINY_VAE = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], resolution=64, z_channels=2,
                dropout=0.0)
TINY_LOSS = dict(perceptual_weight=0.1, disc_start=1, disc_n_layers=1)


def make_vae_engine(torch, device, seed: int, dd: dict, loss_cfg: dict, lr: float = 4.5e-6, fp32: bool = False):
    """AutoencodingEngine as configs/vae/vae.example.yaml builds it: Encoder
    and Decoder computing in bf16 (precision: bf16-mixed) or, with ``fp32``,
    in fp32 (the file as written, without a precision key),
    AutoencoderLPIPSWithDiscr (l1, hinge, fp32 LPIPS and PatchGAN), kl_weight
    1e-6, AdamW with optax's defaults for both optimizers, disc_start from
    ``loss_cfg``."""
    from neurosis_tpu_torch.losses.vae_loss import AutoencoderLPIPSWithDiscr
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.optimizers.adamw import adamw
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    g = torch.Generator(device).manual_seed(seed)
    dtype = None if fp32 else torch.bfloat16
    enc = Encoder(**dd, double_z=True, in_channels=3, dtype=dtype, device=device, generator=g)
    dec = Decoder(**dd, out_ch=3, dtype=dtype, device=device, generator=g)
    loss = AutoencoderLPIPSWithDiscr(recon_type="l1", disc_loss="hinge", **loss_cfg, device=device, generator=g)
    return AutoencodingEngine(enc, dec, loss, g_optimizer=lambda ps: adamw(ps, lr),
                              d_optimizer=lambda ps: adamw(ps, lr), kl_weight=1e-6,
                              disc_start=loss_cfg["disc_start"], device=device)


def reference_vae_pair(torch, log: list, fp32: bool = False, tiny: bool = False) -> dict:
    """One generator and one discriminator step of a small VAE-GAN on the
    card against the same steps on the CPU, from the same weights and
    posterior noise; the discriminator step runs with the gate open. In bf16
    every bf16 kernel case of the VAE takes part: flash at d=512 forward and
    backward, fused and plain 3x3 convs, their dgrads. With ``fp32`` the
    convs go to the library and the mid attention to the fp32 flash forward
    (4 launches) and backward (2), at head dim 512, or with ``tiny`` at
    configs/smoke/vae-tiny.yaml's dims, at head dim 64."""
    from neurosis_tpu_torch import ops

    label = "small fp32 VAE-GAN" if fp32 else "small VAE-GAN"
    dd, loss_cfg = (TINY_VAE, TINY_LOSS) if tiny else (SMALL_VAE, SMALL_LOSS)
    if tiny:
        label += " at vae-tiny's dims"
    engines = {dev: make_vae_engine(torch, dev, 3, dd, loss_cfg, lr=1e-4, fp32=fp32) for dev in ("cpu", "cuda")}
    g = torch.Generator("cpu").manual_seed(4)
    with torch.no_grad():
        for name in ("encoder", "decoder", "loss"):
            src, dst = getattr(engines["cpu"], name), getattr(engines["cuda"], name)
            for p_cpu in src.parameters():
                p_cpu.add_(0.01 * torch.randn(p_cpu.shape, generator=g))
            dst.load_state_dict(src.state_dict())
    images = make_images(torch, "cpu", 2, 64, torch.Generator("cpu").manual_seed(5))
    eps = torch.randn(2, 32, 32, dd["z_channels"], generator=torch.Generator("cpu").manual_seed(6))
    metrics = {}
    counts_before = ops.launch_counts()
    for dev, eng in engines.items():
        state = eng.init(seed=0)
        batch = {"image": images.to(dev)}
        state, g_log = eng.g_step(state, batch, posterior_noise=eps.to(dev))
        g_norm = float(torch.stack([p.grad.float().norm() for p in eng.g_parameters()]).norm())
        state, d_log = eng.d_step(state, batch, posterior_noise=eps.to(dev))
        d_norm = float(torch.stack([p.grad.float().norm() for p in eng.d_parameters()]).norm())
        metrics[dev] = dict(g_total=float(g_log["total"]), g_rec=float(g_log["train/loss/rec"]),
                            g_p=float(g_log["train/loss/p"]), g_grad_norm=g_norm, d_total=float(d_log["total"]),
                            d_grad_norm=d_norm)
    launched = {k: ops.launch_counts()[k] - counts_before[k] for k in counts_before}
    print(f"reference {label} pair launches: {launched}", flush=True)
    if fp32:
        want = dict.fromkeys(launched, 0) | {"flash_fwd_f32": 4, "flash_bwd_f32": 2}
        if launched != want:
            raise PhaseError(f"the {label} launched {launched}, not {want}")
        # fp32 on both sides with TF32 off: sums in another order (cuDNN and
        # cuBLAS against the CPU's) through ~60 layers; the grad norms also
        # feel the few LeakyReLU and hinge kinks that this noise flips
        tols = (("g_total", 1e-3), ("g_rec", 1e-3), ("g_p", 1e-3), ("g_grad_norm", 1e-2), ("d_total", 1e-3),
                ("d_grad_norm", 1e-2))
    else:
        missing = [k for k in ("flash_fwd", "flash_bwd", "conv3x3", "gn_silu_conv3x3") if not launched[k]]
        if missing:
            raise PhaseError(f"the {label} did not launch {missing}: {launched}")
        # bf16 encoder and decoder: the kernels round where the plain versions
        # do, sums run in another order
        tols = (("g_total", 2e-2), ("g_rec", 2e-2), ("g_p", 2e-2), ("g_grad_norm", 5e-2), ("d_total", 2e-2),
                ("d_grad_norm", 5e-2))
    for key, tol in tols:
        cpu, gpu = metrics["cpu"][key], metrics["cuda"][key]
        check(f"{label} {key}: cuda {gpu:.6g} vs cpu {cpu:.6g}", abs(gpu - cpu) / abs(cpu), tol, log)
    return metrics


def reference_encode(torch, log: list) -> dict:
    """The frozen fp32 encode of a small SD engine's first stage on the card
    against the CPU: the fp32 flash forward at d=512 over 1024 tokens."""
    from neurosis_tpu_torch import ops
    from neurosis_tpu_torch.models.autoencoder import AutoencoderKL
    from neurosis_tpu_torch.ops.dequant import dequant_image

    dd = dict(SMALL_VAE, double_z=True, in_channels=3, out_ch=3)
    vaes = {dev: AutoencoderKL(dd, embed_dim=4, device=dev, generator=torch.Generator(dev).manual_seed(7))
            for dev in ("cpu", "cuda")}
    vaes["cuda"].load_state_dict(vaes["cpu"].state_dict())
    images = make_images(torch, "cpu", 2, 64, torch.Generator("cpu").manual_seed(8))
    x = dequant_image(images)
    before = ops.launch_counts()["flash_fwd_f32"]
    with torch.no_grad():
        want = vaes["cpu"].encode(x)
        got = vaes["cuda"].encode(x.cuda()).cpu()
    launched = ops.launch_counts()["flash_fwd_f32"] - before
    if launched != 1:
        raise PhaseError(f"the small fp32 encode launched flash_fwd_f32 {launched} times, not once")
    err, rel = rel_err(got, want)
    # fp32 on both sides with TF32 off: sums in another order through ~20 layers
    check("small fp32 encode moments", rel, 1e-4, log, err)
    return dict(max_abs_err=err, rel_err=rel)


SD15_UNET = dict(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
                 attention_resolutions=[4, 2, 1], channel_mult=[1, 2, 4, 4], num_heads=8,
                 transformer_depth=1, context_dim=768)
SD15_CLIP = dict(width=768, layers=12, heads=12)


# the SD1.5 config's first stage (configs/sd15/sd15.example.yaml), fp32
SD15_VAE = dict(ch=128, ch_mult=[1, 2, 4, 4], num_res_blocks=2, attn_resolutions=[], resolution=256, z_channels=4,
                double_z=True, in_channels=3, out_ch=3, dropout=0.0)
# configs/vae/vae.example.yaml at bench.py's on-chip setting: 256 px, batch 8,
# bf16 encoder and decoder; disc_start lowered to 1 so both steps run
VAE_GAN_DD = dict(ch=128, ch_mult=[1, 2, 4, 4], num_res_blocks=2, attn_resolutions=[], resolution=256,
                  z_channels=4, dropout=0.0)
VAE_GAN_LOSS = dict(perceptual_weight=1.0, lpips_type="alex", disc_start=1, disc_factor=1.0, disc_weight=0.5,
                    disc_n_layers=3)


# configs/sdxl/sdxl.example.yaml: UNet, first stage (the SD VAE's ddconfig, scale factor 0.13025) and towers
SDXL_UNET = dict(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2, attention_resolutions=[4, 2],
                 channel_mult=[1, 2, 4], num_head_channels=64, transformer_depth=[1, 2, 10], context_dim=2048,
                 use_linear_in_transformer=True, num_classes="sequential", adm_in_channels=2816)
SDXL_BIGG = dict(width=1280, layers=32, heads=20)


def step_totals(rows: dict, path: str) -> dict:
    """Per kernel, from one path's shape tables and phase 3's times: launches
    per step (or pair) of that path, their summed time and summed bound."""
    out = {}
    for name, rs in rows.items():
        rs = [r for r in rs if r["path"] == path]
        out[name] = dict(launches=sum(r["per_step"] for r in rs), ms=sum(r["per_step"] * r["ms"] for r in rs),
                         bound_ms=sum(r["per_step"] * r["bound_ms"] for r in rs))
    return out


def check_launches(launches: dict, totals: dict, units: int, label: str) -> None:
    """Each kernel the path's tables list was launched, and every counter
    equals units x the tables' count (0 for a kernel the path does not run)."""
    print(f"{label} launches: {launches}", flush=True)
    missing = [k for k, t in totals.items() if t["launches"] and not launches[k]]
    if missing:
        raise PhaseError(f"{label} never launched {missing}")
    for name, tot in totals.items():
        print(f"{name} per {label} unit: {tot['launches']} launches, {tot['ms']:.3f} ms at the phase-3 times, "
              f"bound {tot['bound_ms']:.3f} ms", flush=True)
    unlisted = {k: n for k, n in launches.items() if n != units * totals[k]["launches"]}
    if unlisted:
        raise PhaseError(f"{label} launches {unlisted} differ from the shape tables' counts x {units}")


def run_slice(torch, rows: dict, path: str = "sd15", steps: int = 3) -> dict:
    """A DiffusionEngine at full width from uint8 images: SD1.5 (512 px, batch
    4, EMA, bf16 UNet), SD1.5 as configs/sd15/sd15.example.yaml is written
    (``sd15_f32``: 256 px, batch 1, no EMA, fp32 UNet) or SDXL (1024 px, batch
    2, no EMA; one warm step first). ``steps`` timed steps with the counters
    read around them, a profiled step, the frozen encode profiled alone and,
    for SDXL, each text tower too."""
    from neurosis_tpu_torch import ops

    sdxl = path == "sdxl"
    label = {"sd15": "SD1.5", "sd15_f32": "SD1.5 fp32", "sdxl": "SDXL"}[path]
    batch_size, side = {"sd15": (4, 512), "sd15_f32": (1, 256), "sdxl": (2, 1024)}[path]
    t0 = time.perf_counter()
    if sdxl:
        engine = make_engine(torch, "cuda", 0, SDXL_UNET, SD15_CLIP, use_ema=False, vae=SD15_VAE, bigg=SDXL_BIGG)
    elif path == "sd15_f32":
        engine = make_engine(torch, "cuda", 0, SD15_UNET, SD15_CLIP, use_ema=False, vae=SD15_VAE, unet_fp32=True)
    else:
        engine = make_engine(torch, "cuda", 0, SD15_UNET, SD15_CLIP, vae=SD15_VAE)
    n_unet = sum(p.numel() for p in engine.model.parameters())
    n_cond = [sum(p.numel() for p in e.parameters()) for e in engine.conditioner.embedders]
    n_vae = sum(p.numel() for p in engine.first_stage.parameters())
    state = engine.init(seed=0)
    batch = make_batch(torch, "cuda", batch_size, side, 5, images=True, sizes=sdxl)
    torch.cuda.synchronize()
    print(f"{label} engine built in {time.perf_counter() - t0:.1f} s: UNet {n_unet} params, "
          f"embedders {n_cond} params (frozen, fp32), VAE {n_vae} params (frozen, fp32)", flush=True)
    if sdxl:
        cond = engine.conditioner(batch)
        shapes = {k: tuple(v.shape) for k, v in cond.items()}
        if shapes != {"crossattn": (2, 77, 2048), "vector": (2, 2816)}:
            raise PhaseError(f"SDXL conditioning has shapes {shapes}")
        del cond
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = engine.train_step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        print(f"{label} warm train_step: loss {loss:.6f} {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

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
        print(f"{label} train_step {i}: loss {loss:.6f} grad_norm {grad_norm:.6f} {ms:.1f} ms", flush=True)
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            raise PhaseError(f"{label} step {i} is not finite: loss {loss}, grad_norm {grad_norm}")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)
    totals = step_totals(rows, path)
    check_launches(launches, totals, steps, f"{label} step")
    if state.ema is not None and not all(bool(torch.isfinite(s).all()) for s in state.ema.params):
        raise PhaseError("EMA shadows are not finite")
    latents = engine.encode_first_stage(batch["image"], state.generator)
    want = (batch_size, side // 8, side // 8, 4)
    if tuple(latents.shape) != want or not bool(torch.isfinite(latents).all()):
        raise PhaseError(f"the frozen encode gave {tuple(latents.shape)} latents, not {want}, finite: "
                         f"{bool(torch.isfinite(latents).all())}")
    print(f"{label} frozen encode: latents {tuple(latents.shape)}, std {float(latents.std()):.4f}", flush=True)
    del latents
    step_ms = statistics.median(r["ms"] for r in (step_rows if sdxl else step_rows[1:]))
    profile = profile_fn(torch, lambda: engine.train_step(state, batch), f"{label} step", step_ms)
    encode = profile_fn(torch, lambda: engine.encode_first_stage(batch["image"], state.generator),
                        f"{label} frozen encode", None)
    if profile.get("device_ms") is not None and encode.get("device_ms") is not None:
        print(f"profile: {label} step without the frozen encode: {profile['device_ms'] - encode['device_ms']:.3f} ms "
              f"device busy", flush=True)
    out = dict(steps=step_rows, launches=launches, per_step=totals, peak_bytes=peak, unet_params=n_unet,
               embedder_params=n_cond, vae_params=n_vae, profile=profile, encode_profile=encode)
    if sdxl:
        with torch.no_grad():
            ids = batch["caption_ids"]
            out["clip_l_profile"] = profile_fn(torch, lambda: engine.conditioner.embedders[0](ids), "SDXL CLIP-L tower",
                                               None, top=5)
            out["bigg_profile"] = profile_fn(torch, lambda: engine.conditioner.embedders[1](ids),
                                             "SDXL OpenCLIP bigG tower", None, top=5)
    return out


def run_vae_gan(torch, rows: dict, path: str = "vae_gan", pairs: int = 3) -> dict:
    """The VAE-GAN trainer at full width, with a bf16 encoder and decoder
    (``vae_gan``) or in fp32 (``vae_gan_f32``). One warm pair, then ``pairs``
    timed generator/discriminator pairs with the counters read around them,
    then one profiled pair."""
    from neurosis_tpu_torch import ops

    fp32 = path == "vae_gan_f32"
    name = "fp32 VAE-GAN" if fp32 else "VAE-GAN"
    t0 = time.perf_counter()
    engine = make_vae_engine(torch, "cuda", 0, VAE_GAN_DD, VAE_GAN_LOSS, fp32=fp32)
    n_g = sum(p.numel() for p in engine.g_parameters())
    n_d = sum(p.numel() for p in engine.d_parameters())
    state = engine.init(seed=0)
    g = torch.Generator("cpu").manual_seed(9)
    batches = [{"image": make_images(torch, "cuda", 8, 256, g)} for _ in range(2 * pairs + 4)]
    torch.cuda.synchronize()
    print(f"{name} engine built in {time.perf_counter() - t0:.1f} s: encoder+decoder {n_g} params "
          f"({'fp32' if fp32 else 'bf16'} compute), "
          f"discriminator {n_d} params", flush=True)

    def step(i: int):
        idx = engine.train_step_schedule(i, state.step)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        _, log = (engine.g_step if idx == 0 else engine.d_step)(state, batches[i])
        total = float(log["total"])
        torch.cuda.synchronize()
        return idx, total, (time.perf_counter() - t_start) * 1e3, {k: float(v) for k, v in log.items()}

    rows_out = []
    for i in range(2):  # warm pair: generator (gate closed), discriminator
        idx, total, ms, log = step(i)
        rows_out.append(dict(step=i, kind="gd"[idx], total=total, ms=ms, warm=True))
        print(f"{name} warm {'gd'[idx]}_step {i}: total {total:.6f} {ms:.1f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i in range(2, 2 + 2 * pairs):
        idx, total, ms, log = step(i)
        rows_out.append(dict(step=i, kind="gd"[idx], total=total, ms=ms, log=log))
        detail = (f"rec {log['train/loss/rec']:.5f} p {log['train/loss/p']:.5f} g {log['train/loss/g']:.5f} "
                  f"kl {log['train/loss/kl']:.2f}") if idx == 0 else \
                 f"real {log['train/logits/real']:.5f} fake {log['train/logits/fake']:.5f}"
        print(f"{name} {'gd'[idx]}_step {i}: total {total:.6f} ({detail}) {ms:.1f} ms", flush=True)
        if not all(math.isfinite(v) for v in log.values()):
            raise PhaseError(f"{name} step {i} is not finite: {log}")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    kinds = [r["kind"] for r in rows_out if not r.get("warm")]
    if kinds != ["g", "d"] * pairs:
        raise PhaseError(f"the schedule ran {kinds}, not {pairs} alternating pairs")
    totals = step_totals(rows, path)
    check_launches(launches, totals, pairs, f"{name} pair")
    g_ms = statistics.median(r["ms"] for r in rows_out if r["kind"] == "g" and not r.get("warm"))
    d_ms = statistics.median(r["ms"] for r in rows_out if r["kind"] == "d" and not r.get("warm"))
    print(f"{name}: G step {g_ms:.3f} ms, D step {d_ms:.3f} ms (median of {pairs}), "
          f"{2 * 8 / (g_ms + d_ms) * 1e3:.2f} images/s over a pair; peak device memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB)", flush=True)
    i0 = 2 + 2 * pairs
    profile = profile_fn(torch, lambda: (step(i0), step(i0 + 1)), f"{name} pair", g_ms + d_ms)
    return dict(steps=rows_out, launches=launches, per_pair=totals, g_ms=g_ms, d_ms=d_ms, peak_bytes=peak,
                g_params=n_g, d_params=n_d, profile=profile)


def run_overlap(torch, rows: dict, log: list) -> dict:
    """Path C: the flash-overlap tool as a user runs it
    (python -m neurosis_tpu_torch.tools.overlap_bench), its lines passed on,
    with the launch counts read around it."""
    import contextlib
    import io

    from neurosis_tpu_torch import ops
    from neurosis_tpu_torch.tools import overlap_bench

    ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = overlap_bench.main()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    for line in lines:
        print(f"overlap tool: {json.dumps(line, ensure_ascii=False)}", flush=True)
    cases = [line for line in lines if "case" in line]
    if rc != 0 or "check_maxabs_l2" not in lines[0] or len(cases) != len(overlap_bench.CASES):
        raise PhaseError(f"the overlap tool returned {rc} and printed {len(lines)} lines")
    # base against split2 on bf16 outputs of size ~1: each is within a rounding step of the true value
    check("overlap tool check_maxabs_l2 (abs)", lines[0]["check_maxabs_l2"], 2e-2, log)
    if not all(math.isfinite(c["tf_s"]) and c["tf_s"] > 0 for c in cases):
        raise PhaseError(f"the overlap tool's rates are not finite and positive: {cases}")
    check_launches(launches, step_totals(rows, "overlap"), 1, "overlap tool run")
    return dict(lines=lines, launches=launches)


def kernel_kind(name: str) -> str:
    """Which layer a device kernel belongs to, by its name."""
    low = name.lower()
    if "flash_" in low or "conv3x3_wgmma" in low:
        return "port kernels"
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn")):
        return "library conv"
    if any(s in low for s in ("gemm", "nvjet", "cublas", "cutlass")):
        return "library matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, norms, reductions, optimizer)"


def profile_fn(torch, fn, label: str, step_ms, top: int = 15) -> dict:
    """``fn`` once under torch.profiler: device time by kernel and by kind,
    and (given the median unprofiled ``step_ms``) the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
        print(f"profile {label}: the profiler recorded no device kernels: device time not measured", flush=True)
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
    share = "" if step_ms is None else f"; median unprofiled {step_ms:.3f} ms, busy share {device_ms / step_ms:.4f}"
    print(f"profile {label}: device busy {device_ms:.3f} ms{share}", flush=True)
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}: {kind}: {ms:.3f} ms", flush=True)
    for ms, n, name in rows[:top]:
        print(f"profile {label}: {ms:9.3f} ms {n:6d} x {name[:100]}", flush=True)
    return dict(device_ms=device_ms, step_ms=step_ms, busy_share=None if step_ms is None else device_ms / step_ms,
                kinds_ms=kinds, launches=sum(n for _, n, _ in rows),
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

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    report: dict = {"card": smi, "paths": {path: unit for path, (_key, unit) in PATHS.items()}}
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

        rows = {**check_flash(torch, log), **check_overlap(torch, log), **check_conv(torch, log)}
        report["kernel_rows"] = rows
        for name, rs in rows.items():
            for r in rs:
                lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
                print(f"{name} {r['shape']} ({r['path']}): {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                      f"library {lib} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)

        report["reference"] = reference_step(torch, log)
        report["reference_sdxl"] = reference_step(torch, log, sdxl=True)
        report["reference_vae_gan"] = reference_vae_pair(torch, log)
        report["reference_vae_gan_f32"] = reference_vae_pair(torch, log, fp32=True)
        report["reference_vae_tiny"] = reference_vae_pair(torch, log, fp32=True, tiny=True)
        report["reference_encode"] = reference_encode(torch, log)
        report["slice"] = run_slice(torch, rows)
        torch.cuda.empty_cache()
        report["sd15_f32"] = run_slice(torch, rows, "sd15_f32")
        torch.cuda.empty_cache()
        report["vae_gan"] = run_vae_gan(torch, rows)
        torch.cuda.empty_cache()
        report["vae_gan_f32"] = run_vae_gan(torch, rows, "vae_gan_f32")
        torch.cuda.empty_cache()
        report["sdxl"] = run_slice(torch, rows, "sdxl")
        torch.cuda.empty_cache()
        report["overlap"] = run_overlap(torch, rows, log)
        report["seconds"] = time.perf_counter() - t_start
        print(f"all phases: {report['seconds']:.1f} s", flush=True)
    except Exception as e:  # any failed phase ends the run without a result line
        report["error"] = repr(e)
        _write(report, log)
        print(f"FAILED: {e!r}", file=sys.stderr, flush=True)
        raise

    _write(report, log)
    kernels = []
    for name, meta in KERNELS.items():
        # the shape that costs its path most, among the paths driven here
        head = max((r for r in rows[name] if r["path"] in PATHS), key=lambda r: r["per_step"] * r["ms"])
        by_path = {path: report[key]["launches"][name] for path, (key, _unit) in PATHS.items()}
        kernels.append(dict(name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
                            launches=sum(by_path.values()), launches_by_path=by_path,
                            max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"],
                            bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=head["library_ms"],
                            shape=head["shape"], path=head["path"]))
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
