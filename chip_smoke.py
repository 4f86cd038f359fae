#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neurosis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

These paths run at full width: the SD1.5 train step from images (the frozen
fp32 VAE encode in front of the UNet step) with a bf16 UNet and with the fp32
UNet of configs/sd15/sd15.example.yaml as written, the VAE-GAN trainer
(alternating generator and discriminator steps) with a bf16 and with an fp32
encoder and decoder, the SDXL train step from 1024 px images, SDXL CFG
sampling at 1024 px and its fp32 decode, the flash-overlap tool, and the
entry point: python -m neurosis_tpu_torch fit on
configs/sdxl/sdxl.example.yaml as written, on its bf16-mixed copy (also with
an image logger) and on configs/vae/vae.example.yaml (also with an image
logger), and python -m neurosis_tpu_torch predict on sdxl.example.yaml, and
a training run of configs/sdxl/sdxl-te.example.yaml as written (fp32 UNet,
both text towers trainable, 8-bit AdamW, the legacy cosine schedule) that
saves a checkpoint and is resumed from it, and the SD training path's
options (objectives, remat policies, caption dropout, loss hooks), the
VAE-GAN stack's VQ autoencoders with the optimizers left, training on
the (data, fsdp) mesh through tools/launch_pod at one NCCL rank, the ring
on the context axis, the DreamSim VAE fit (vae.example.yaml with the
AutoencoderDreamsim loss) with trainer.profiler:, and fits from the Mongo
datasets with checkpoints in a blob store and a resume from it.

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
     the launch counts read around them;
 11. cli: in chiprun_out/cli/, an image folder of 8 seeded PNGs (written by
     neurosis_tpu_torch/data/png.py, sizes in WDXLBucketList's 1024x1024
     bucket) with tag captions, then the CLI's main() in this process, the
     launch counts read around each run: fit of sdxl.example.yaml as written
     (fp32 UNet, one step, fast_dev_run, the hash tokenizer, no checkpoint)
     under torch.profiler; fit of its copy with precision bf16-mixed,
     fast_dev_run false and max_steps 4 (phase 9's launches x 4), and of the
     same copy for 2 steps, the second under torch.profiler; fit of vae.example.yaml as
     written (fp32, one generator step). Each run's losses are finite, its
     metrics.jsonl has a line a step with the host step and data ms;
 12. sample (right after phase 9, on its engine): first a small SDXL-layout
     engine samples 4 CFG steps on the card and on the CPU from one noise
     tensor (latents within 2e-2 of their largest value, bf16 UNet) and its
     fp32 decode of the same latents agrees within 1e-3; then bench.py's
     sample mode on the port: EulerEDMSampler, 30 steps, VanillaCFG(7), 1 and
     4 images of 1024 px, each a warm call, a timed call (seconds an image,
     images a minute; launches per UNet call held to sdxl_unet_call), the
     fp32 decode timed, one sampler step profiled inside the span
     neurosis/sample_step, the whole call and the decode profiled (busy
     share), peak memory;
 13. cli sampling, in chiprun_out/cli/ after phase 11: predict of
     sdxl.example.yaml as written (fp32 UNet, CFG 7.5) with
     trainer.allow_random_weights added, two prompts, 4 steps, 1024 px; fit
     of the bf16-mixed copy for 2 steps with an image_logger: node (every 2
     steps and the first, 2 images, 4 sampler steps); fit of
     vae.example.yaml with one, 1 step. The image logger's launches are read
     apart from the steps' and held to their own tables, each PNG is read
     back (names, sizes, not flat), every decode and reconstruction finite;
 14. a run that lasts, in chiprun_out/cli/ after phase 13: fit of a copy of
     sdxl-te.example.yaml with fast_dev_run false, max_steps 3 and a
     model_checkpoint: node (every 2 steps, keep 1), its third step
     profiled (device time, kernels by kind), the save at step 2 timed
     (bytes, seconds, free disk); fit of the copy with max_steps 4 in the
     same projects/, which resumes: the restored parameters' checksum is the
     saved file's, the optimizer's count 2, each param group's lr its base x
     sched(2), and it logs steps 3 and 4; one more 8-bit AdamW update timed
     and profiled alone; 8-bit AdamW on the card against the CPU at a bigG
     token embedding and a small leaf; each run's launches equal its steps
     x cli_sdxl_te's tables (those of cli_sdxl_f32). The run directory,
     with its checkpoint, is deleted afterwards;
 15. the training path's options, in chiprun_out/cli/ after phase 14 (its
     captions rewritten as tags the tag hook counts): one train step of a
     small engine of each objective (v over the tan zero-terminal-SNR table
     with min-SNR and noise offset under remat names/dots_names, EDM,
     rectified flow XL and comfy with L1, the UNet variants in fp32) on the
     card against the CPU, and the memory-saving GroupNorm against its plain
     version on the card; then, through the CLI, fit of a v-prediction copy
     of the bf16 SDXL config (3 steps, remat [none, none, dots_names],
     caption dropout, noise offset, min-SNR, the tag hook, Adafactor momentum
     and decay, an image logger at step 2; third step profiled), of the
     bf16 copy with only that remat policy (2 steps, the second profiled: the remat pair
     with phase 11's), and of EDM and rectified-flow copies of
     sd15.example.yaml (2 steps; the latter with an rf_safeguard logger),
     each run's launches held to its tables (REMAT_TABLES for the policy);
 16. the rest of the VAE-GAN stack and the optimizers left, in
     chiprun_out/cli/ after phase 15: small VQ (VQLPIPSWithDiscriminator,
     an ActNorm PatchGAN, the adaptive d_weight, EMA and eval_step), Gumbel
     and EMA-VQ engines in bf16, a linear-attention VAE with dropout in
     eval (fp32), and three steps of CAME, optax.adam (eps_root, nesterov)
     and optax.sgd (momentum), each on the card against the CPU; then,
     through the CLI, fit of a VQ-f8 copy of vae.example.yaml (CompVis's
     vq-f8 widths, attention at 32x32, a 16384-code VectorQuantizer,
     torch.optim.Adam, EMA; 256 px, batch 8, 16 PNGs it writes) for three
     G/D pairs in fp32 and in a bf16-mixed copy, each profiled (the third
     pair's device time by kind, busy share, peak), validate and test of
     the fp32 copy and of vae.example.yaml as written (2 batches each), all
     launches held to their tables, and an AEIntegerWrapper round trip;
 17. the mesh, in chiprun_out/cli/mesh/ after phase 16: each wrapped run a
     subprocess (chip_smoke.py --rank) of one NCCL rank that runs
     python -m neurosis_tpu_torch.tools.launch_pod's main: a copy of
     configs/sdxl/sdxl-tpu-v5e.yaml with devices 1, strategy fsdp, fsdp 1,
     no ckpt_path, batch 2 (FSDP2 over a 1 x 1 mesh), 3 steps, the third
     profiled, a checkpoint at step 2, against the same copy's one-card run
     within the bf16 gates (losses 2e-2, grad norms 5e-2); both step-2
     checkpoints laid out alike, and a one-card step 3 resumed from each;
     the fp32 vae.example.yaml G/D pair (disc_start 1) under strategy ddp
     resumed from a one-card save, against one card within 1e-3; with two
     cards, the copy at devices 2 as data 2 and as fsdp 2 against one rank,
     else the line that says tier-1's gloo tests hold them. The run
     directory, with two SDXL checkpoints, is deleted afterwards;
 18. the context axis: ring_self_attention over LocalRing(n) against the
     full-sequence flash kernel and the plain ring, FrozenCLIPT5Encoder at
     full width card vs CPU, the SDXL UNet wired for context_parallel;
 19. DreamSim, in chiprun_out/cli/: fit of vae.example.yaml with its loss:
     swapped for AutoencoderDreamsim (l1, weights 1.0, the dino/clip1/clip2
     ensemble, towers at 224 px) as written (fp32) and in a bf16-mixed
     copy, 3 steps each on phase 11's PNGs, the third profiled (device ms
     by kind, busy share, peak, launches); the bf16 copy for 4 steps with a
     trainer.profiler: node (skip_first 1, warmup 1, active 1,
     capture_depth 2): its run_000/trace.json holds device kernels, the
     summary's module rows hold the three towers and the VAE, every port
     kernel of the traced step sits under a VAE module, and the towers'
     share of the step's device time; the VAE at vae-tiny.yaml's dims with
     AutoencoderDreamsim, 2 generator steps card vs CPU in fp32 and bf16;
     at full width, batch 1, fp32 within 1e-3: one DreamSim distance,
     FrozenOpenCLIPImageEmbedder at ViT-H-14's widths and
     create_dinov2("dinov2_vitb14") at 224 px; the path's kernel rows of
     phase 3 printed again;
 20. Mongo and blob checkpoints, in chiprun_out/cli/: a Mongo metadata
     cache in the port's format for a fixed query, its rows phase 11's
     PNGs (fs_type file, path_prefix; no server, no pymongo), then (a) fit
     of the bf16-mixed SDXL copy from MongoAspectDataset (SDXLBucketList,
     batch 2) with ProgressCallback and SaveConfigCallback by their JAX
     class paths, 2 steps, the second profiled (device only): its batches
     equal the CPU's for the seed, each of one bucket, config.yaml reads
     back as the resolved config, pymongo never imported; (b) fit of
     vae.example.yaml from MongoVAEDataset (EMA on) for 3 steps, saving each
     to memory://phase20/vae (save_top_k 2), then a fit to step 4 with
     trainer.remote_checkpoint_url: the store holds steps 2-3, then 3-4, the
     resumed parameters, EMA shadows and step equal the saved ones bitwise;
     the checkpoint's bytes, serialize, write, wait and resume seconds.
Phases 11, 13, 14 and 20 (a) load batches in 2 spawned prefetch worker processes
(the CLI's default num_workers), which see no CUDA device.
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

# published H100 SXM peaks: dense bf16 and TF32 tensor-core rates, fp32 FFMA rate
# on the CUDA cores (each fp32 flash row's second bound, the same work without
# the tensor cores) and HBM3 bandwidth. The fp32 flash kernels form each fp32
# product as three TF32 products (split operands), so their peak is a third of
# the TF32 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
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
# fp32 rows no path of phases 5-10 drives, checked and timed at kernel level: the SDXL
# step's attention with the fp32 UNet of configs/sdxl/sdxl.example.yaml as
# written (the shapes and counts of SDXL_FLASH_SHAPES, head dim 64), the frozen
# encode of configs/smoke/sd15-tiny.yaml (ch 32 x [1, 2] at 64 px: 64 channels
# over 32x32) and configs/smoke/vae-tiny.yaml's training (the same mid attention
# at batch 2, forward in the encoder and decoder of both steps, backward in the
# generator step)
UNDRIVEN_F32_FLASH_SHAPES = {"sdxl_f32": SDXL_FLASH_SHAPES, "sd15_tiny": {(1, 1, 1024, 1024, 64): (1, 0)},
                             "vae_tiny": {(2, 1, 1024, 1024, 64): (4, 2)}}
# Phase 11 drives the first of them (its rows are phase 11's path,
# cli_sdxl_f32): a step of sdxl.example.yaml as written
# through the CLI is the fp32 UNet's attention plus its frozen encode. Its
# copy with precision bf16-mixed is phase 9's step (the SDXL_* tables). A
# generator step of vae.example.yaml as written (256 px, batch 2, fp32): the
# mid attention over 32x32 latents at d=512, forward in the encoder and the
# decoder, backward through both.
CLI_SDXL_F32_FLASH_SHAPES = {**UNDRIVEN_F32_FLASH_SHAPES["sdxl_f32"],
                             **{shape: (n, 0) for shape, n in SDXL_FLASH_F32_SHAPES.items()}}
CLI_VAE_F32_FLASH_SHAPES = {(2, 1, 1024, 1024, 512): (2, 2)}
# the image folder of phase 11: (width, height) of its PNGs, every aspect in
# WDXLBucketList's 1024x1024 bucket (ratios 0.90-1.11; that bucket takes
# (0.882, 1.133]) and every side >= 1024, so the cover resize and the crop run
# and the UNet sees phase 9's shapes
CLI_IMAGE_SIZES = [(1024, 1024), (1088, 1024), (1024, 1088), (1152, 1040), (1040, 1152), (1100, 1040),
                   (1280, 1216), (1216, 1280)]
CLI_DIR = Path("chiprun_out") / "cli"


# Sampling (phases 12-13): one call of the SDXL UNet at CFG's doubled batch n
# (two per image), forward only and without grad, so nothing is recomputed:
# each of the 70 transformer blocks' self and cross attention once (half a
# train step's forwards), the fused convs of SDXL_GN_CONV_SHAPES once each and
# the upsample conv into 64x64. The fp32 UNet of sdxl.example.yaml as written
# takes the same rows in the fp32 kernel and no conv kernel.
def sdxl_unet_call(n: int) -> tuple[dict, dict, dict]:
    """(flash, conv3x3, gn_silu_conv3x3) launches of one SDXL UNet forward at batch n."""
    flash = {(n,) + sh[1:]: fwd // 2 for sh, (fwd, _bwd) in SDXL_FLASH_SHAPES.items()}
    conv = {(n, 64, 64, 1280, 1280): 1}
    gn = {(n,) + sh[1:]: k for sh, k in SDXL_GN_CONV_SHAPES.items()}
    return flash, conv, gn


def scaled(table: dict, k: int) -> dict:
    return {sh: n * k for sh, n in table.items()}


SAMPLE_BATCHES = (1, 4)  # images a call of phase 12 (bench.py's sample mode, batch 1 and NEUROSIS_BENCH_BATCH=4)
SAMPLE_STEPS = 30
SAMPLE_CFG = 7.0
# the fp32 decode of b images at 1024 px: the decoder's mid attention over 128x128 latents
DECODE_F32_SHAPE = (1, 16384, 16384, 512)
# phase 13: predict of sdxl.example.yaml as written, 2 prompts (UNet batch 4, fp32), 4 steps, one decode of 2
PREDICT_PROMPTS = ("a photograph of an astronaut riding a horse", "a red fox in fresh snow, soft light")
PREDICT_STEPS = 4
# one image-logger call in the bf16 copy's fit: 2 images encoded (fp32), 4 CFG steps at UNet
# batch 4, the reconstructions and the samples decoded (fp32)
LOGGER_IMAGES, LOGGER_STEPS = 2, 4
# one image-logger call in vae.example.yaml's fit: the fp32 reconstruction of 2 images,
# its mid attention (32x32 latents) in the encoder and the decoder
CLI_VAE_LOGGER_F32_FLASH_SHAPES = {(2, 1, 1024, 1024, 512): 2}
FORWARD_ONLY = ("sdxl_sample1", "sdxl_sample4", "sdxl_decode1", "sdxl_decode4", "cli_predict", "cli_logger",
                "cli_vae_logger", "cli_sd15_logger")


def sampling_tables() -> dict:
    """{path: (bf16 flash, fp32 flash, conv3x3, gn_silu_conv3x3)} launches per
    unit of each sampling path: sdxl_sample<b> one UNet call for b images,
    sdxl_decode<b> one decode of b images, cli_predict one predict run,
    cli_logger, cli_vae_logger and cli_sd15_logger one image-logger call."""
    out = {}
    for b in SAMPLE_BATCHES:
        out[f"sdxl_sample{b}"] = (*sdxl_unet_call(2 * b)[:1], {}, *sdxl_unet_call(2 * b)[1:])
        out[f"sdxl_decode{b}"] = ({}, {(b,) + DECODE_F32_SHAPE: 1}, {}, {})
    flash32 = scaled(sdxl_unet_call(2 * len(PREDICT_PROMPTS))[0], PREDICT_STEPS)
    out["cli_predict"] = ({}, {**flash32, (len(PREDICT_PROMPTS),) + DECODE_F32_SHAPE: 1}, {}, {})
    flash, conv, gn = (scaled(t, LOGGER_STEPS) for t in sdxl_unet_call(2 * LOGGER_IMAGES))
    out["cli_logger"] = (flash, {(LOGGER_IMAGES,) + DECODE_F32_SHAPE: 3}, conv, gn)  # encode, two decodes
    out["cli_vae_logger"] = ({}, dict(CLI_VAE_LOGGER_F32_FLASH_SHAPES), {}, {})
    out["cli_sd15_logger"] = ({}, dict(SD15_LOGGER_F32_FLASH_SHAPES), {}, {})
    return out

# phase 14: sdxl-te.example.yaml as written through the CLI, saved at step 2 of a 3-step
# run (keeping 1), then resumed for steps 3 and 4 in the same projects/
TE_SAVE_STEPS, TE_RESUME_STEPS, TE_EVERY = 3, 4, 2
# (c): one bigG token embedding (vocab x width) and one LayerNorm weight, under min_8bit_size
ADAMW8BIT_SHAPES = ((49408, 1280), (1280,))

# phase 15: the SD training path's options. A v-prediction zero-terminal-SNR
# fine-tune of the bf16-mixed SDXL copy with remat_policy [none, none, dots_names]
# (configs/sdxl/sdxl-tpu-v5e.yaml:37): its rows are phase 9's, but a transformer
# block's flash forward is launched again in the backward only where its level's
# policy recomputes it (full, dots, dots_all: the kernel is no matmul, so only
# names and dots_names keep its output); the SDXL UNet's attention rows are level 1
# (64x64 = 4096 queries) and level 2 with the middle (32x32 = 1024)
VPRED_REMAT = ("none", "none", "dots_names")
RECOMPUTING_POLICIES = ("full", "dots", "dots_all")
SDXL_ATTN_LEVEL = {4096: 1, 1024: 2}


def remat_flash_table(table: dict, policy, level_of: dict) -> dict:
    """A (forward, backward) flash table of a fully recomputed path under
    ``policy`` (one per level): a row's forward runs once more in the
    backward where its level's policy recomputes, else once."""
    return {sh: (bwd * (2 if policy[level_of[sh[2]]] in RECOMPUTING_POLICIES else 1), bwd)
            for sh, (_fwd, bwd) in table.items()}


# a path whose flash forwards differ from its base path's rows (TABLES_OF) by its remat policy
REMAT_TABLES = {path: remat_flash_table(SDXL_FLASH_SHAPES, VPRED_REMAT, SDXL_ATTN_LEVEL)
                for path in ("cli_sdxl_vpred", "cli_sdxl_remat", "cli_sdxl_fsdp")}
VPRED_STEPS, VPRED_PROFILED_STEP, OPTION_STEPS = 3, 3, 2
# one image-logger call of the rectified-flow SD1.5 copy (256 px, batch 1: one image): the
# fp32 encode, the UNet at CFG batch 2 for each step of the comfy table (no trailing zero:
# LOGGER_STEPS entries, one step fewer), level 0's 5 transformer blocks past the flash
# gate, and the reconstruction and the samples decoded
RF_LOGGER_CALLS = LOGGER_STEPS - 1
SD15_LOGGER_F32_FLASH_SHAPES = {(2, 8, 1024, 1024, 40): 5 * RF_LOGGER_CALLS, (2, 8, 1024, 77, 40): 5 * RF_LOGGER_CALLS,
                                (1, 1, 1024, 1024, 512): 3}

# phase 16: the VQ-f8 autoencoder (CompVis/latent-diffusion
# models/first_stage_models/vq-f8/config.yaml: ch 128 x [1, 2, 2, 4], 2 blocks a
# level, attention at 32x32, z 4, a 16384-code VectorQuantizer) trained through
# the CLI at 256 px, batch 8, for VQ_PAIRS generator/discriminator pairs. Its
# attention (1024 tokens, 512 channels, one head) is the encoder's level-3
# blocks (2) and mid block and the decoder's mid block and level-3 blocks (3):
# 7 a forward, run forward in both steps and backward in the generator step.
VQ_PAIRS = 3
VQ_IMAGES = 16  # two batches an epoch: the schedule alternates G and D within an epoch
VQ_FLASH_SHAPES = {(8, 1, 1024, 1024, 512): (14, 7)}
# bf16 (the precision: bf16-mixed copy): the fused GroupNorm+SiLU->conv of every
# ResnetBlock at 64x64 (encoder level 2, decoder level 2 with its 512 -> 256
# block) and at 32x32 (encoder level 3 with its 256 -> 512 block, both mid
# blocks, decoder level 3), in both steps; conv3x3: the decoder's upsample conv
# into 64x64 in both steps and its dgrad, and the generator step's dgrads of
# every fused conv (listed under the conv's (B, H, W, C, F))
VQ_GN_CONV_SHAPES = {(8, 64, 64, 256, 256): 18, (8, 64, 64, 512, 256): 2, (8, 32, 32, 256, 512): 2,
                     (8, 32, 32, 512, 512): 34}
VQ_CONV_SHAPES = {(8, 64, 64, 512, 512): (2, 1), (8, 64, 64, 256, 256): (0, 9), (8, 64, 64, 512, 256): (0, 1),
                  (8, 32, 32, 512, 512): (0, 17), (8, 32, 32, 256, 512): (0, 1)}
# one validate (or test) batch of the fp32 VQ-f8 copy: the forward with the live
# weights and again under the EMA shadows
VQ_VAL_F32_FLASH_SHAPES = {(8, 1, 1024, 1024, 512): 14}
VQ_DIR = CLI_DIR / "data" / "vq" / "folder"
VQ_SIZES = [(256 + 16 * (i % 4), 256 + 16 * (i // 4)) for i in range(VQ_IMAGES)]  # (width, height), >= 256
VAE_CLI_PATHS = ("cli_vae", "cli_vq_f32", "cli_vq_bf16", "cli_vae_ddp", "cli_ds_f32", "cli_ds_bf16",
                 "cli_ds_profiler", "cli_mongo_vae", "cli_mongo_vae_resume")

# phase 18: SDXL's level-1 self-attention at batch 2 (1024 px), split over a ring of n slices on one
# card; each ring runs n x n flash blocks (q of S/n rows against kv of S/n rows) forward and backward
RING_SHAPE = (2, 10, 4096, 64)
RING_SIZES = (2, 4)
RING_FLASH_SHAPES = {(2, 10, 4096 // n, 4096 // n, 64): (n * n, n * n) for n in RING_SIZES}
# FrozenCLIPT5Encoder at its defaults: CLIP-L and T5 v1.1-XL (d_model 2048, 24 layers, 32 heads, d_ff 5120)
CLIP_T5_PROMPTS = ("a photograph of an astronaut riding a horse", "a red fox in fresh snow, soft light")
CLIP_T5_TOL = {"fp32": 1e-3, "bf16": 2e-2}  # PERF.md section 2's card-vs-CPU gates

# phase 19: configs/vae/vae.example.yaml with its loss swapped for AutoencoderDreamsim (the three
# ViT-B/16 towers at 224 px, fp32, frozen; no discriminator, so every step is a generator step).
# The towers' attention (197 tokens) and products are plain matmuls, as JAX's einsums are. As
# written (fp32) a step launches cli_vae's kernels; the bf16-mixed copy (256 px, batch 2) launches
# the mid attention's flash pair and both conv kernels at 64x64 and 32x32, per generator step:
DS_FLASH_SHAPES = {(2, 1, 1024, 1024, 512): (2, 2)}
DS_CONV_SHAPES = {(2, 64, 64, 512, 512): (1, 10), (2, 64, 64, 256, 512): (0, 1), (2, 32, 32, 512, 512): (0, 18)}
DS_GN_CONV_SHAPES = {(2, 64, 64, 256, 512): 1, (2, 64, 64, 512, 512): 9, (2, 32, 32, 512, 512): 18}
DS_STEPS = 3
DS_PROFILED_STEPS = 4  # skip_first 1, warmup 1, active 1: the profiler starts after step 3 and traces step 4
DS_TOWERS = ("dino", "clip1", "clip2")
DS_TOL = {"fp32": (1e-3, 1e-2), "bf16": (2e-2, 5e-2)}  # PERF.md section 2: losses, grad norms
DS_FULL_WIDTH_TOL = 1e-3  # fp32 card vs CPU at full width

# path -> (its key in the report, the unit its launch tables count)
PATHS = {"sd15": ("slice", "SD1.5 train step"),
         "sd15_f32": ("sd15_f32", "SD1.5 train step, fp32 UNet (sd15.example.yaml as written, 256 px, batch 1)"),
         "vae_gan": ("vae_gan", "VAE-GAN generator + discriminator pair, bf16"),
         "vae_gan_f32": ("vae_gan_f32", "VAE-GAN generator + discriminator pair, fp32"),
         "sdxl": ("sdxl", "SDXL train step"), "overlap": ("overlap", "one run of the flash-overlap tool"),
         "cli_sdxl_f32": ("cli_sdxl_f32", "SDXL train step of sdxl.example.yaml as written (fp32 UNet) through "
                                          "python -m neurosis_tpu_torch fit"),
         "cli_sdxl_bf16": ("cli_sdxl_bf16", "SDXL train step of its bf16-mixed copy through the CLI"),
         "cli_vae": ("cli_vae", "generator step of vae.example.yaml as written (fp32) through the CLI"),
         "cli_sdxl_te": ("cli_sdxl_te", "SDXL train step of sdxl-te.example.yaml as written (fp32 UNet, both "
                                        "towers trainable, AdamW8bit, the legacy cosine schedule) through the CLI"),
         **{f"sdxl_sample{b}": (f"sdxl_sample{b}", f"one SDXL UNet call of CFG sampling, {b} image(s) at 1024 px "
                                                   f"(UNet batch {2 * b})") for b in SAMPLE_BATCHES},
         **{f"sdxl_decode{b}": (f"sdxl_decode{b}", f"the fp32 decode of {b} image(s) at 1024 px")
            for b in SAMPLE_BATCHES},
         "cli_predict": ("cli_predict", "python -m neurosis_tpu_torch predict of sdxl.example.yaml as written "
                                        "(fp32 UNet, CFG 7.5), 2 prompts, 4 steps, 1024 px"),
         "cli_logger": ("cli_logger", "one image-logger call of the bf16-mixed copy's fit (2 images: encode, 4 "
                                      "CFG steps, two decodes)"),
         "cli_vae_logger": ("cli_vae_logger", "one image-logger call of vae.example.yaml's fit (2 images)"),
         "cli_sdxl_vpred": ("cli_sdxl_vpred", "SDXL train step of the v-prediction zero-terminal-SNR copy (bf16-mixed, "
                                              "remat [none, none, dots_names], UCG, noise offset, min-SNR, the tag "
                                              "hook, Adafactor beta1 and decay) through the CLI"),
         "cli_sdxl_remat": ("cli_sdxl_remat", "SDXL train step of the bf16-mixed copy with remat [none, none, "
                                              "dots_names] and nothing else changed, through the CLI"),
         "cli_vpred_logger": ("cli_vpred_logger", "one image-logger call of the v-prediction copy's fit (2 images, 4 "
                                                  "Euler CFG steps over the tan table)"),
         "cli_sd15_edm": ("cli_sd15_edm", "SD1.5 train step of sd15.example.yaml's EDM copy through the CLI"),
         "cli_sd15_rf": ("cli_sd15_rf", "SD1.5 train step of sd15.example.yaml's rectified-flow copy (comfy, L1) "
                                        "through the CLI"),
         "cli_sd15_logger": ("cli_sd15_logger", "one image-logger call of the rectified-flow copy's fit (1 image, "
                                                "rf_safeguard)"),
         "cli_vq_f32": ("cli_vq_f32", "generator + discriminator pair of the VQ-f8 copy of vae.example.yaml (fp32, "
                                      "256 px, batch 8, VQLPIPSWithDiscriminator, torch.optim.Adam) through the CLI"),
         "cli_vq_bf16": ("cli_vq_bf16", "generator + discriminator pair of the VQ-f8 copy with precision "
                                        "bf16-mixed through the CLI"),
         "cli_vq_val": ("cli_vq_val", "one validate batch of the fp32 VQ-f8 copy (batch 8, live and EMA weights)"),
         "cli_vae_val": ("cli_vae_val", "one validate batch of vae.example.yaml as written (fp32, batch 2)"),
         "cli_sdxl_fsdp": ("cli_sdxl_fsdp", "SDXL train step of the sdxl-tpu-v5e.yaml copy (bf16-mixed, remat [none, "
                                            "none, dots_names], Adafactor, batch 2) wrapped with FSDP2 at one NCCL "
                                            "rank (strategy fsdp), through tools/launch_pod"),
         "cli_vae_ddp": ("cli_vae_ddp", "G/D pair of vae.example.yaml (fp32, disc_start 1) under strategy ddp at one "
                                        "NCCL rank, through tools/launch_pod"),
         "ring": ("ring", "ring self-attention forward and backward on one card (in-process rotation): SDXL level 1, "
                          "2x10x4096x64, at n = 2 and 4 slices, in bf16 and in fp32 (four rings)"),
         "cli_ds_f32": ("cli_ds_f32", "generator step of vae.example.yaml with its loss AutoencoderDreamsim (ensemble, "
                                      "l1; fp32, 256 px, batch 2) through the CLI"),
         "cli_ds_bf16": ("cli_ds_bf16", "generator step of that DreamSim copy with precision bf16-mixed through the "
                                        "CLI"),
         "cli_ds_profiler": ("cli_ds_profiler", "generator step of the bf16-mixed DreamSim copy with trainer.profiler: "
                                                "(module spans on) through the CLI"),
         "cli_mongo_sdxl": ("cli_mongo_sdxl", "SDXL train step of the bf16-mixed copy fit from MongoAspectDataset "
                                              "(SDXLBucketList, batch 2) through the CLI"),
         "cli_mongo_vae": ("cli_mongo_vae", "generator step of vae.example.yaml (fp32, EMA) fit from MongoVAEDataset, "
                                            "saving each step to a memory:// store, through the CLI"),
         "cli_mongo_vae_resume": ("cli_mongo_vae_resume", "generator step of that copy resumed from the memory:// "
                                                          "store (trainer.remote_checkpoint_url)")}
# a path whose shape tables are another's (the same step, reached another way; the towers of
# sdxl-te train, but at 77 tokens their attention is under the flash gate)
TABLES_OF = {"cli_sdxl_bf16": "sdxl", "cli_sdxl_te": "cli_sdxl_f32", "cli_sdxl_vpred": "sdxl", "cli_sdxl_remat": "sdxl",
             "cli_vpred_logger": "cli_logger", "cli_sd15_edm": "sd15_f32", "cli_sd15_rf": "sd15_f32",
             "cli_vae_val": "cli_vae_logger", "cli_sdxl_fsdp": "sdxl", "cli_ds_f32": "cli_vae",
             "cli_ds_profiler": "cli_ds_bf16", "cli_mongo_sdxl": "sdxl", "cli_mongo_vae": "cli_vae",
             "cli_mongo_vae_resume": "cli_vae"}

# tolerances on max|kernel - plain| / max|plain|, same bf16 inputs on both sides
TOL = {
    "flash_fwd": 2e-2,  # kernel rounds P to bf16 before P.V; both round O to bf16
    "flash_fwd_f32": 2e-5,  # fp32 accuracy on both sides: three TF32 products of split operands, sums in another order
    "flash_lse": 1e-3,  # fp32 both sides, absolute in log2 units
    "flash_bwd": 5e-2,  # kernels round P and dS to bf16; dQ summed in another order (fp32 atomics at d <= 160, one fp32 sum over the kv tiles at 512)
    "flash_bwd_f32": 1e-4,  # three TF32 products of split operands a product, as the fp32 forward, over chains of up to 4096 keys (dQ) or queries (dK, dV); dK, dV summed by atomics where the q range is split
    "flash_overlap": 1e-2,  # P rounded to bf16 on both sides; bf16 output rounding, sums in another order
    "conv3x3": 1e-2,  # fp32 accumulation in another order, bf16 output rounding
    "gn_silu_conv3x3": 1e-2,
    "gn_silu_conv3x3_bwd": 2e-2,  # adds the dgrad kernel's rounding of dact
}

KERNELS = {
    "flash_fwd": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                      replaces="neurosis_tpu/ops/flash_attention.py:575"),
    "flash_bwd": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                      replaces="neurosis_tpu/ops/flash_attention.py:843; at d = 512 :751 (dQ), :952 (dK, dV)"),
    "flash_fwd_f32": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                          replaces="neurosis_tpu/ops/flash_attention.py:297"),
    "flash_bwd_f32": dict(source="neurosis_tpu_torch/csrc/flash_attention.cu",
                          replaces="neurosis_tpu/ops/flash_attention.py:751 (dQ), :952 (dK, dV)"),
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


def kernels_ms(torch, fn) -> dict:
    """Device ms of each kernel that one ``fn()`` launches, by name (the fp32
    kernels' split passes apart from their main kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


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


def flash_tables(torch) -> list:
    """(path, (B, H, Sq, Skv, D), (forward, backward) launches per unit, dtype)
    of every flash row phase 3 checks."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [("sd15", sh, n, bf16) for sh, n in FLASH_SHAPES.items()] + \
           [("vae_gan", sh, n, bf16) for sh, n in VAE_FLASH_SHAPES.items()] + \
           [("sdxl", sh, n, bf16) for sh, n in SDXL_FLASH_SHAPES.items()] + \
           [("overlap", sh, (n, 0), bf16) for sh, n in overlap_launches()["flash_fwd"].items()] + \
           [("sd15", sh, (n, 0), f32) for sh, n in FLASH_F32_SHAPES.items()] + \
           [("sd15_f32", sh, n, f32) for sh, n in SD15_F32_FLASH_SHAPES.items()] + \
           [("vae_gan_f32", sh, n, f32) for sh, n in VAE_F32_FLASH_SHAPES.items()] + \
           [("sdxl", sh, (n, 0), f32) for sh, n in SDXL_FLASH_F32_SHAPES.items()] + \
           [(path, sh, n, f32) for path, table in UNDRIVEN_F32_FLASH_SHAPES.items() if path != "sdxl_f32"
            for sh, n in table.items()] + \
           [("cli_sdxl_f32", sh, n, f32) for sh, n in CLI_SDXL_F32_FLASH_SHAPES.items()] + \
           [("cli_vae", sh, n, f32) for sh, n in CLI_VAE_F32_FLASH_SHAPES.items()] + \
           [("cli_vq_bf16", sh, n, bf16) for sh, n in VQ_FLASH_SHAPES.items()] + \
           [("cli_vq_f32", sh, n, f32) for sh, n in VQ_FLASH_SHAPES.items()] + \
           [("cli_vq_val", sh, (n, 0), f32) for sh, n in VQ_VAL_F32_FLASH_SHAPES.items()] + \
           [(path, sh, (n, 0), dtype) for path, tables in sampling_tables().items()
            for dtype, table in zip((bf16, f32), tables[:2]) for sh, n in table.items()] + \
           [("ring", sh, n, dtype) for dtype in (bf16, f32) for sh, n in RING_FLASH_SHAPES.items()] + \
           [("cli_ds_bf16", sh, n, bf16) for sh, n in DS_FLASH_SHAPES.items()]


def check_flash(torch, log: list) -> dict:
    """Each flash shape of every path in its dtype: forward and backward in
    bf16, and in fp32 (the frozen encodes run the forward only; fp32 plain
    version with TF32 off, SDPA on the same inputs as the yardstick), and the
    fp32 rows of UNDRIVEN_F32_FLASH_SHAPES."""
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops import flash_attention as fa

    rows = {"flash_fwd": [], "flash_bwd": [], "flash_fwd_f32": [], "flash_bwd_f32": []}
    f32 = torch.float32
    # (shape, dtype) -> its forward and backward rows: another path's row at that shape reuses them
    forwards, backwards = {}, {}
    for path, shape, (n_fwd, n_bwd), dtype in flash_tables(torch):
        is_f32 = dtype == f32
        name, bwd_name = ("flash_fwd_f32", "flash_bwd_f32") if is_f32 else ("flash_fwd", "flash_bwd")
        if (shape, dtype) in forwards and (not n_bwd or (shape, dtype) in backwards):
            rows[name].append(dict(forwards[shape, dtype], path=path, per_step=n_fwd))
            if n_bwd:
                rows[bwd_name].append(dict(backwards[shape, dtype], path=path, per_step=n_bwd))
            continue
        fwd = fa.flash_fwd_f32 if is_f32 else fa.flash_fwd
        bwd = fa.flash_bwd_f32 if is_f32 else fa.flash_bwd
        peak = PEAK_TF32_FLOPS / 3 if is_f32 else PEAK_BF16_FLOPS  # split TF32 or bf16 tensor cores
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
        extra = {}
        if is_f32:  # beside it, the bound of the same work on the CUDA cores (FFMA), and its kernels' parts
            extra["ffma_bound_ms"] = bound_ms(4.0 * b * h * sq * skv * d, bh_in + b * h * sq * (d * elem + 4),
                                              PEAK_FP32_FLOPS)[0]
            extra["kernels_ms"] = kernels_ms(torch, lambda: fwd(qs, k, v))
        rows[name].append(dict(
            path=path, shape=tag, per_step=n_fwd, max_abs_err=err, rel_err=rel,
            ms=time_ms(torch, lambda: fwd(qs, k, v)),
            plain_ms=time_ms(torch, lambda: fa.flash_fwd_plain(qs, k, v), iters=3, warmup=1),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            bound_ms=t, bound_by=by, **extra))
        forwards[shape, dtype] = rows[name][-1]
        if not n_bwd:  # a forward-only shape: a frozen encode, a decode, sampling, the overlap tool's base cases
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
        flops = 10.0 * b * h * sq * skv * d
        nbytes = bh_in + b * h * sq * (d * elem + 8) + b * h * (sq + 2 * skv) * d * elem
        t, by = bound_ms(flops, nbytes, peak)
        extra = {}
        if is_f32:  # the FFMA bound beside it
            extra["ffma_bound_ms"] = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)[0]
        if is_f32 or d == 512:  # the split passes, the dQ and the dK/dV kernel apart
            extra["kernels_ms"] = kernels_ms(torch, lambda: bwd(qs, k, v, do, lse_ref, di, scale))
        rows[bwd_name].append(dict(
            path=path, shape=tag, per_step=n_bwd, max_abs_err=max(e for e, _ in errs), rel_err=max(r for _, r in errs),
            ms=time_ms(torch, lambda: bwd(qs, k, v, do, lse_ref, di, scale)),
            plain_ms=time_ms(torch, lambda: fa.flash_bwd_plain(qs, k, v, do, lse_ref, di, scale),
                             iters=3, warmup=1),
            library_ms=time_ms(torch, lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                                  retain_graph=True)),
            bound_ms=t, bound_by=by, **extra))
        backwards[shape, dtype] = rows[bwd_name][-1]
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
    sampling = sampling_tables()
    tables = [("sd15", sh, n) for sh, n in CONV_SHAPES.items()] + \
             [("vae_gan", sh, n) for sh, n in VAE_CONV_SHAPES.items()] + \
             [("sdxl", sh, n) for sh, n in SDXL_CONV_SHAPES.items()] + \
             [("cli_vq_bf16", sh, n) for sh, n in VQ_CONV_SHAPES.items()] + \
             [(path, sh, (n, 0)) for path, t in sampling.items() for sh, n in t[2].items()] + \
             [("cli_ds_bf16", sh, n) for sh, n in DS_CONV_SHAPES.items()]
    measured = {}  # (kind, shape) -> its row: another path's row at that shape reuses it
    for path, shape, (n_fwd, n_dgrad) in tables:
        if all((kind, shape) in measured for kind, n in (("fwd", n_fwd), ("dgrad", n_dgrad)) if n):
            for kind, n in (("fwd", n_fwd), ("dgrad", n_dgrad)):
                if n:
                    rows["conv3x3"].append(dict(measured[kind, shape], path=path, per_step=n))
            continue
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
        )[: 2 if n_dgrad else 1]:
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
            measured[kind, shape] = rows["conv3x3"][-1]

    gn_tables = [("sd15", sh, n) for sh, n in GN_CONV_SHAPES.items()] + \
                [("vae_gan", sh, n) for sh, n in VAE_GN_CONV_SHAPES.items()] + \
                [("sdxl", sh, n) for sh, n in SDXL_GN_CONV_SHAPES.items()] + \
                [("cli_vq_bf16", sh, n) for sh, n in VQ_GN_CONV_SHAPES.items()] + \
                [(path, sh, n) for path, t in sampling.items() for sh, n in t[3].items()] + \
                [("cli_ds_bf16", sh, n) for sh, n in DS_GN_CONV_SHAPES.items()]
    for path, shape, n in gn_tables:
        if ("gn", shape) in measured:
            rows["gn_silu_conv3x3"].append(dict(measured["gn", shape], path=path, per_step=n))
            continue
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
        got = want = None
        if path not in FORWARD_ONLY:  # a training path also takes the fused pair's backward
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
        measured["gn", shape] = rows["gn_silu_conv3x3"][-1]
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
    per step (or pair) of that path, their summed time and summed bound (and
    the fp32 rows' FFMA bound beside it); a path of REMAT_TABLES takes its
    own bf16 forward counts over its base path's rows."""
    out = {}
    remat = REMAT_TABLES.get(path)
    path = TABLES_OF.get(path, path)
    for name, rs in rows.items():
        rs = [r for r in rs if r["path"] == path]
        if remat is not None and name == "flash_fwd":
            rs = [dict(r, per_step=remat[tuple(int(x) for x in r["shape"].split()[0].split("x"))][0]) for r in rs]
        out[name] = dict(launches=sum(r["per_step"] for r in rs), ms=sum(r["per_step"] * r["ms"] for r in rs),
                         bound_ms=sum(r["per_step"] * r["bound_ms"] for r in rs))
        if any("ffma_bound_ms" in r for r in rs):
            out[name]["ffma_bound_ms"] = sum(r["per_step"] * r["ffma_bound_ms"] for r in rs)
    return out


def check_launches(launches: dict, totals: dict, units: int, label: str) -> None:
    """Each kernel the path's tables list was launched, and every counter
    equals units x the tables' count (0 for a kernel the path does not run)."""
    print(f"{label} launches: {launches}", flush=True)
    missing = [k for k, t in totals.items() if t["launches"] and not launches[k]]
    if missing:
        raise PhaseError(f"{label} never launched {missing}")
    for name, tot in totals.items():
        ffma = f", FFMA bound {tot['ffma_bound_ms']:.3f} ms" if "ffma_bound_ms" in tot else ""
        print(f"{name} per {label} unit: {tot['launches']} launches, {tot['ms']:.3f} ms at the phase-3 times, "
              f"bound {tot['bound_ms']:.3f} ms{ffma}", flush=True)
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
        out["engine"] = engine  # phase 12 samples with it
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


# ---------------------------------------------------------------------------
# phase 11: the training entry point
# ---------------------------------------------------------------------------


def write_image_folder(torch, folder: Path, seed: int = 11, sizes: list = CLI_IMAGE_SIZES) -> None:
    """``sizes`` as PNGs (written by the port's PNG writer) of smooth random
    fields, each with a caption of a few comma-separated tags."""
    import torch.nn.functional as F

    from neurosis_tpu_torch.data.png import write_png

    folder.mkdir(parents=True, exist_ok=True)
    g = torch.Generator("cpu").manual_seed(seed)
    tags = ["a photo", "smooth field", "soft light", "outdoors", "blue sky", "grass", "portrait", "landscape"]
    for i, (w, h) in enumerate(sizes):
        coarse = torch.rand(1, 3, h // 32, w // 32, generator=g)
        img = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        img = (img + 0.05 * torch.randn(1, 3, h, w, generator=g)).clamp(0, 1)
        write_png(folder / f"img_{i}.png", (img[0] * 255).round().to(torch.uint8).permute(1, 2, 0).numpy())
        picks = torch.randperm(len(tags), generator=g)[:4].tolist()
        (folder / f"img_{i}.txt").write_text(", ".join(tags[j] for j in picks))


def step_profiles(torch, prof, span) -> list:
    """Each ``span`` of a profile: device busy ms (the union of the kernels
    that ran between the span's start and end; the trainer syncs the card at
    both, so no other work overlaps a step), ms and kernels by kind, and
    kernel count; ``span`` None: the whole window (a profile of one step
    that recorded the device alone)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(-math.inf, math.inf)] if span is None else \
        sorted((e.time_range.start, e.time_range.end) for e in events if e.name == span and e.device_type != cuda)
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == cuda and not getattr(e, "is_user_annotation", False))
    out = []
    for s0, s1 in spans:
        busy, end, kinds, counts, n = 0.0, -math.inf, {}, {}, 0
        for k0, k1, name in kernels:
            if k0 < s0 or k1 > s1:
                continue
            n += 1
            kind = kernel_kind(name)
            kinds[kind] = kinds.get(kind, 0.0) + (k1 - k0) / 1e3
            counts[kind] = counts.get(kind, 0) + 1
            if k1 > end:
                busy += k1 - max(k0, end)
                end = k1
        out.append(dict(device_ms=busy / 1e3 if n else None, kinds_ms=kinds, kinds_launches=counts, launches=n))
    return out


def run_cli(torch, rows: dict, config: Path, label: str, path: str, steps: int, profiled: bool,
            logger: tuple = None, first_step: int = 1, profile_step: int = None, units: int = None,
            entry=None, totals: dict = None, device_only: bool = False, writer: bool = True) -> dict:
    """``python -m neurosis_tpu_torch fit -c config`` in this process (its
    main()), from the working directory (CLI_DIR) and a fresh projects/ there
    (``first_step`` > 1: the projects/ of the run it resumes): rc 0, a finite
    loss on each of ``steps`` new lines of metrics.jsonl, their steps from
    ``first_step`` on, and every kernel's launches equal to ``steps`` x the
    path's tables; with ``profiled`` the run is inside one torch.profiler
    window, which gives each step's device time, with ``profile_step`` the
    k-th step of the run alone. With ``logger`` = (its path, calls), the
    launches inside the image logger's calls are read apart and held to that
    path's tables x calls; a call that raises fails the run (the logger
    itself would log and go on). ``units``: the units the path's tables
    count in the run (default ``steps``; a VAE-GAN path counts pairs), or
    ``totals`` in their place. ``entry``: the main() that takes the argv
    (default the CLI's; phase 17's ranks run tools/launch_pod's).
    ``device_only``: the ``profile_step`` profile records the device alone,
    which reads back in seconds rather than minutes. ``writer`` False: a
    rank other than 0 of a mesh, which writes no metrics file: only its
    launches are held (rank 0 clears projects/ and reads the metrics)."""
    import contextlib
    import gc
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from neurosis_tpu_torch import ops
    from neurosis_tpu_torch.trainer import cli
    from neurosis_tpu_torch.trainer.callbacks import ImageLogger
    from neurosis_tpu_torch.trainer.loop import STEP_SPAN, Trainer

    metrics_file = Path("projects/logs/metrics.jsonl")
    if first_step == 1 and writer:
        shutil.rmtree("projects", ignore_errors=True)
    logged_before = len(metrics_file.read_text().splitlines()) if metrics_file.exists() and writer else 0
    gc.collect()  # an earlier run's profile, freed before this run's host times
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logged, calls, inner = dict.fromkeys(ops.launch_counts(), 0), [], ImageLogger._log_images

    def counted(self, *args, **kwargs):
        before = ops.launch_counts()
        try:
            result = inner(self, *args, **kwargs)
            calls.append("ok")
            return result
        except Exception as e:
            calls.append(repr(e))
            raise
        finally:
            for k, n in ops.launch_counts().items():
                logged[k] += n - before[k]

    ImageLogger._log_images = counted
    one_step, inner_step, step_calls = [], Trainer._step, []

    def step(self, *args, **kwargs):
        step_calls.append(1)
        if len(step_calls) != profile_step:
            return inner_step(self, *args, **kwargs)
        activities = [ProfilerActivity.CUDA] if device_only else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities) as step_prof:
            result = inner_step(self, *args, **kwargs)
        one_step.append(step_prof)
        return result

    Trainer._step = step
    t0 = time.perf_counter()
    argv = ["fit", "-c", str(config)]
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled \
                else contextlib.nullcontext() as prof:
            rc = (entry or cli.main)(argv)
            torch.cuda.synchronize()
    finally:
        ImageLogger._log_images = inner
        Trainer._step = inner_step
    seconds = time.perf_counter() - t0
    launches = {k: n - logged[k] for k, n in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise PhaseError(f"{label}: main() returned {rc}")
    if not writer:
        check_launches(launches, totals or step_totals(rows, path), units or steps, label)
        return dict(launches=launches, peak_bytes=peak, seconds=seconds)
    lines = [json.loads(x) for x in metrics_file.read_text().splitlines()][logged_before:]
    loss_key = "total" if path in VAE_CLI_PATHS else "loss"
    if [r["step"] for r in lines] != list(range(first_step, first_step + steps)):
        raise PhaseError(f"{label}: metrics.jsonl has new steps {[r['step'] for r in lines]}, not "
                         f"{first_step}-{first_step + steps - 1}")
    if not all(math.isfinite(r[loss_key]) for r in lines):
        raise PhaseError(f"{label}: a loss is not finite: {[r[loss_key] for r in lines]}")
    for r in lines:
        print(f"{label} step {r['step']}: {loss_key} {r[loss_key]:.6f}, host step {r['step_ms']:.1f} ms, "
              f"data {r['data_ms']:.1f} ms", flush=True)
    print(f"{label}: {seconds:.1f} s in main(), peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)
    check_launches(launches, totals or step_totals(rows, path), units or steps, label)
    out = dict(metrics=lines, launches=launches, peak_bytes=peak, seconds=seconds)
    if logger is not None:
        logger_path, n_calls = logger
        if calls != ["ok"] * n_calls:
            raise PhaseError(f"{label}: the image logger's calls ended {calls}, not {n_calls} x ok")
        check_launches(logged, step_totals(rows, logger_path), n_calls, f"{label}: image-logger call")
        out.update(logger_launches=logged, images=Path("projects/images/train"))
    elif any(logged.values()) or calls:
        raise PhaseError(f"{label}: an image logger ran in a run without one: {calls}")
    if profiled or one_step:
        out["profiles"] = step_profiles(torch, prof if profiled else one_step[0],
                                        None if device_only and not profiled else STEP_SPAN)
        for i, p in enumerate(out["profiles"], start=profile_step - 1 if one_step else 0):
            if p["device_ms"] is None:
                print(f"{label} step {i + 1}: the profiler recorded no device kernels in the step: device time "
                      "not measured", flush=True)
                continue
            kinds = ", ".join(f"{k} {ms:.3f} ms in {p['kinds_launches'][k]}"
                              for k, ms in sorted(p["kinds_ms"].items(), key=lambda kv: -kv[1]))
            print(f"{label} step {i + 1}: device busy {p['device_ms']:.3f} ms in {p['launches']} kernels (host step "
                  f"{lines[i]['step_ms']:.1f} ms under the profiler); by kind: {kinds}", flush=True)
    return out


def run_cli_phase(torch, rows: dict) -> dict:
    """Phase 11: the image folder, then the CLI's fit on the three configs.
    The bf16 copy runs twice: first unprofiled for its host times (the first
    run after phase 10, as phase 9 is the first after phase 8), then two
    steps, the second profiled alone, which compares with phase 9's profiled
    (steady) step: a first step also creates the optimizer's state."""
    import os

    from neurosis_tpu_torch.config.loader import load_config

    repo = Path.cwd().resolve()
    sdxl, vae = repo / "configs/sdxl/sdxl.example.yaml", repo / "configs/vae/vae.example.yaml"
    t0 = time.perf_counter()
    write_image_folder(torch, CLI_DIR / "data" / "dataset" / "folder")
    print(f"cli: wrote {len(CLI_IMAGE_SIZES)} PNGs in {time.perf_counter() - t0:.1f} s", flush=True)
    written = "  fast_dev_run: true  # disable to actually train\n"
    text = sdxl.read_text()
    if text.count(written) != 1:
        raise PhaseError(f"{sdxl} no longer has the line {written!r}")
    bf16 = (CLI_DIR / "sdxl-bf16.yaml").resolve()
    bf16.write_text(text.replace(written, "  fast_dev_run: false\n  max_steps: 4\n  precision: bf16-mixed\n"))
    bf16_two = (CLI_DIR / "sdxl-bf16-two-steps.yaml").resolve()
    bf16_two.write_text(text.replace(written, "  fast_dev_run: false\n  max_steps: 2\n  precision: bf16-mixed\n"))
    want = load_config(sdxl)
    want["trainer"].update(fast_dev_run=False, max_steps=4, precision="bf16-mixed")
    if load_config(bf16) != want:
        raise PhaseError("the bf16 copy of sdxl.example.yaml differs in more than its three keys")

    out = {}
    cwd, hash_env = os.getcwd(), os.environ.get("NEUROSIS_ALLOW_HASH_TOKENIZER")
    os.chdir(CLI_DIR)
    try:
        os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = "1"
        out["cli_sdxl_bf16"] = run_cli(torch, rows, bf16, "CLI fit sdxl bf16-mixed copy", "cli_sdxl_bf16",
                                       4, profiled=False)
        out["cli_sdxl_f32"] = run_cli(torch, rows, sdxl, "CLI fit sdxl.example.yaml (fp32)", "cli_sdxl_f32", 1,
                                      profiled=False, profile_step=1, device_only=True)
        out["cli_sdxl_bf16_profiled"] = run_cli(torch, rows, bf16_two, "CLI fit sdxl bf16-mixed, profiled",
                                                "cli_sdxl_bf16", 2, profiled=False, profile_step=2, device_only=True)
        out["cli_vae"] = run_cli(torch, rows, vae, "CLI fit vae.example.yaml (fp32)", "cli_vae", 1, profiled=False)
    finally:
        os.chdir(cwd)
        if hash_env is None:
            os.environ.pop("NEUROSIS_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = hash_env
    if "train/loss/rec" not in out["cli_vae"]["metrics"][0]:
        raise PhaseError("the VAE run's step was not a generator step")
    return out


# ---------------------------------------------------------------------------
# phases 12 and 13: sampling
# ---------------------------------------------------------------------------

SAMPLE_SPAN = "neurosis/sample_step"


def make_sampler(num_steps: int, scale: float):
    """EulerEDMSampler over LegacyDDPM with VanillaCFG(scale), as the configs name it."""
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.sampling.guidance import VanillaCFG
    from neurosis_tpu_torch.sampling.samplers import EulerEDMSampler

    return EulerEDMSampler(discretization=LegacyDDPMDiscretization(), guider=VanillaCFG(scale), num_steps=num_steps)


def prompt_batch(torch, device, images: int, seed: int, px: int = 1024) -> dict:
    """Token ids of ``images`` prompts, the empty prompt's ids as uncond_ids,
    and SDXL's size conditionings of an uncropped px x px image (as predict
    sets them)."""
    batch = {"caption_ids": make_batch(torch, device, images, 8, seed)["caption_ids"]}
    uncond = torch.full((1, 77), 49407)
    uncond[0, 0] = 49406  # BOS, then EOS and its padding
    batch["uncond_ids"] = uncond.to(device)
    batch["original_size_as_tuple"] = torch.full((images, 2), float(px), device=device)
    batch["crop_coords_top_left"] = torch.zeros(images, 2, device=device)
    batch["target_size_as_tuple"] = torch.full((images, 2), float(px), device=device)
    return batch


def reference_sample(torch, log: list) -> dict:
    """Four CFG Euler steps of a small SDXL-layout engine (bf16 UNet, two text
    towers, size embedders) on the card against the same on the CPU, from
    one noise tensor; then the CPU's latents decoded by its small fp32 first
    stage on both (the fp32 flash forward at d=512 over 1024 tokens)."""
    from neurosis_tpu_torch import ops

    dd = dict(SMALL_VAE, double_z=True, in_channels=3, out_ch=3)
    engines = {}
    for dev in ("cpu", "cuda"):
        engines[dev] = make_engine(torch, dev, 1, SMALL_SDXL_UNET, SMALL_CLIP, use_ema=False, bigg=SMALL_BIGG,
                                   size_outdim=32, vae=dd)
        engines[dev].sampler = make_sampler(4, SAMPLE_CFG)
    g = torch.Generator("cpu").manual_seed(2)
    with torch.no_grad():
        for p in engines["cpu"].model.parameters():  # zero-init output layers included
            p.add_(0.02 * torch.randn(p.shape, generator=g))
        for name in ("model", "conditioner", "first_stage"):
            getattr(engines["cuda"], name).load_state_dict(getattr(engines["cpu"], name).state_dict())
    batch = prompt_batch(torch, "cpu", 2, 3, px=256)
    noise = torch.randn(2, 32, 32, 4, generator=torch.Generator("cpu").manual_seed(4))
    latents = {}
    before = ops.launch_counts()
    for dev, eng in engines.items():
        with torch.no_grad():
            c, uc = eng.conditioner.get_unconditional_conditioning({k: v.to(dev) for k, v in batch.items()})
        latents[dev] = eng.sample(c, uc, noise.shape, noise=noise.to(dev)).cpu()
    launched = {k: ops.launch_counts()[k] - before[k] for k in before}
    print(f"small SDXL sample launches: {launched}", flush=True)
    missing = [k for k in ("flash_fwd", "gn_silu_conv3x3") if not launched[k]]
    if missing or launched["flash_bwd"]:
        raise PhaseError(f"the small SDXL sample did not launch {missing} (or ran a backward): {launched}")
    err, rel = rel_err(latents["cuda"], latents["cpu"])
    # bf16 UNet on both sides: the kernels round where the plain versions do, sums in another order
    check("small SDXL sample, 4 CFG steps, latents (cuda vs cpu)", rel, 2e-2, log, err)
    before = ops.launch_counts()["flash_fwd_f32"]
    images = {dev: eng.decode_first_stage(latents["cpu"].to(dev)).cpu() for dev, eng in engines.items()}
    if ops.launch_counts()["flash_fwd_f32"] - before != 1:
        raise PhaseError("the small decode did not launch flash_fwd_f32 once")
    d_err, d_rel = rel_err(images["cuda"], images["cpu"])
    # fp32 on both sides with TF32 off: sums in another order through ~20 layers
    check("small fp32 decode of the same latents (cuda vs cpu)", d_rel, 1e-3, log, d_err)
    return dict(latents_max_abs_err=err, latents_rel_err=rel, decode_max_abs_err=d_err, decode_rel_err=d_rel,
                launches=launched)


def run_sample(torch, rows: dict, engine) -> dict:
    """Phase 12: bench.py's sample mode on the port's SDXL engine of phase 9
    (bf16 UNet, fp32 towers and VAE): EulerEDMSampler, 30 steps, CFG 7, at
    each of SAMPLE_BATCHES images of 1024 px. A warm 2-step call, then one
    timed call (its launches per UNet call held to the tables), the fp32
    decode timed (its launches too), one sampler step profiled inside a
    SAMPLE_SPAN span, the whole call and the decode profiled."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from neurosis_tpu_torch import ops

    for p in engine.trainable_parameters():
        p.grad = None  # phase 9's last grads
    engine.sampler = make_sampler(SAMPLE_STEPS, SAMPLE_CFG)
    out = {}
    for b in SAMPLE_BATCHES:
        label = f"SDXL sampling, {b} image(s)"
        batch = prompt_batch(torch, "cuda", b, 20 + b)
        with torch.no_grad():
            c, uc = engine.conditioner.get_unconditional_conditioning(batch)
        shape = (b, 128, 128, 4)
        g = torch.Generator("cuda")

        def sample(num_steps=None):
            return engine.sample(c, uc, shape, num_steps=num_steps, generator=g.manual_seed(b))

        sample(2)  # warm: the allocator and the library's algorithm choices at this batch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        latents = sample()
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        check_launches(launches, step_totals(rows, f"sdxl_sample{b}"), SAMPLE_STEPS, f"{label}: UNet call")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        images = engine.decode_first_stage(latents)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_launches = ops.launch_counts()
        check_launches(decode_launches, step_totals(rows, f"sdxl_decode{b}"), 1, f"{label}: decode")
        peak = torch.cuda.max_memory_allocated()
        for what, x, want in (("latents", latents, shape), ("images", images, (b, 1024, 1024, 3))):
            if tuple(x.shape) != want or not bool(torch.isfinite(x).all()):
                raise PhaseError(f"{label}: {what} {tuple(x.shape)}, not {want}, finite: {bool(torch.isfinite(x).all())}")
        print(f"{label}: sampler {sample_s:.3f} s ({sample_s / b:.3f} s an image, {60 * b / sample_s:.2f} images a "
              f"minute), decode {decode_s * 1e3:.1f} ms, with the decode {(sample_s + decode_s) / b:.3f} s an image; "
              f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); images mean {float(images.mean()):.4f} "
              f"std {float(images.std()):.4f}", flush=True)
        del images
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(SAMPLE_SPAN):
                sample(1)
                torch.cuda.synchronize()
        step = step_profiles(torch, prof, SAMPLE_SPAN)[0]
        del prof
        if step["device_ms"] is None:
            print(f"{label}: the profiler recorded no device kernels in the step: device time not measured", flush=True)
        else:
            kinds = ", ".join(f"{k} {ms:.3f}" for k, ms in sorted(step["kinds_ms"].items(), key=lambda kv: -kv[1]))
            print(f"{label}: one sampler step (one UNet call at batch {2 * b}), device busy {step['device_ms']:.3f} "
                  f"ms in {step['launches']} kernels; by kind: {kinds}", flush=True)
        t0 = time.perf_counter()
        whole = profile_fn(torch, sample, f"{label}, whole call ({SAMPLE_STEPS} steps)", sample_s * 1e3, top=8,
                           host=False)
        print(f"{label}: the whole call's profile took {time.perf_counter() - t0:.1f} s", flush=True)
        decode = profile_fn(torch, lambda: engine.decode_first_stage(latents), f"{label}, decode", decode_s * 1e3,
                            top=8)
        out[f"sdxl_sample{b}"] = dict(launches=launches, seconds=sample_s, s_per_image=sample_s / b,
                                      images_per_min=60 * b / sample_s, peak_bytes=peak, step_profile=step,
                                      profile=whole)
        out[f"sdxl_decode{b}"] = dict(launches=decode_launches, ms=decode_s * 1e3, profile=decode)
        del latents
        torch.cuda.empty_cache()
    return out


def run_cli_sampling(torch, rows: dict) -> dict:
    """Phase 13, in CLI_DIR after phase 11 (its image folder): predict of
    sdxl.example.yaml as written with trainer.allow_random_weights added;
    fit of its bf16-mixed copy for 2 steps with an image_logger: node (every
    2 steps, the first step too, 2 images, 4 sampler steps); fit of
    vae.example.yaml with one, 1 step. Every PNG is read back with the
    port's reader; every decode and reconstruction must be finite."""
    import os

    from neurosis_tpu_torch.trainer.engine import DiffusionEngine
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    repo = Path.cwd().resolve()
    sdxl, vae = repo / "configs/sdxl/sdxl.example.yaml", repo / "configs/vae/vae.example.yaml"
    written = "  fast_dev_run: true  # disable to actually train\n"
    text = sdxl.read_text()
    predict_cfg = (CLI_DIR / "sdxl-predict.yaml").resolve()
    predict_cfg.write_text(text.replace(written, written + "  allow_random_weights: true\n"))
    node = ("\nimage_logger:\n  every_n_train_steps: 2\n  max_images: {n}\n  log_first_step: true\n"
            "  log_func_kwargs:\n    num_steps: {steps}\n")
    logger_cfg = (CLI_DIR / "sdxl-bf16-image-logger.yaml").resolve()
    logger_cfg.write_text(text.replace(written, "  fast_dev_run: false\n  max_steps: 2\n  precision: bf16-mixed\n")
                          + node.format(n=LOGGER_IMAGES, steps=LOGGER_STEPS))
    vae_cfg = (CLI_DIR / "vae-image-logger.yaml").resolve()
    vae_cfg.write_text(vae.read_text() + node.format(n=2, steps=LOGGER_STEPS))

    not_finite = []
    originals = DiffusionEngine.decode_first_stage, AutoencodingEngine.forward

    def decode(self, z):
        x = originals[0](self, z)
        if not bool(torch.isfinite(x).all()):
            not_finite.append(f"decode {tuple(x.shape)}")
        return x

    def forward(self, *args, **kwargs):
        z, recons, reg = originals[1](self, *args, **kwargs)
        if not bool(torch.isfinite(recons).all()):
            not_finite.append(f"reconstruction {tuple(recons.shape)}")
        return z, recons, reg

    out = {}
    cwd, hash_env = os.getcwd(), os.environ.get("NEUROSIS_ALLOW_HASH_TOKENIZER")
    os.chdir(CLI_DIR)
    DiffusionEngine.decode_first_stage, AutoencodingEngine.forward = decode, forward
    try:
        os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = "1"
        out["cli_predict"] = run_predict(torch, rows, predict_cfg)
        run = run_cli(torch, rows, logger_cfg, "CLI fit sdxl bf16-mixed with an image logger", "cli_sdxl_bf16", 2,
                      profiled=False, logger=("cli_logger", 2))
        check_pngs(run["images"], {f"gs{s:06d}_e0000_b{s:06d}_{k}_{i:02d}.png": (1024, 1024, 3)
                                   for s in (1, 2) for k in ("conditioning", "inputs", "reconstructions", "samples")
                                   for i in range(LOGGER_IMAGES)},
                   [f"gs{s:06d}_e0000_b{s:06d}_samples_grid.png" for s in (1, 2)], "the SDXL image logger")
        out["cli_sdxl_bf16_image_logger"], out["cli_logger"] = run, dict(launches=run.pop("logger_launches"))
        run = run_cli(torch, rows, vae_cfg, "CLI fit vae.example.yaml with an image logger", "cli_vae", 1,
                      profiled=False, logger=("cli_vae_logger", 1))
        check_pngs(run["images"], {**{f"gs000001_e0000_b000001_{k}_{i:02d}.png": (256, 256, 3)
                                      for k in ("inputs", "reconstructions", "diff", "diff_boost") for i in (0, 1)},
                                   **{f"gs000001_e0000_b000001_{k}_00.png": (2 * 256 + 24, 2 * 256, 3)
                                      for k in ("vis_logits", "vis_logits_blended")}}, [], "the VAE image logger")
        out["cli_vae_image_logger"], out["cli_vae_logger"] = run, dict(launches=run.pop("logger_launches"))
    finally:
        DiffusionEngine.decode_first_stage, AutoencodingEngine.forward = originals
        os.chdir(cwd)
        if hash_env is None:
            os.environ.pop("NEUROSIS_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = hash_env
    if not_finite:
        raise PhaseError(f"phase 13 made non-finite images: {not_finite}")
    return out


def check_pngs(folder: Path, sized: dict, grids: list, label: str) -> None:
    """``folder`` holds exactly the PNGs ``sized`` ({name: shape}) and
    ``grids`` names; each reads back as RGB at its shape (a grid: wider and
    taller than one image) and is not one flat colour."""
    from neurosis_tpu_torch.data.png import read_png

    names = sorted(p.name for p in folder.iterdir())
    if names != sorted([*sized, *grids]):
        raise PhaseError(f"{label} wrote {names}, not {sorted([*sized, *grids])}")
    for name in names:
        px, mode, _ = read_png(folder / name)
        want = sized.get(name)
        ok = mode == "RGB" and (tuple(px.shape) == want if want else px.shape[0] > 1024 and px.shape[1] > 1024)
        if not ok or int(px.max()) == int(px.min()):
            raise PhaseError(f"{label}: {name} is {mode} {px.shape} in [{px.min()}, {px.max()}], not {want or 'a grid'}")
    print(f"{label}: {len(names)} PNGs read back ({', '.join(names[:3])}, ...)", flush=True)


def run_predict(torch, rows: dict, config: Path) -> dict:
    """python -m neurosis_tpu_torch predict -c config in this process (its
    main()): PREDICT_PROMPTS, PREDICT_STEPS steps, 1024 px, into predict/;
    its launches held to the tables, its PNGs read back."""
    import gc
    import shutil

    from neurosis_tpu_torch import ops
    from neurosis_tpu_torch.trainer import cli

    for folder in ("projects", "predict"):
        shutil.rmtree(folder, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    argv = ["predict", "-c", str(config), "--steps", str(PREDICT_STEPS), "--size", "1024", "--out", "predict"]
    for prompt in PREDICT_PROMPTS:
        argv += ["--prompt", prompt]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise PhaseError(f"CLI predict: main() returned {rc}")
    print(f"CLI predict of sdxl.example.yaml (fp32 UNet), {len(PREDICT_PROMPTS)} prompts, {PREDICT_STEPS} steps: "
          f"{seconds:.1f} s in main() (the engine's build included), peak device memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB)", flush=True)
    check_launches(launches, step_totals(rows, "cli_predict"), 1, "CLI predict")
    check_pngs(Path("predict"), {f"sample_{i:03d}.png": (1024, 1024, 3) for i in range(len(PREDICT_PROMPTS))},
               ["grid.png"], "CLI predict")
    return dict(launches=launches, seconds=seconds, peak_bytes=peak)


# ---------------------------------------------------------------------------
# phase 14: a training run that lasts
# ---------------------------------------------------------------------------


def bits_checksum(torch, tensors) -> int:
    """The sum of every fp32 word's bit pattern as an integer: exact, and
    independent of the order and the device it is summed in."""
    return sum(int(t.detach().reshape(-1).view(torch.int32).to(torch.int64).sum()) for t in tensors)


def check_adamw8bit(torch, log: list) -> dict:
    """(c) One update of AdamW8bit on the card and on the CPU from the same
    leaf and grad: ADAMW8BIT_SHAPES, a bigG token embedding (8-bit state) and
    a leaf under min_8bit_size (fp32 state). log10 and round on the card and
    on the CPU can differ by an ulp, which moves a code by 1 at a rounding
    boundary, so: codes within 1 and equal on at least 99.9%, scales within
    1e-6 of their own, the dequantized moments within 1e-5 of their block's
    scale where the codes agree and within one code step (13.8% of the value
    for m, 9.5% for v) where they do not, fp32 moments within 1e-6 relative
    and the parameters within 1e-5·lr of each other (the update itself uses
    the fp32 moments; only the stored state is quantized). A second update
    is not compared: a code moved by 1 moves m by 13.8%, and where the next
    grad nearly cancels m the two sides' m can then differ in sign."""
    from neurosis_tpu_torch.optimizers.adamw8bit import AdamW8bit, dequantize_signed, dequantize_unsigned

    g = torch.Generator().manual_seed(14)
    lr, out = 1e-3, {}
    for shape in ADAMW8BIT_SHAPES:
        p0 = torch.randn(shape, generator=g) * 0.02
        grad = torch.randn(shape, generator=g) * 1e-3
        runs = {}
        for dev in ("cpu", "cuda"):
            p = torch.nn.Parameter(p0.clone().to(dev))
            opt = AdamW8bit([p], learning_rate=lr, weight_decay=1e-2)
            p.grad = grad.to(dev)
            opt.step()
            runs[dev] = (p.detach().cpu(), {k: v.cpu() for k, v in opt.state[p].items()})
        (p_cpu, s_cpu), (p_gpu, s_gpu) = runs["cpu"], runs["cuda"]
        label = f"AdamW8bit {shape}"
        row = dict(shape=shape, param_err_over_lr=float((p_gpu - p_cpu).abs().max()) / lr)
        if "mu_codes" in s_cpu:
            for key, deq, step in (("mu", dequantize_signed, 10 ** (7 / 126) - 1),
                                   ("nu", dequantize_unsigned, 10 ** (10 / 254) - 1)):
                codes = (s_gpu[f"{key}_codes"].int() - s_cpu[f"{key}_codes"].int()).abs()
                scale_err = float(((s_gpu[f"{key}_scale"] - s_cpu[f"{key}_scale"]).abs()
                                   / s_cpu[f"{key}_scale"].clamp_min(1e-30)).max())
                m_gpu = deq(s_gpu[f"{key}_codes"], s_gpu[f"{key}_scale"], shape).reshape(-1)
                m_cpu = deq(s_cpu[f"{key}_codes"], s_cpu[f"{key}_scale"], shape).reshape(-1)
                n = m_cpu.numel()
                same = (codes.reshape(-1)[:n] == 0)
                block = s_cpu[f"{key}_scale"].expand(-1, s_cpu[f"{key}_codes"].shape[1]).reshape(-1)[:n]
                err_same = float(((m_gpu - m_cpu).abs() / block.clamp_min(1e-30))[same].max())
                err_diff = float(((m_gpu - m_cpu).abs() / m_cpu.abs().clamp_min(1e-30))[~same].max()) \
                    if bool((~same).any()) else 0.0
                row[key] = dict(max_code_diff=int(codes.max()), code_diff_share=float((codes > 0).float().mean()),
                                scale_rel_err=scale_err, deq_err_same=err_same, deq_rel_err_flipped=err_diff)
                ok = (int(codes.max()) <= 1 and row[key]["code_diff_share"] <= 1e-3 and scale_err <= 1e-6
                      and err_same <= 1e-5 and err_diff <= step * 1.001)
                log.append(f"{label} {key}: codes differ by at most {int(codes.max())} on "
                           f"{row[key]['code_diff_share']:.2e} of them, scales {scale_err:.2e}, dequantized "
                           f"{err_same:.2e} of the block scale where equal, {err_diff:.3e} relative where not "
                           f"(one step {step:.3f}) {'ok' if ok else 'FAILED'}")
                print(log[-1], flush=True)
                if not ok:
                    raise PhaseError(f"{label}: the card's {key} state disagrees with the CPU's")
        else:
            for key in ("mu", "nu"):
                rel = float(((s_gpu[key] - s_cpu[key]).abs() / s_cpu[key].abs().clamp_min(1e-30)).max())
                row[key] = dict(rel_err=rel)
                check(f"{label} fp32 {key}", rel, 1e-6, log)
        check(f"{label} parameters, max |card - CPU| / lr", row["param_err_over_lr"], 1e-5, log)
        out[str(shape)] = row
    return out


def run_te_phase(torch, rows: dict) -> dict:
    """Phase 14, in CLI_DIR after phase 13 (its image folder): (a) fit of a
    copy of sdxl-te.example.yaml that differs only in fast_dev_run false,
    max_steps 3 and a model_checkpoint: node (every 2 steps, keep 1), its
    third step profiled, the save at step 2 timed; (b) fit of the same with
    max_steps 4 in the same projects/: it resumes at step 2 (its parameters'
    checksum equal to the saved file's, the optimizer's count 2, each
    group's lr its base x sched(2)) and logs steps 3 and 4; then one more
    8-bit update on its last grads, timed and profiled; (c) check_adamw8bit;
    (d) each run's kernel launches equal its steps x cli_sdxl_te's tables.
    The run directory is deleted afterwards, also when the phase fails."""
    import os
    import shutil

    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.schedulers import legacy_cosine_annealing_warmup_restarts
    from neurosis_tpu_torch.trainer.callbacks import STATE_FILE, CheckpointCallback, load_checkpoint
    from neurosis_tpu_torch.trainer.loop import Trainer

    repo = Path.cwd().resolve()
    te = repo / "configs/sdxl/sdxl-te.example.yaml"
    written = "  fast_dev_run: true  # disable to actually train\n"
    text = te.read_text()
    if text.count(written) != 1:
        raise PhaseError(f"{te} no longer has the line {written!r}")
    node = f"\nmodel_checkpoint:\n  every_n_train_steps: {TE_EVERY}\n  save_top_k: 1\n"
    cfgs = {}
    for n in (TE_SAVE_STEPS, TE_RESUME_STEPS):
        cfgs[n] = (CLI_DIR / f"sdxl-te-{n}-steps.yaml").resolve()
        cfgs[n].write_text(text.replace(written, f"  fast_dev_run: false\n  max_steps: {n}\n") + node)
    want = load_config(te)
    want["trainer"].update(fast_dev_run=False, max_steps=TE_SAVE_STEPS)
    want["model_checkpoint"] = {"every_n_train_steps": TE_EVERY, "save_top_k": 1}
    if load_config(cfgs[TE_SAVE_STEPS]) != want:
        raise PhaseError("the copy of sdxl-te.example.yaml differs in more than its three keys")
    # YAML 1.1 reads min_lr 3e-7 as a string; the builder casts it, and so does this check
    sched = legacy_cosine_annealing_warmup_restarts(**{k: float(v) if isinstance(v, str) else v for k, v in
                                                       want["model"]["init_args"]["scheduler"]["init_args"].items()})

    started, resume_s = [], []
    inner_start, inner_resume = Trainer._start, Trainer._maybe_resume

    def start(self, what):
        state = inner_start(self, what)
        opt = state.optimizer
        started.append(dict(trainer=self, state=state, step=int(state.step), count=opt.count,
                            groups=[(g["base_lr"], g["lr"], g["schedule_count"], len(g["params"]))
                                    for g in opt.param_groups],
                            checksum=bits_checksum(torch, self.engine.trainable_parameters())))
        return state

    def resume(self, state):
        t0 = time.perf_counter()
        state = inner_resume(self, state)
        torch.cuda.synchronize()
        resume_s.append(time.perf_counter() - t0)
        return state

    out = {}
    cwd, hash_env = os.getcwd(), os.environ.get("NEUROSIS_ALLOW_HASH_TOKENIZER")
    os.chdir(CLI_DIR)
    Trainer._start, Trainer._maybe_resume = start, resume
    try:
        os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = "1"
        ckpt = Path("projects/checkpoints")
        out["save_run"] = run_cli(torch, rows, cfgs[TE_SAVE_STEPS], "CLI fit sdxl-te (save)", "cli_sdxl_te",
                                  TE_SAVE_STEPS, profiled=False, profile_step=TE_SAVE_STEPS, device_only=True)
        first = started.pop()
        saver = next(cb for cb in first["trainer"].callbacks if isinstance(cb, CheckpointCallback))
        n_params = sum(p.numel() for p in first["trainer"].engine.trainable_parameters())
        groups = [g[3] for g in first["groups"]]
        del first
        steps_saved = sorted(int(d.name) for d in ckpt.iterdir())
        if steps_saved != [TE_EVERY]:
            raise PhaseError(f"the save run left checkpoints {steps_saved}, not [{TE_EVERY}]")
        path = ckpt / str(TE_EVERY) / STATE_FILE
        disk = shutil.disk_usage(ckpt)
        t0 = time.perf_counter()
        payload = load_checkpoint(path)
        file_sum = bits_checksum(torch, payload["params"].values())
        sum_s = time.perf_counter() - t0
        saved = dict(bytes=path.stat().st_size, save_s=saver.last_save_s, disk_free_after=disk.free,
                     disk_total=disk.total, trainable_params=n_params, param_groups=groups,
                     step=payload["step"], count=payload["opt_state"]["count"])
        del payload
        print(f"sdxl-te checkpoint at step {saved['step']}: {saved['bytes']} bytes in {saved['save_s']:.1f} s; "
              f"{n_params} trainable parameters in groups of {groups}; disk free after {disk.free} of "
              f"{disk.total} bytes; the file's checksum read in {sum_s:.1f} s", flush=True)
        if saved["step"] != TE_EVERY or saved["count"] != TE_EVERY:
            raise PhaseError(f"the checkpoint holds step {saved['step']}, count {saved['count']}")

        out["resume_run"] = run_cli(torch, rows, cfgs[TE_RESUME_STEPS], "CLI fit sdxl-te (resume)", "cli_sdxl_te",
                                    TE_RESUME_STEPS - TE_EVERY, profiled=False, first_step=TE_EVERY + 1)
        second = started.pop()
        lrs = [(base * float(sched(TE_EVERY)), lr, count) for base, lr, count, _n in second["groups"]]
        resumed = dict(step=second["step"], count=second["count"], lrs=lrs, load_s=resume_s[-1],
                       checksum_equal=second["checksum"] == file_sum)
        print(f"sdxl-te resumed at step {second['step']} in {resume_s[-1]:.1f} s: optimizer count "
              f"{second['count']}, lr (want, have, schedule count) {lrs}, parameters' checksum "
              f"{'equal to' if resumed['checksum_equal'] else 'DIFFERENT from'} the file's", flush=True)
        if not (resumed["checksum_equal"] and second["step"] == TE_EVERY and second["count"] == TE_EVERY
                and all(want_lr == lr and c == TE_EVERY for want_lr, lr, c in lrs)):
            raise PhaseError(f"the resumed run did not restore the saved state: {resumed}")
        steps_saved = sorted(int(d.name) for d in ckpt.iterdir())
        if steps_saved != [TE_RESUME_STEPS]:
            raise PhaseError(f"the resumed run left checkpoints {steps_saved}, not [{TE_RESUME_STEPS}]")

        # the 8-bit update alone, on the last step's grads
        opt, state = second["state"].optimizer, second["state"]
        del second
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        update = profile_fn(torch, opt.step, "sdxl-te AdamW8bit update", host_ms, top=10)
        out["adamw8bit_update"] = dict(host_ms=host_ms, device_ms=update.get("device_ms"),
                                       launches=update.get("launches"), kinds_ms=update.get("kinds_ms"))
        print(f"sdxl-te AdamW8bit update alone: host {host_ms:.1f} ms, device busy {update.get('device_ms')} ms in "
              f"{update.get('launches')} kernels", flush=True)
        del opt, state
        out["saved"], out["resumed"] = saved, resumed
    finally:
        Trainer._start, Trainer._maybe_resume = inner_start, inner_resume
        shutil.rmtree("projects", ignore_errors=True)
        os.chdir(cwd)
        if hash_env is None:
            os.environ.pop("NEUROSIS_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = hash_env
    out["adamw8bit_card_vs_cpu"] = check_adamw8bit(torch, [])
    out["launches"] = {k: out["save_run"]["launches"][k] + out["resume_run"]["launches"][k]
                       for k in out["save_run"]["launches"]}
    return out


# ---------------------------------------------------------------------------
# phase 15: the SD training path's options
# ---------------------------------------------------------------------------


def _edit(text: str, edits: list, source: str) -> str:
    """``text`` with each (old, new) replaced; each old must occur once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise PhaseError(f"{source} no longer has {old!r} once")
        text = text.replace(old, new)
    return text


def phase15_configs(repo: Path) -> dict:
    """{name: YAML text} of phase 15's copies: ``sdxl-vpred`` (the bf16-mixed
    SDXL copy as a v-prediction zero-terminal-SNR fine-tune: VPreconditioning
    over TanZeroSNRDiscretization in the denoiser, the σ sampler and the
    sampler, min-SNR-γ 5 over EDMWeighting with v_pred, noise offset 0.0357
    at chance 1 (at JAX's default chance 0 the offset would never be drawn),
    caption dropout 0.1 on CLIP-L and bigG, remat [none, none, dots_names],
    Adafactor beta1 0.9 and weight decay 0.01, configs/hook/loss_scale.example.yml's
    forward_hooks under model:, max_steps 3 and an image logger at step 2),
    ``sdxl-remat`` (phase 11's two-step bf16 copy with that remat policy and
    nothing else, the remat pair's other half), ``sd15-edm`` and ``sd15-rf``
    (sd15.example.yaml as written, 2 steps, with
    the EDM objective, and with the comfy rectified-flow objective, L1, and an
    image logger at step 2 whose sampler has rf_safeguard)."""
    sdxl, sd15 = (repo / "configs/sdxl/sdxl.example.yaml").read_text(), (repo / "configs/sd15/sd15.example.yaml").read_text()
    hook = (repo / "configs/hook/loss_scale.example.yml").read_text()
    hooks = hook[hook.index("    forward_hooks:\n"):]
    ddpm = "class_path: neurosis.modules.diffusion.LegacyDDPMDiscretization"
    tan = "class_path: neurosis.modules.diffusion.TanZeroSNRDiscretization"
    logger = ("\nimage_logger:\n  every_n_train_steps: 2\n  max_images: {n}\n  log_first_step: false\n"
              "  log_func_kwargs:\n    num_steps: {steps}\n")
    vpred = _edit(sdxl, [
        ("  fast_dev_run: true  # disable to actually train\n",
         f"  fast_dev_run: false\n  max_steps: {VPRED_STEPS}\n  precision: bf16-mixed\n"),
        ("    use_ema: false\n", "    use_ema: false\n" + hooks),
        ("        use_checkpoint: true\n",
         "        use_checkpoint: true\n        remat_policy: [" + ", ".join(VPRED_REMAT) + "]\n"),
        ("          class_path: neurosis.modules.diffusion.EpsPreconditioning\n",
         "          class_path: neurosis.modules.diffusion.VPreconditioning\n"),
        ("              is_trainable: false\n          # crossattn + vector",
         "              is_trainable: false\n              ucg_rate: 0.1\n          # crossattn + vector"),
        ("              legacy: false\n", "              legacy: false\n              ucg_rate: 0.1\n"),
        ("        warmup_init: true\n", "        warmup_init: true\n        beta1: 0.9\n        weight_decay: 0.01\n"),
        ("        loss_weighting:\n          class_path: neurosis.modules.diffusion.EpsWeighting\n",
         "        noise_offset: 0.0357\n        noise_offset_chance: 1.0\n        loss_weighting:\n"
         "          class_path: neurosis.modules.diffusion.MinSNRGammaModifier\n          init_args:\n"
         "            gamma: 5.0\n            v_pred: true\n            weighting:\n"
         "              class_path: neurosis.modules.diffusion.EDMWeighting\n"),
    ], "sdxl.example.yaml").replace(ddpm, tan) + logger.format(n=LOGGER_IMAGES, steps=LOGGER_STEPS)
    two = ("  fast_dev_run: true\n", f"  fast_dev_run: false\n  max_steps: {OPTION_STEPS}\n")
    denoiser = ("      class_path: neurosis.modules.diffusion.DiscreteDenoiser\n      init_args:\n        num_idx: 1000\n"
                "        preconditioning:\n          class_path: neurosis.modules.diffusion.EpsPreconditioning\n"
                f"        discretization:\n          {ddpm}\n")
    weighting = "        loss_weighting:\n          class_path: neurosis.modules.diffusion.EpsWeighting\n"
    sampling = ("          class_path: neurosis.modules.diffusion.sigma_sampling.DiscreteSampling\n          init_args:\n"
                f"            num_idx: 1000\n            discretization:\n              {ddpm}\n")

    def continuous(pre: str) -> str:
        return f"      class_path: neurosis.modules.diffusion.Denoiser\n      init_args:\n        preconditioning:\n" \
               f"          class_path: neurosis.modules.diffusion.{pre}\n"

    edm = _edit(sd15, [two, (denoiser, continuous("EDMPreconditioning")),
                       (weighting, weighting.replace("EpsWeighting", "EDMWeighting")),
                       (sampling, "          class_path: neurosis.modules.diffusion.sigma_sampling.EDMSampling\n")],
                "sd15.example.yaml")
    rf = _edit(sd15, [two, (denoiser, continuous("RectifiedFlowComfyPreconditioning")),
                      (weighting, "        objective_type: rf\n        loss_type: l1\n"
                                  + weighting.replace("EpsWeighting", "RectifiedFlowComfyWeighting")),
                      (sampling, "          class_path: neurosis.modules.diffusion.sampling.sigma_generators."
                                 "RectifiedFlowComfySigmaGenerator\n"),
                      ("        num_steps: 50\n        discretization:\n" f"          {ddpm}\n",
                       "        num_steps: 50\n        rf_safeguard: true\n        discretization:\n"
                       "          class_path: neurosis.modules.diffusion.RectifiedFlowComfyDiscretization\n")],
               "sd15.example.yaml") + logger.format(n=1, steps=LOGGER_STEPS)
    remat = _edit(sdxl, [("  fast_dev_run: true  # disable to actually train\n",
                          "  fast_dev_run: false\n  max_steps: 2\n  precision: bf16-mixed\n"),
                         ("        use_checkpoint: true\n",
                          "        use_checkpoint: true\n        remat_policy: [" + ", ".join(VPRED_REMAT) + "]\n")],
                  "sdxl.example.yaml")
    return {"sdxl-vpred": vpred, "sdxl-remat": remat, "sd15-edm": edm, "sd15-rf": rf}


OPTION_ENGINES = ("v", "edm", "rf_xl", "rf_comfy", "unet_variants")
# the UNet variants' engine: fp32 (the fp32 flash kernels), scale-shift norm, ResBlock
# up/down sampling, 2 ResBlocks a level with one attention block at level 0, and a
# class-count label embedding fed the batch's class ids through the loss's input_keys
VARIANT_UNET = dict(SMALL_UNET, num_res_blocks=2, use_scale_shift_norm=True, resblock_updown=True,
                    num_attention_blocks=[1, 1], num_classes=10)


def make_option_engine(torch, device, seed: int, kind: str):
    """A small engine of one objective of the SD path: ``v`` (v-prediction
    over the tan zero-terminal-SNR table, min-SNR-γ over EDM weighting, noise
    offset, remat names and dots_names), ``edm``, ``rf_xl`` and ``rf_comfy``
    (objective rf; comfy with L1), each with a bf16 UNet of SMALL_UNET's
    dims, and ``unet_variants`` (VARIANT_UNET in fp32, eps over LegacyDDPM)."""
    from neurosis_tpu_torch.diffusion import discretization as dz
    from neurosis_tpu_torch.diffusion import preconditioning as pc
    from neurosis_tpu_torch.diffusion import sigma_generators as sg
    from neurosis_tpu_torch.diffusion import weighting as wt
    from neurosis_tpu_torch.diffusion.denoiser import Denoiser, DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenCLIPEmbedder, GeneralConditioner
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor
    from neurosis_tpu_torch.trainer.engine import DiffusionEngine

    g = torch.Generator(device).manual_seed(seed)
    unet = dict(VARIANT_UNET) if kind == "unet_variants" else dict(SMALL_UNET)
    if kind == "v":
        unet["remat_policy"] = ["dots_names", "names"]
    model = UNetModel(**unet, use_checkpoint=True, dtype=None if kind == "unet_variants" else torch.bfloat16,
                      device=device, generator=g)
    loss_kw = {}
    if kind == "v":
        tan = dz.TanZeroSNRDiscretization()
        denoiser = DiscreteDenoiser(pc.VPreconditioning(), 1000, tan, device=device)
        gen, weight = sg.DiscreteSigmaGenerator(tan, 1000, device=device), \
            wt.MinSNRGammaModifier(wt.EDMWeighting(), 5.0, v_pred=True)
        loss_kw = dict(noise_offset=0.0357, noise_offset_chance=1.0)
    elif kind == "edm":
        denoiser, gen, weight = Denoiser(pc.EDMPreconditioning()), sg.EDMSigmaGenerator(), wt.EDMWeighting()
    elif kind == "rf_xl":
        denoiser, gen, weight = Denoiser(pc.RectifiedFlowXLPreconditioning()), sg.RectifiedFlowSigmaGenerator(), \
            wt.RectifiedFlowWeighting()
        loss_kw = dict(objective_type="rf")
    elif kind == "rf_comfy":
        denoiser, gen, weight = Denoiser(pc.RectifiedFlowComfyPreconditioning()), \
            sg.RectifiedFlowComfySigmaGenerator(), wt.RectifiedFlowComfyWeighting()
        loss_kw = dict(objective_type="rf", loss_type="l1")
    else:
        ddpm = dz.LegacyDDPMDiscretization()
        denoiser = DiscreteDenoiser(pc.EpsPreconditioning(), 1000, ddpm, device=device)
        gen, weight = sg.DiscreteSigmaGenerator(ddpm, 1000, device=device), wt.EpsWeighting()
        loss_kw = dict(input_keys=["y"])
    return DiffusionEngine(
        model=model, denoiser=denoiser, loss_fn=StandardDiffusionLoss(gen, weight, **loss_kw),
        conditioner=GeneralConditioner([FrozenCLIPEmbedder(**SMALL_CLIP, device=device, generator=g)]),
        optimizer=lambda params: Adafactor(params, scale_parameter=True, relative_step=True, warmup_init=True,
                                           beta1=0.9, weight_decay=0.01),
        use_ema=False, device=device, log_sigmas=True)


def reference_options(torch, log: list) -> dict:
    """Phase 15 (a): one train step of each OPTION_ENGINES engine on the card
    against the same step on the CPU (plain versions there), with the same
    t, noise and offset; bf16 UNets to 2e-2 (loss) and 5e-2 (grad norm),
    the fp32 one to 1e-3 and 1e-2. Each step launches every kernel its UNet
    takes (the fp32 one: the fp32 flash kernels). Then ops.groupnorm's
    function against GroupNorm32's plain path on the card, forward and
    grads, at an SDXL level-1 shape in fp32 (1e-5) and bf16 (2e-2)."""
    from neurosis_tpu_torch import ops

    out = {}
    for kind in OPTION_ENGINES:
        engines = {device: make_option_engine(torch, device, 1, kind) for device in ("cpu", "cuda")}
        g = torch.Generator("cpu").manual_seed(2)
        for p_cpu, p_gpu in zip(engines["cpu"].model.parameters(), engines["cuda"].model.parameters()):
            with torch.no_grad():
                p_cpu.add_(0.02 * torch.randn(p_cpu.shape, generator=g))
                p_gpu.copy_(p_cpu)
        for p_cpu, p_gpu in zip(engines["cpu"].conditioner.parameters(), engines["cuda"].conditioner.parameters()):
            with torch.no_grad():
                p_gpu.copy_(p_cpu)
        batch = make_batch(torch, "cpu", 2, 32, 3)
        batch["y"] = torch.tensor([3, 7])
        t = torch.tensor([0.3, 0.8])
        noise = torch.randn(batch["latents"].shape, generator=torch.Generator("cpu").manual_seed(4))
        offset = torch.randn(2, 32, 1, 1, generator=torch.Generator("cpu").manual_seed(5))
        before, metrics = ops.launch_counts(), {}
        for device, eng in engines.items():
            state = eng.init(seed=0)
            _, m = eng.train_step(state, {k: v.to(device) for k, v in batch.items()}, t=t.to(device),
                                  noise=noise.to(device), offset=offset.to(device))
            metrics[device] = {k: float(v) for k, v in m.items()}
        launched = {k: ops.launch_counts()[k] - before[k] for k in before}
        label = f"phase 15 {kind} engine"
        print(f"{label} step launches: {launched}", flush=True)
        fp32 = kind == "unet_variants"
        want = ("flash_fwd_f32", "flash_bwd_f32") if fp32 else ("flash_fwd", "flash_bwd", "conv3x3", "gn_silu_conv3x3")
        missing = [k for k in want if not launched[k]]
        if missing:
            raise PhaseError(f"the {label} did not launch {missing}: {launched}")
        for key, tol in (("loss", 1e-3 if fp32 else 2e-2), ("grad_norm", 1e-2 if fp32 else 5e-2)):
            cpu, gpu = metrics["cpu"][key], metrics["cuda"][key]
            check(f"{label} {key}: cuda {gpu:.6g} vs cpu {cpu:.6g}", abs(gpu - cpu) / abs(cpu), tol, log)
        if not all(math.isfinite(v) for m in metrics.values() for v in m.values()):
            raise PhaseError(f"{label}: a metric is not finite: {metrics}")
        out[kind] = dict(metrics=metrics, launches=launched)
        del engines
        torch.cuda.empty_cache()
    out["groupnorm"] = check_groupnorm(torch, log)
    return out


def check_groupnorm(torch, log: list) -> dict:
    """ops.groupnorm.group_norm against GroupNorm32's plain path on the card."""
    from neurosis_tpu_torch.modules.layers import GroupNorm32
    from neurosis_tpu_torch.ops.groupnorm import group_norm

    out = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        g = torch.Generator("cuda").manual_seed(9)
        norm = GroupNorm32(640, 32, device="cuda")
        with torch.no_grad():
            norm.weight.copy_(1.0 + 0.1 * torch.randn(640, generator=g, device="cuda"))
            norm.bias.copy_(0.1 * torch.randn(640, generator=g, device="cuda"))
        x = (2.0 * torch.randn(2, 64, 64, 640, generator=g, device="cuda") + 0.5).to(dtype)
        dy = torch.randn(2, 64, 64, 640, generator=g, device="cuda").to(dtype)
        results = []
        for fn in (lambda xi: norm(xi), lambda xi: group_norm(xi, norm.weight, norm.bias, 32, norm.eps)):
            xi = x.clone().requires_grad_(True)
            norm.zero_grad()
            y = fn(xi)
            y.backward(dy)
            results.append((y.detach(), xi.grad, norm.weight.grad.clone(), norm.bias.grad.clone()))
        tag = "fp32" if dtype == torch.float32 else "bf16"
        worst = 0.0
        for what, got, want in zip(("y", "dx", "dscale", "dbias"), results[1], results[0]):
            err, rel = rel_err(got, want)
            check(f"groupnorm function {tag} {what}", rel, tol, log, err)
            worst = max(worst, rel)
        out[tag] = worst
    return out


def write_tagged_captions(folder: Path) -> None:
    """The image folder's captions as space-separated tags that the tag hook
    of configs/hook/loss_scale.example.yml counts and rewards: artist and
    character tags (counted), masterpiece and lowres (rewarded)."""
    tags = ["artist:alpha", "artist:beta", "character:gamma", "masterpiece", "lowres", "outdoors", "portrait"]
    for i, txt in enumerate(sorted(folder.glob("*.txt"))):
        txt.write_text(" ".join(tags[j % len(tags)] for j in range(i, i + 3 + i % 3)))


def run_options_phase(torch, rows: dict, report: dict, log: list) -> dict:
    """Phase 15, in CLI_DIR after phase 14 (its image folder, its captions
    rewritten as tags): (a) reference_options; (b) fit of phase15_configs'
    sdxl-vpred copy for 3 steps, the third profiled, its image logger's call
    at step 2 read apart (cli_logger's tables), every step's metrics line
    with the tag hook's train/tag_loss_scale_mean and finite losses, the
    launches held to REMAT_TABLES' table; (c) the remat pair: fit of the
    sdxl-remat copy, 2 steps, the second profiled (a profile of two SDXL steps
    takes ~70 s to read back), its device time and
    peak memory beside phase 11's profiled bf16 copy under full remat (the
    same config but the policy); (d) fits of
    the sd15-edm and sd15-rf copies for 2 steps each (sd15_f32's tables; the
    rf copy's logger call held to cli_sd15_logger's)."""
    import os

    from neurosis_tpu_torch.config.loader import load_config

    out = {"reference_options": reference_options(torch, log)}
    write_tagged_captions(CLI_DIR / "data" / "dataset" / "folder")
    paths = {}
    for name, text in phase15_configs(Path.cwd().resolve()).items():
        paths[name] = (CLI_DIR / f"{name}.yaml").resolve()
        paths[name].write_text(text)
        load_config(paths[name])  # reads back
    cwd, hash_env = os.getcwd(), os.environ.get("NEUROSIS_ALLOW_HASH_TOKENIZER")
    os.chdir(CLI_DIR)
    try:
        os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = "1"
        run = run_cli(torch, rows, paths["sdxl-vpred"], "CLI fit sdxl v-prediction copy", "cli_sdxl_vpred",
                      VPRED_STEPS, profiled=False, logger=("cli_vpred_logger", 1), profile_step=VPRED_PROFILED_STEP,
                      device_only=True)
        out["cli_sdxl_vpred"], out["cli_vpred_logger"] = run, dict(launches=run.pop("logger_launches"))
        run.pop("images")
        scales = [r.get("train/tag_loss_scale_mean") for r in run["metrics"]]
        if not all(isinstance(v, float) and math.isfinite(v) for v in scales):
            raise PhaseError(f"the v-prediction run's metrics lack the tag hook's loss scale: {scales}")
        print(f"v-prediction run: tag loss scale means {scales}", flush=True)
        out["cli_sdxl_remat"] = run_cli(torch, rows, paths["sdxl-remat"], "CLI fit sdxl bf16 remat [none, none, "
                                        "dots_names], profiled", "cli_sdxl_remat", 2, profiled=False, profile_step=2,
                                        device_only=True)
        out["cli_sd15_edm"] = run_cli(torch, rows, paths["sd15-edm"], "CLI fit sd15 EDM copy", "cli_sd15_edm",
                                      OPTION_STEPS, profiled=False)
        run = run_cli(torch, rows, paths["sd15-rf"], "CLI fit sd15 rectified-flow copy", "cli_sd15_rf",
                      OPTION_STEPS, profiled=False, logger=("cli_sd15_logger", 1))
        run.pop("images")
        out["cli_sd15_rf"], out["cli_sd15_logger"] = run, dict(launches=run.pop("logger_launches"))
    finally:
        os.chdir(cwd)
        if hash_env is None:
            os.environ.pop("NEUROSIS_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = hash_env
    pair = {}
    for name, run in (("full", report["cli_sdxl_bf16_profiled"]), ("none_none_dots_names", out["cli_sdxl_remat"]),
                      ("vpred", out["cli_sdxl_vpred"])):
        p = run["profiles"][-1]
        pair[name] = dict(device_ms=p["device_ms"], launches=p["launches"], kinds_ms=p["kinds_ms"],
                          peak_bytes=run["peak_bytes"])
        print(f"remat pair, {name}: {p['device_ms']} ms device in {p['launches']} kernels, peak {run['peak_bytes']} "
              "bytes", flush=True)
    out["remat_pair"] = pair
    return out


# ---------------------------------------------------------------------------
# phase 16: the rest of the VAE-GAN stack and the optimizers left
# ---------------------------------------------------------------------------


def phase16_configs(repo: Path) -> dict:
    """{name: YAML text} of phase 16's copies of vae.example.yaml: ``vq-f8``
    takes the model widths of CompVis/latent-diffusion
    models/first_stage_models/vq-f8/config.yaml (ch_mult [1, 2, 2, 4],
    attention at 32x32, z 4 without double_z, a VectorQuantizer of 16384
    codes of dim 4 at beta 0.25; VQLPIPSWithDiscriminator with 2
    discriminator layers from step 1, disc_weight 0.6, codebook_weight 1),
    torch.optim.Adam at 4.5e-6 for both optimizers (the path the JAX
    package maps to optax.adam), use_ema, 256 px, batch 8, VQ_PAIRS pairs
    from VQ_IMAGES images loaded in this process (phases 11-14 run the
    prefetch workers; their start costs ~9.5 s an epoch here), and
    allow_random_weights for its validate and test; ``vq-f8-bf16`` is the
    same with precision bf16-mixed."""
    vae = (repo / "configs/vae/vae.example.yaml").read_text()
    loss = vae[vae.index("    loss:\n"):vae.index("    optimizer:\n")]
    optimizers = vae[vae.index("    optimizer:\n"):vae.index("data:\n")]
    adam = "      class_path: torch.optim.Adam\n      init_args:\n        lr: 4.5e-6\n"
    vq = _edit(vae, [
        ("  max_epochs: 1\n", f"  max_epochs: {VQ_PAIRS}\n"),
        ("  fast_dev_run: true\n", f"  fast_dev_run: false\n  max_steps: {2 * VQ_PAIRS}\n  allow_random_weights: true\n"),
        ("    use_ema: false\n", "    use_ema: true\n"),
        ("      double_z: true\n", "      double_z: false\n"),
        ("      ch_mult: [1, 2, 4, 4]\n", "      ch_mult: [1, 2, 2, 4]\n"),
        ("      attn_resolutions: []\n", "      attn_resolutions: [32]\n"),
        (loss, "    regularizer_config:\n"
               "      class_path: neurosis.modules.autoencoding.regularizers.quantize.VectorQuantizer\n"
               "      init_args:\n        n_e: 16384\n        e_dim: 4\n        beta: 0.25\n\n"
               "    loss:\n      class_path: neurosis.modules.autoencoding.losses.VQLPIPSWithDiscriminator\n"
               "      init_args:\n        disc_num_layers: 2\n        disc_in_channels: 3\n        disc_start: 1\n"
               "        disc_weight: 0.6\n        codebook_weight: 1.0\n\n"),
        (optimizers, f"    optimizer:\n{adam}\n    disc_optimizer:\n{adam}\n"),
        ('    folder: "data/dataset/folder"\n', '    folder: "data/vq/folder"\n'),
        ("    batch_size: 2\n", "    batch_size: 8\n    num_workers: 0\n"),
    ], "vae.example.yaml")
    bf16 = _edit(vq, [("  allow_random_weights: true\n", "  allow_random_weights: true\n  precision: bf16-mixed\n")],
                 "the VQ-f8 copy")
    return {"vq-f8": vq, "vq-f8-bf16": bf16}


# the small engines of phase 16 (a): 64 px, ch 128 x [1, 4], one block a level,
# attention inside level 1 (32x32, 512 channels: the flash kernels at d=512)
SMALL_VQ = dict(ch=128, ch_mult=[1, 4], num_res_blocks=1, attn_resolutions=[32], resolution=64, z_channels=4,
                dropout=0.0)


def make_vq_engine(torch, device, seed: int, kind: str, fp32: bool = False):
    """A small VQ autoencoder trainer: ``vq`` (VectorQuantizer of 512 codes,
    VQLPIPSWithDiscriminator with the alex LPIPS, an ActNorm PatchGAN, the
    adaptive d_weight, EMA, optax.adam), ``gumbel`` (GumbelQuantizer fed
    one fixed Gumbel draw on every device, AutoencoderPerceptual: the
    engine adds the regularizer's loss) or ``ema`` (EMAVectorQuantizer,
    AutoencoderPerceptual). bf16 encoder and decoder unless ``fp32``."""
    from neurosis_tpu_torch.losses.discriminator_loss import VQLPIPSWithDiscriminator
    from neurosis_tpu_torch.losses.patchgan import NLayerDiscriminator
    from neurosis_tpu_torch.losses.vae_loss import AutoencoderPerceptual
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.modules import regularizers
    from neurosis_tpu_torch.optimizers.adamw import adam
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    g = torch.Generator(device).manual_seed(seed)
    dtype = None if fp32 else torch.bfloat16
    enc = Encoder(**SMALL_VQ, double_z=False, dtype=dtype, device=device, generator=g)
    dec = Decoder(**SMALL_VQ, out_ch=3, dtype=dtype, device=device, generator=g)
    opts = {}
    if kind == "vq":
        reg = regularizers.VectorQuantizer(512, 4, beta=0.25, log_perplexity=True, device=device, generator=g)
        loss = VQLPIPSWithDiscriminator(disc_num_layers=2, disc_start=1, disc_weight=0.6, lpips_type="alex",
                                        device=device, generator=g)
        loss.discriminator = NLayerDiscriminator(n_layers=2, use_actnorm=True, device=device, generator=g)
        opts = dict(adaptive_disc_weight=True, use_ema=True, ema_decay=0.9, disc_start=1)
    else:
        loss = AutoencoderPerceptual(lpips_type="alex", device=device, generator=g)
        if kind == "gumbel":
            noise = torch.Generator("cpu").manual_seed(seed + 1)
            gumbel = -torch.log(-torch.log(torch.rand(2, 32, 32, 512, generator=noise) + 1e-20) + 1e-20)

            class FixedDraw(regularizers.GumbelQuantizer):
                def forward(self, z, generator=None, **kw):
                    return super().forward(z, gumbel=gumbel.to(z.device), **kw)

            reg = FixedDraw(512, 4, 4, kl_weight=1e-2, device=device, generator=g)
        else:
            reg = regularizers.EMAVectorQuantizer(512, 4, beta=0.25, decay=0.9, device=device)
            with torch.no_grad():
                reg.embedding.weight.normal_(generator=g)
    return AutoencodingEngine(enc, dec, loss, lambda ps: adam(ps, 1e-4), lambda ps: adam(ps, 1e-4),
                              regularizer=reg, sample_posterior=False, device=device, **opts)


def reference_vq(torch, log: list) -> dict:
    """Phase 16 (a), on the card against the CPU from the same weights:
    a VQ pair (generator, discriminator with the gate open, generator again:
    the adaptive weight, the ActNorm initialised from the first batch), then
    its eval_step with EMA; a Gumbel and an EMA-VQ generator step (and
    EMA-VQ's codebook after it); a linear-attention Encoder/Decoder with
    dropout in eval (fp32); and three steps of CAME, optax.adam with eps_root
    and nesterov, and optax.sgd with momentum on one set of parameters and
    grads. Gates: PERF.md §2's (bf16 losses 2e-2, grad norms 5e-2; fp32 1e-3,
    1e-2); fp32 parameters within 1e-6 of their largest value."""
    from neurosis_tpu_torch import ops

    out = {}
    images = make_images(torch, "cpu", 2, 64, torch.Generator("cpu").manual_seed(21))
    for kind in ("vq", "gumbel", "ema"):
        engines = {dev: make_vq_engine(torch, dev, 22, kind) for dev in ("cpu", "cuda")}
        with torch.no_grad():
            for name in ("encoder", "decoder", "loss", "regularizer"):
                src, dst = getattr(engines["cpu"], name), getattr(engines["cuda"], name)
                dst.load_state_dict(src.state_dict())
                for a, b in zip(src.modules(), dst.modules()):
                    if hasattr(b, "initialized"):  # an ActNorm initialises from its first batch on both sides
                        b.initialized.copy_(a.initialized)
        metrics, before = {}, ops.launch_counts()
        for dev, eng in engines.items():
            state, batch, m = eng.init(seed=0), {"image": images.to(dev)}, {}
            for i, fn in enumerate([eng.g_step, eng.d_step, eng.g_step] if kind == "vq" else [eng.g_step]):
                state, step_log = fn(state, batch)
                params = eng.g_parameters() if fn == eng.g_step else eng.d_parameters()
                m[f"total_{i}"] = float(step_log["total"])
                m[f"grad_norm_{i}"] = float(torch.stack([p.grad.float().norm() for p in params
                                                         if p.grad is not None]).norm())
                if "train/scalars/d_weight" in step_log:
                    m[f"d_weight_{i}"] = float(step_log["train/scalars/d_weight"])
            if kind == "vq":
                _, val = eng.eval_step(state, batch)
                m.update(val_total=float(val["val/loss/total"]), val_total_ema=float(val["val/loss/total_ema"]))
                if not all(math.isfinite(float(v)) for v in val.values()):
                    raise PhaseError(f"the small VQ engine's eval_step is not finite: {val}")
            if kind == "ema":
                m["codebook_norm"] = float(eng.regularizer.embedding.weight.norm())
            metrics[dev] = m
        launched = {k: ops.launch_counts()[k] - before[k] for k in before}
        label = f"phase 16 small {kind} engine"
        print(f"{label} launches: {launched}", flush=True)
        missing = [k for k in ("flash_fwd", "flash_bwd", "conv3x3", "gn_silu_conv3x3") if not launched[k]]
        if missing:
            raise PhaseError(f"the {label} did not launch {missing}: {launched}")
        for key, cpu in metrics["cpu"].items():
            gpu = metrics["cuda"][key]
            tol = 5e-2 if key.startswith(("grad_norm", "d_weight")) else 2e-2
            check(f"{label} {key}: cuda {gpu:.6g} vs cpu {cpu:.6g}", abs(gpu - cpu) / max(abs(cpu), 1e-12), tol, log)
        out[kind] = dict(metrics=metrics, launches=launched)
        del engines
        torch.cuda.empty_cache()
    out["linear_attention"] = reference_linear_attention(torch, log)
    out["optimizers"] = reference_optimizers(torch, log)
    return out


def reference_linear_attention(torch, log: list) -> dict:
    """attn_type linear (no kernel: its einsums are plain torch), attention at
    32x32 and in the mid blocks, dropout 0.1 in eval (no generator: no draw),
    fp32: the decoded image on the card against the CPU."""
    from neurosis_tpu_torch.models.vae import Decoder, Encoder

    nets = {}
    for dev in ("cpu", "cuda"):
        kw = dict(SMALL_VQ, dropout=0.1, attn_type="linear", device=dev)
        g = torch.Generator(dev).manual_seed(23)
        nets[dev] = (Encoder(**kw, double_z=False, generator=g), Decoder(**kw, out_ch=3, generator=g))
    for a, b in zip(nets["cpu"], nets["cuda"]):
        b.load_state_dict(a.state_dict())
    x = make_images(torch, "cpu", 2, 64, torch.Generator("cpu").manual_seed(24)).float() / 127.5 - 1.0
    with torch.no_grad():
        want = nets["cpu"][1](nets["cpu"][0](x))
        got = nets["cuda"][1](nets["cuda"][0](x.cuda())).cpu()
    err, rel = rel_err(got, want)
    check("phase 16 linear-attention Encoder/Decoder, dropout in eval (fp32)", rel, 1e-3, log, err)
    return dict(max_abs_err=err, rel_err=rel)


def reference_optimizers(torch, log: list) -> dict:
    """Three steps of each optimizer on the card and on the CPU, from the same
    parameters (a 3x3 conv and a dense weight with JAX's layouts, a bias)
    and the same grads: fp32 parameters within 1e-6 of their largest value."""
    from neurosis_tpu_torch.modules.layers import Conv2d, Dense
    from neurosis_tpu_torch.optimizers.adamw import adam, sgd
    from neurosis_tpu_torch.optimizers.came import CAME

    def params(dev):  # drawn on the CPU, then moved: one set of values on both devices
        g = torch.Generator("cpu").manual_seed(25)
        conv, dense = Conv2d(256, 512, 3, device="cpu"), Dense(512, 320, device="cpu")
        for m in (conv, dense):
            m.reset_parameters(g)
            m.to(dev)
        return [conv.weight, dense.weight, dense.bias]

    grads = [[torch.randn(p.shape, generator=torch.Generator("cpu").manual_seed(26 + 3 * i + j)) * 10.0 ** -j
              for j, p in enumerate(params("cpu"))] for i in range(3)]
    factories = {"CAME": lambda ps: CAME(ps, 1e-3, weight_decay=0.01),
                 "optax.adam eps_root nesterov": lambda ps: adam(ps, 1e-3, eps_root=1e-8, nesterov=True),
                 "optax.sgd momentum": lambda ps: sgd(ps, 1e-2, momentum=0.9)}
    out = {}
    for name, factory in factories.items():
        final = {}
        for dev in ("cpu", "cuda"):
            ps = params(dev)
            opt = factory(ps)
            for step in grads:
                for p, gr in zip(ps, step):
                    p.grad = gr.to(dev)
                opt.step()
            final[dev] = [p.detach().cpu() for p in ps]
        if torch.equal(final["cpu"][0], params("cpu")[0].detach()):
            raise PhaseError(f"{name} left the parameters as they were")
        worst = max(rel_err(b, a)[1] for a, b in zip(final["cpu"], final["cuda"]))
        check(f"phase 16 {name}: 3 steps, parameters cuda vs cpu", worst, 1e-6, log)
        out[name] = worst
    return out


def run_cli_eval(torch, rows: dict, config: Path, command: str, label: str, path: str, batches: int) -> dict:
    """``python -m neurosis_tpu_torch validate|test -c config --max-batches
    batches`` in this process: rc 0, the JSON line it prints, every value
    finite, the launches equal to ``batches`` x the path's tables."""
    import contextlib
    import io

    from neurosis_tpu_torch import ops
    from neurosis_tpu_torch.trainer import cli

    ops.reset_launch_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main([command, "-c", str(config), "--max-batches", str(batches)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    if rc != 0:
        raise PhaseError(f"{label}: main() returned {rc}")
    metrics = json.loads(printed.getvalue().strip().splitlines()[-1])
    split = "val" if command == "validate" else "test"
    if metrics.get(f"{split}/num_batches") != batches or not all(math.isfinite(v) for v in metrics.values()):
        raise PhaseError(f"{label}: {metrics}")
    print(f"{label}: {seconds:.1f} s in main(); " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(metrics.items())),
          flush=True)
    check_launches(launches, step_totals(rows, path), batches, label)
    return dict(metrics=metrics, launches=launches, seconds=seconds)


def pair_profile(run: dict, label: str) -> dict:
    """The last generator/discriminator pair of a profiled CLI fit: device
    ms (and by kind), kernels, its host ms and the busy share."""
    last = run["profiles"][-2:]
    host = sum(r["step_ms"] for r in run["metrics"][-2:])
    if any(p["device_ms"] is None for p in last):
        print(f"{label}: the profiler recorded no device kernels: device time not measured", flush=True)
        return dict(device_ms=None, host_ms=host)
    kinds: dict = {}
    for p in last:
        for k, ms in p["kinds_ms"].items():
            kinds[k] = kinds.get(k, 0.0) + ms
    device = sum(p["device_ms"] for p in last)
    print(f"{label}, third pair: {device:.3f} ms device in {sum(p['launches'] for p in last)} kernels, host "
          f"{host:.1f} ms under the profiler, busy share {device / host:.4f}, peak {run['peak_bytes']} bytes; "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])), flush=True)
    return dict(device_ms=device, host_ms=host, busy_share=device / host, kinds_ms=kinds,
                launches=sum(p["launches"] for p in last), peak_bytes=run["peak_bytes"])


def run_vq_phase(torch, rows: dict, log: list) -> dict:
    """Phase 16, in CLI_DIR: (a) reference_vq; (b) fit of phase16_configs'
    VQ-f8 copy in fp32 and of its bf16-mixed copy, VQ_PAIRS pairs each,
    profiled (the third pair's device time by kind, busy share and peak),
    each run's launches held to its pair tables and its schedule to G, D
    alternating; (c) validate and test of the fp32 copy (live and EMA
    weights) and of vae.example.yaml as written, 2 batches each; (d) the
    AEIntegerWrapper round trip on the VQ-f8 copy's engine (random weights
    from its seed): indices -> images -> indices, the share unchanged."""
    import os

    from neurosis_tpu_torch.config.loader import load_config

    out = {"reference_vq": reference_vq(torch, log)}
    write_image_folder(torch, VQ_DIR, seed=27, sizes=VQ_SIZES)
    paths = {}
    for name, text in phase16_configs(Path.cwd().resolve()).items():
        paths[name] = (CLI_DIR / f"{name}.yaml").resolve()
        paths[name].write_text(text)
        load_config(paths[name])  # reads back
    vae = (Path.cwd() / "configs/vae/vae.example.yaml").resolve()
    cwd = os.getcwd()
    os.chdir(CLI_DIR)
    try:
        for name, path, label in (("vq-f8", "cli_vq_f32", "CLI fit VQ-f8 copy (fp32)"),
                                  ("vq-f8-bf16", "cli_vq_bf16", "CLI fit VQ-f8 copy (bf16-mixed)")):
            run = run_cli(torch, rows, paths[name], label, path, 2 * VQ_PAIRS, profiled=True, units=VQ_PAIRS)
            kinds = ["d" if "train/loss/disc" in r else "g" for r in run["metrics"]]
            if kinds != ["g", "d"] * VQ_PAIRS:
                raise PhaseError(f"{label}: the schedule ran {kinds}, not {VQ_PAIRS} alternating pairs")
            run["third_pair"] = pair_profile(run, label)
            out[path] = run
        out["cli_vq_val"] = run_cli_eval(torch, rows, paths["vq-f8"], "validate", "CLI validate VQ-f8 copy",
                                         "cli_vq_val", 2)
        if not any(k.endswith("_ema") for k in out["cli_vq_val"]["metrics"]):
            raise PhaseError("the VQ-f8 copy's validate reports no EMA metrics")
        out["cli_vq_test"] = run_cli_eval(torch, rows, paths["vq-f8"], "test", "CLI test VQ-f8 copy",
                                          "cli_vq_val", 2)
        out["cli_vae_val"] = run_cli_eval(torch, rows, vae, "validate", "CLI validate vae.example.yaml",
                                          "cli_vae_val", 2)
        out["cli_vae_test"] = run_cli_eval(torch, rows, vae, "test", "CLI test vae.example.yaml", "cli_vae_val", 2)
    finally:
        os.chdir(cwd)
    out["ae_integer"] = run_ae_integer(torch, paths["vq-f8"])
    return out


def run_ae_integer(torch, config: Path) -> dict:
    """AEIntegerWrapper over the VQ-f8 copy's engine as the CLI builds it
    (fp32, seeded random weights): 8 images of 256 px -> codebook indices
    (32x32 each) -> decoded images -> indices again; the share of indices
    unchanged is a finding, not a gate."""
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.models.autoencoder import AEIntegerWrapper
    from neurosis_tpu_torch.ops.dequant import dequant_image
    from neurosis_tpu_torch.trainer.builder import build_engine

    engine = build_engine(load_config(config)["model"], device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    wrapper = AEIntegerWrapper(engine, None, engine.regularizer, None, shape=(32, 32))
    x = dequant_image(make_images(torch, "cuda", 8, 256, torch.Generator("cpu").manual_seed(28)))
    idx = wrapper.encode(x)
    images = wrapper.decode(idx)
    again = wrapper.encode(images.clamp(-1.0, 1.0))
    if tuple(idx.shape) != (8, 1024) or tuple(images.shape) != (8, 256, 256, 3) or not torch.isfinite(images).all():
        raise PhaseError(f"AEIntegerWrapper: indices {tuple(idx.shape)}, images {tuple(images.shape)}")
    share = float((idx == again).float().mean())
    print(f"AEIntegerWrapper round trip on the VQ-f8 copy (random weights): {share:.4f} of the indices unchanged, "
          f"{int(idx.unique().numel())} distinct codes of 16384", flush=True)
    del engine
    torch.cuda.empty_cache()
    return dict(unchanged_share=share, distinct_codes=int(idx.unique().numel()))


# ---------------------------------------------------------------------------
# phase 17: the mesh (parallel/), at one NCCL rank on one card
# ---------------------------------------------------------------------------

RANK_FLAG = "--rank"  # chip_smoke.py --rank ARGS_JSON: one rank of phase 17, started by run_rank
MESH_STEPS, MESH_SAVE_STEP = 3, 2
MESH_DIR = CLI_DIR / "mesh"


def phase17_configs(repo: Path) -> dict:
    """{name: YAML text}. ``sdxl-fsdp``: configs/sdxl/sdxl-tpu-v5e.yaml with
    devices 1, strategy fsdp and fsdp 1 (FSDP2 over a 1 x 1 mesh), no
    ckpt_path, and what a run here needs: batch 2 (the config's 2 a chip:
    its 8 is 2 a chip x 4 data groups), MESH_STEPS steps logged each step,
    a checkpoint every MESH_SAVE_STEP, default_root_dir ./projects;
    everything else as written (bf16-mixed, remat [none, none, dots_names],
    Adafactor with relative steps and warmup_init, 2 prefetch workers).
    ``sdxl-one``: the same without the strategy (the one-card path);
    ``sdxl-one-resume`` loads its batches in this process (a resumed run:
    the batches are the same in every mode, the workers' start is ~10 s).
    ``sdxl-two-data``/``sdxl-two-fsdp``: devices 2 as data 2 and as fsdp 2
    (batch 2: one row a rank at data 2). ``vae-one``: vae.example.yaml
    (fp32) with disc_start 1, so that two steps are a G/D pair, a
    checkpoint at step 2, batches loaded in this process; ``vae-ddp-resume``
    and ``vae-one-resume``: max_steps 4 (the pair of steps 3 and 4 after
    resuming step 2), with strategy ddp and without."""
    v5e, vae = (repo / "configs/sdxl/sdxl-tpu-v5e.yaml").read_text(), (repo / "configs/vae/vae.example.yaml").read_text()
    ckpt = f"model_checkpoint:\n  every_n_train_steps: {MESH_SAVE_STEP}\n  save_top_k: 1\n"
    one = _edit(v5e, [
        ("seed_everything: 42\n", "seed_everything: 42\n" + ckpt),
        ("  max_epochs: 1\n", f"  max_epochs: 1\n  max_steps: {MESH_STEPS}\n"),
        ("  log_every_n_steps: 10\n", "  log_every_n_steps: 1\n"),
        ("  default_root_dir: ./projects/sdxl-tpu\n", "  default_root_dir: ./projects\n"),
        ("  devices: 8                 # whole v5e-8\n", "  devices: 1\n"),
        ("  fsdp: 2                    # (data=4, fsdp=2) mesh\n", "  fsdp: 1\n"),
        ('    ckpt_path: "data/sd_xl_base_1.0_0.9vae.safetensors"\n', ""),
        ("        ckpt_path: data/sdxl_vae.safetensors\n", ""),
        ("    batch_size: 8   # global batch: 2 per chip x 4 data-parallel groups\n", "    batch_size: 2\n"),
    ], "sdxl-tpu-v5e.yaml")
    fsdp = _edit(one, [("  devices: 1\n", "  devices: 1\n  strategy: fsdp\n")], "sdxl-one")
    one_resume = _edit(one, [("    batch_size: 2\n", "    batch_size: 2\n    num_workers: 0\n")], "sdxl-one")
    two_data = _edit(one, [("  devices: 1\n", "  devices: 2\n  strategy: fsdp\n")], "sdxl-one")
    two_fsdp = _edit(two_data, [("  fsdp: 1\n", "  fsdp: 2\n")], "sdxl-two-data")
    vae_one = _edit(vae, [
        ("seed_everything: 42\n", "seed_everything: 42\n" + ckpt),
        ("  fast_dev_run: true\n", "  fast_dev_run: false\n  max_steps: 2\n"),
        ("        disc_start: 5000\n", "        disc_start: 1\n"),
        ("    batch_size: 2\n", "    batch_size: 2\n    num_workers: 0\n"),
    ], "vae.example.yaml")
    vae_resume = _edit(vae_one, [("  max_steps: 2\n", "  max_steps: 4\n")], "vae-one")
    return {"sdxl-fsdp": fsdp, "sdxl-one": one, "sdxl-one-resume": one_resume, "sdxl-two-data": two_data,
            "sdxl-two-fsdp": two_fsdp, "vae-one": vae_one, "vae-one-resume": vae_resume,
            "vae-ddp-resume": _edit(vae_resume, [("  max_steps: 4\n", "  max_steps: 4\n  strategy: ddp\n")],
                                    "vae-one-resume")}


def pair_totals(rows: dict, g_path: str, d_path: str) -> dict:
    """A G/D pair's tables: the G step's and the D step's forward."""
    g, d = step_totals(rows, g_path), step_totals(rows, d_path)
    return {k: {m: g[k].get(m, 0.0) + d[k].get(m, 0.0) for m in set(g[k]) | set(d[k])} for k in g}


def rank_main(argv: list) -> int:
    """One rank of phase 17 (``chip_smoke.py --rank ARGS_JSON``): run_cli with
    tools/launch_pod's main in the working directory the args name; the
    launcher's environment (RANK, WORLD_SIZE, ...) comes from run_rank. Its
    result (metrics, launches, peak, profiles) goes to the args' ``out``."""
    import os

    import torch

    from neurosis_tpu_torch.tools import launch_pod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = json.loads(Path(argv[0]).read_text())
    rows = json.loads(Path(args["rows"]).read_text())
    totals = args.get("totals")
    os.chdir(args["cwd"])
    writer = int(os.environ.get("RANK", "0")) == 0
    out = run_cli(torch, rows, Path(args["config"]), args["label"], args["path"], args["steps"], profiled=False,
                  first_step=args["first_step"], units=args["units"], entry=launch_pod.main, totals=totals,
                  profile_step=args["profile_step"], device_only=True, writer=writer)
    out.pop("images", None)
    if writer:
        Path(args["out"]).write_text(json.dumps(out, default=str))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_rank(torch, rows: dict, cwd: Path, config: Path, label: str, path: str, steps: int, profile_step: int = None,
             world: int = 1, first_step: int = 1, totals: dict = None, units: int = None) -> dict:
    """``world`` ranks of ``chip_smoke.py --rank`` (one a card, NCCL over
    localhost), each running tools/launch_pod's main on ``config`` in
    ``cwd``; rank 0's run_cli result. A rank that fails fails the phase."""
    import gc
    import os

    gc.collect()
    torch.cuda.empty_cache()
    cwd.mkdir(parents=True, exist_ok=True)
    (cwd / "data").unlink(missing_ok=True)
    (cwd / "data").symlink_to((CLI_DIR / "data").resolve())
    rows_file, out_file = (MESH_DIR / "rows.json").resolve(), (cwd / "rank0.json").resolve()
    if not rows_file.exists():
        rows_file.write_text(json.dumps(rows, default=str))
    out_file.unlink(missing_ok=True)
    args = dict(rows=str(rows_file), cwd=str(cwd.resolve()), config=str(config), label=label, path=path, steps=steps,
                profile_step=profile_step, first_step=first_step, units=units, out=str(out_file), totals=totals)
    args_file = (cwd / "rank_args.json").resolve()
    args_file.write_text(json.dumps(args))
    env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(Path.cwd().resolve()),
               NEUROSIS_ALLOW_HASH_TOKENIZER="1")
    script = str(Path(__file__).resolve())
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, RANK_FLAG, str(args_file)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(world)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        raise PhaseError(f"{label}: a rank exited with {rcs}")
    out = json.loads(out_file.read_text())
    out["process_s"] = time.perf_counter() - t0
    print(f"{label}: {world} rank(s) in {out['process_s']:.1f} s (process start included)", flush=True)
    return out


def _close(label: str, got: list, want: list, keys: dict) -> dict:
    """Per step and key, |got - want| / |want| within its gate; the largest."""
    worst = {}
    for g, w in zip(got, want):
        for k, tol in keys.items():
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
            worst[k] = max(worst.get(k, 0.0), rel)
            if not rel <= tol:
                raise PhaseError(f"{label}: step {w['step']} {k} {g[k]!r} vs {w[k]!r} ({rel:.3e} > {tol})")
    print(f"{label}: largest relative differences {worst} (gates {keys})", flush=True)
    return worst


def _compare_checkpoints(torch, a: Path, b: Path) -> dict:
    """Two state.pt files: the same keys and shapes everywhere, and the largest
    parameter difference relative to the largest value."""
    pa, pb = (torch.load(x, map_location="cpu", weights_only=True, mmap=True) for x in (a, b))
    if set(pa) != set(pb) or set(pa["params"]) != set(pb["params"]):
        raise PhaseError(f"checkpoints {a} and {b} differ in their keys")
    worst, scale = 0.0, 0.0
    for k, v in pa["params"].items():
        if tuple(v.shape) != tuple(pb["params"][k].shape) or v.dtype != pb["params"][k].dtype:
            raise PhaseError(f"checkpoints {a} and {b} differ at {k}: {tuple(v.shape)} vs {tuple(pb['params'][k].shape)}")
        worst = max(worst, float((v.float() - pb["params"][k].float()).abs().max()))
        scale = max(scale, float(pb["params"][k].float().abs().max()))
    opt_a, opt_b = pa.get("opt_state", {}).get("state", {}), pb.get("opt_state", {}).get("state", {})
    if {k: sorted(v) for k, v in opt_a.items()} != {k: sorted(v) for k, v in opt_b.items()}:
        raise PhaseError(f"checkpoints {a} and {b} differ in their optimizer state's layout")
    return dict(max_param_diff=worst, max_param=scale, tensors=len(pa["params"]), step=int(pa["step"]))


def run_mesh_phase(torch, rows: dict, report: dict) -> dict:
    """Phase 17, in chiprun_out/cli/mesh/ (phase 11's image folder; phase
    15's tag captions): (c) a one-card G/D pair of the fp32 vae.example.yaml
    copy saved at step 2, then the pair of steps 3 and 4 resumed from that
    save under strategy ddp at one NCCL rank (the discriminator's BatchNorm
    all-reduced over a group of one; a one-card save resumed on the wrapped
    path) against the same pair resumed on one card, within §2's fp32 gate;
    (a) the sdxl-tpu-v5e.yaml copy wrapped with FSDP2 at one rank for
    MESH_STEPS steps, the last profiled (device only), a checkpoint at step
    2, against the same copy's one-card run (losses and grad norms within
    §2's bf16 gates), the profiled step's device ms beside phase 15's
    unwrapped run under the same remat; (b) both step-2 checkpoints laid out
    alike, and a one-card run resumed from the wrapped run's checkpoint
    against one resumed from the one-card run's (step 3); (d) the two-card
    runs, or the line that says one card holds them to tier-1's gloo test.
    Each wrapped run is a subprocess of chip_smoke.py --rank that runs
    tools/launch_pod; every run's launches are held to its tables."""
    import os
    import shutil

    MESH_DIR.mkdir(parents=True, exist_ok=True)
    (MESH_DIR / "rows.json").unlink(missing_ok=True)
    configs = {}
    for name, text in phase17_configs(Path.cwd().resolve()).items():
        configs[name] = (MESH_DIR / f"{name}.yaml").resolve()
        configs[name].write_text(text)
    t_phase = time.perf_counter()
    out, cwd, hash_env = {}, os.getcwd(), os.environ.get("NEUROSIS_ALLOW_HASH_TOKENIZER")
    sdxl_gates = {"loss": 2e-2, "grad_norm": 5e-2}
    vae_gates = {"total": 1e-3}

    def here(sub: str, fn):
        d = MESH_DIR / sub
        d.mkdir(parents=True, exist_ok=True)
        (d / "data").unlink(missing_ok=True)
        (d / "data").symlink_to((CLI_DIR / "data").resolve())
        os.chdir(d)
        try:
            return fn()
        finally:
            os.chdir(cwd)

    def resume_from(sub: str, src: str, step: int) -> None:
        """``sub``'s projects/ holding ``src``'s checkpoint of ``step`` (hard links: a
        later save may rotate it away)."""
        shutil.rmtree(MESH_DIR / sub / "projects", ignore_errors=True)
        shutil.copytree(MESH_DIR / src / "projects" / "checkpoints" / str(step),
                        MESH_DIR / sub / "projects" / "checkpoints" / str(step), copy_function=os.link)

    try:
        os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = "1"
        # (c) the fp32 VAE pair under strategy ddp at one rank, from a one-card save
        vae_totals = pair_totals(rows, "cli_vae", "cli_vae_logger")
        first = here("vae-one", lambda: run_cli(torch, rows, configs["vae-one"], "phase 17 vae pair, one card",
                                                "cli_vae", 2, profiled=False, totals=vae_totals, units=1))
        if [r.get("train/loss/rec") is not None for r in first["metrics"]] != [True, False]:
            raise PhaseError("phase 17's VAE steps were not a G step then a D step")
        resume_from("vae-one-r", "vae-one", 2)
        resume_from("vae-ddp-r", "vae-one", 2)
        out["cli_vae_ddp"] = run_rank(torch, rows, MESH_DIR / "vae-ddp-r", configs["vae-ddp-resume"],
                                      "phase 17 vae pair resumed from a one-card save, strategy ddp at one NCCL rank",
                                      "cli_vae_ddp", 2, first_step=3, totals=vae_totals, units=1)
        out["cli_vae_one"] = here("vae-one-r", lambda: run_cli(
            torch, rows, configs["vae-one-resume"], "phase 17 vae pair resumed from a one-card save, one card",
            "cli_vae", 2, profiled=False, first_step=3, totals=vae_totals, units=1))
        out["vae_pair_diff"] = _close("phase 17 vae pair: ddp vs one card", out["cli_vae_ddp"]["metrics"],
                                      out["cli_vae_one"]["metrics"], vae_gates)

        # (a) the sdxl-tpu-v5e.yaml copy wrapped at one rank, against its one-card run
        fsdp = run_rank(torch, rows, MESH_DIR / "sdxl-fsdp", configs["sdxl-fsdp"],
                        "phase 17 sdxl-tpu-v5e copy, FSDP2 at one NCCL rank", "cli_sdxl_fsdp", MESH_STEPS,
                        profile_step=MESH_STEPS)
        one = here("sdxl-one", lambda: run_cli(torch, rows, configs["sdxl-one"], "phase 17 sdxl-tpu-v5e copy, one card",
                                               "cli_sdxl_fsdp", MESH_STEPS, profiled=False))
        out["cli_sdxl_fsdp"], out["cli_sdxl_one"] = fsdp, one
        out["sdxl_diff"] = _close("phase 17 sdxl: FSDP2 at one rank vs one card", fsdp["metrics"], one["metrics"],
                                  sdxl_gates)
        remat = report.get("cli_sdxl_remat", {}).get("profiles", [{}])[-1].get("device_ms")
        p = fsdp["profiles"][-1]
        for r_f, r_o in zip(fsdp["metrics"], one["metrics"]):
            print(f"phase 17 sdxl step {r_f['step']}: host {r_f['step_ms']:.1f} ms under FSDP2, {r_o['step_ms']:.1f} ms "
                  "on one card", flush=True)
        busy = None if p["device_ms"] is None else p["device_ms"] / fsdp["metrics"][-1]["step_ms"]
        print(f"phase 17 sdxl step {MESH_STEPS} (profiled, device only): FSDP2 {p['device_ms']} ms device in "
              f"{p['launches']} kernels, busy {busy} of its host step, peak {fsdp['peak_bytes']} bytes (one card "
              f"{one['peak_bytes']}); phase 15's unwrapped step under remat [none, none, dots_names]: {remat} ms",
              flush=True)

        # (b) the checkpoints: laid out alike; the wrapped one resumed by one card, held to the one-card one's
        step = MESH_SAVE_STEP
        out["checkpoints"] = _compare_checkpoints(
            torch, MESH_DIR / "sdxl-fsdp" / "projects" / "checkpoints" / str(step) / "state.pt",
            MESH_DIR / "sdxl-one" / "projects" / "checkpoints" / str(step) / "state.pt")
        print(f"phase 17 checkpoints at step {step}: {out['checkpoints']}", flush=True)
        resume_from("sdxl-r-fsdp", "sdxl-fsdp", step)
        resume_from("sdxl-r-one", "sdxl-one", step)
        r_fsdp = here("sdxl-r-fsdp", lambda: run_cli(torch, rows, configs["sdxl-one-resume"], "phase 17 sdxl: the FSDP2 save "
                                                     "resumed on one card", "cli_sdxl_fsdp", MESH_STEPS - step,
                                                     profiled=False, first_step=step + 1))
        r_one = here("sdxl-r-one", lambda: run_cli(torch, rows, configs["sdxl-one-resume"], "phase 17 sdxl: the one-card save "
                                                   "resumed on one card", "cli_sdxl_fsdp", MESH_STEPS - step,
                                                   profiled=False, first_step=step + 1))
        out["resume_diff"] = _close("phase 17 sdxl resumed: FSDP2 save vs one-card save", r_fsdp["metrics"],
                                    r_one["metrics"], sdxl_gates)

        # (d) two cards
        if torch.cuda.device_count() >= 2:
            for name in ("sdxl-two-data", "sdxl-two-fsdp"):
                two = run_rank(torch, rows, MESH_DIR / name, configs[name], f"phase 17 {name}, two NCCL ranks",
                               "cli_sdxl_fsdp", MESH_STEPS, profile_step=MESH_STEPS, world=2)
                out[name] = dict(metrics=two["metrics"], profile=two["profiles"][-1], peak_bytes=two["peak_bytes"],
                                 diff=_close(f"phase 17 {name} vs one rank", two["metrics"], fsdp["metrics"],
                                             sdxl_gates))
            print(f"two-rank run: {torch.cuda.device_count()} cards present, data 2 and fsdp 2 held to one rank",
                  flush=True)
        else:
            print("two-rank run: 1 card present, held by tier-1's gloo test", flush=True)
            out["two_rank"] = "1 card present, held by tier-1's gloo test"
    finally:
        os.chdir(cwd)
        if hash_env is None:
            os.environ.pop("NEUROSIS_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = hash_env
        shutil.rmtree(MESH_DIR, ignore_errors=True)  # two SDXL checkpoints
    out["mesh_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 17: {out['mesh_phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: sequence parallelism on one card, the conditioners refused before
# ---------------------------------------------------------------------------


def ring_inputs(torch, dtype, n: int) -> list:
    """q, k, v, dO at RING_SHAPE in ``dtype``, seeded by n and the dtype."""
    g = torch.Generator("cuda").manual_seed(1800 + n + (dtype == torch.float32))
    return [torch.randn(*RING_SHAPE, generator=g, device="cuda").to(dtype) for _ in range(4)]


def run_ring(torch, rows: dict, log: list) -> dict:
    """(a) ring_self_attention over LocalRing(n) (every slice on this card,
    the rotation in place) at SDXL's level 1, n = 2 and 4, bf16 and fp32:
    the four rings' forward and backward with the counters read around them
    (n x n flash forward and backward launches each); then each held
    against the full-sequence flash kernel and against the plain ring (JAX's
    attention_with_stats and merge, the plain block backward) under TOL,
    and timed beside the full-sequence kernel."""
    from neurosis_tpu_torch import ops
    from neurosis_tpu_torch.ops import flash_attention as fa
    from neurosis_tpu_torch.ops import ring_attention as ra

    cases = [(dtype, n) for dtype in (torch.bfloat16, torch.float32) for n in RING_SIZES]
    inputs = {case: ring_inputs(torch, *case) for case in cases}

    def ring_grads(q, k, v, do, n):
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        o = ra.ring_self_attention(q, k, v, ra.LocalRing(n))
        return [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))

    def full_grads(q, k, v, do):
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(q, k, v)
        return [o.detach()] + list(torch.autograd.grad(o, (q, k, v), do))

    def plain_ring(q, k, v, do, n):
        ring = ra.LocalRing(n)
        qs, ks, vs = ring.slots(q), ring.slots(k), ring.slots(v)
        os_, lses = ra.ring_forward(ring, qs, ks, vs, flash=False)
        grads = ra.ring_backward(ring, qs, ks, vs, os_, lses, ring.slots(do), flash=False)
        return [ring.gather(x) for x in [os_] + list(grads)]

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = {case: ring_grads(*inputs[case], case[1]) for case in cases}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_launches(launches, step_totals(rows, "ring"), 1, "ring")

    out = {"launches": launches, "cases": []}
    for (dtype, n), ring_out in got.items():
        q, k, v, do = inputs[dtype, n]
        is_f32 = dtype == torch.float32
        fwd_tol, bwd_tol = (TOL["flash_fwd_f32"], TOL["flash_bwd_f32"]) if is_f32 else (TOL["flash_fwd"], TOL["flash_bwd"])
        tag = f"ring n={n} {'x'.join(map(str, RING_SHAPE))} {'fp32' if is_f32 else 'bf16'}"
        case = dict(n=n, dtype="fp32" if is_f32 else "bf16")
        for label, want in (("full-sequence kernel", full_grads(q, k, v, do)), ("plain ring", plain_ring(q, k, v, do, n))):
            for name, g, w in zip(("O", "dq", "dk", "dv"), ring_out, want):
                err, rel = rel_err(g, w)
                check(f"{tag} {name} against the {label}", rel, fwd_tol if name == "O" else bwd_tol, log, err)
                case[f"{name} vs {label}"] = rel
        with torch.no_grad():
            case["fwd_ms"] = time_ms(torch, lambda: ra.ring_self_attention(q, k, v, ra.LocalRing(n)), iters=5)
            case["full_fwd_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v), iters=5)
        case["fwd_bwd_ms"] = time_ms(torch, lambda: ring_grads(q, k, v, do, n), iters=3, warmup=1)
        case["full_fwd_bwd_ms"] = time_ms(torch, lambda: full_grads(q, k, v, do), iters=3, warmup=1)
        print(f"{tag}: forward {case['fwd_ms']:.3f} ms (full-sequence kernel {case['full_fwd_ms']:.3f}), forward and "
              f"backward {case['fwd_bwd_ms']:.3f} ms (full-sequence {case['full_fwd_bwd_ms']:.3f})", flush=True)
        out["cases"].append(case)
    del inputs, got
    torch.cuda.empty_cache()
    return out


def _set_compute_dtype(torch, module, dtype) -> None:
    """Every layer of ``module`` that keeps a compute dtype computes in ``dtype``
    (what building it with ``dtype=`` gives; its parameters stay fp32)."""
    for m in module.modules():
        if "dtype" in vars(m):
            m.dtype = dtype


def run_clip_t5(torch, log: list) -> dict:
    """(b) FrozenCLIPT5Encoder at its default width (CLIP-L; T5 v1.1-XL, 4.9 GB of
    fp32 weights drawn on the card from a seed, T5's q projections at HF's T5
    init, (d_model·d_kv)^-½: at the lecun scale of every other projection its
    unscaled logits have a standard deviation of √d_kv = 8, where a softmax is
    nearly an argmax and a rounding flips it), two prompts of 77 ids (the
    hash tokenizer's for CLIP, ByT5's bytes for T5), on the card against the
    same module on the CPU in fp32 (CLIP_T5_TOL fp32); the card's bf16
    outputs against the CPU's fp32 ones (the exact result) within CLIP_T5_TOL
    bf16 or twice the CPU's own bf16 error, whichever is larger (a deep bf16
    tower's output is as far from the exact one as its roundings take it, on
    any device); device ms."""
    from neurosis_tpu_torch.models.text_encoder import clip, t5
    from neurosis_tpu_torch.models.text_encoder.t5 import byt5_tokenize
    from neurosis_tpu_torch.modules.encoders.clip_t5 import FrozenCLIPT5Encoder
    from neurosis_tpu_torch.trainer.loop import HashTokenizer

    card = FrozenCLIPT5Encoder(device="cuda", generator=torch.Generator("cuda").manual_seed(18))
    with torch.no_grad():
        for block in card.t5_encoder.transformer.encoder.block:
            attention = block.layer[0].SelfAttention
            attention.q.weight.mul_(attention.d_kv ** -0.5)
    n_params = sum(p.numel() for p in card.parameters())
    saved = clip.init_parameters, t5.init_parameters
    clip.init_parameters = t5.init_parameters = lambda module, generator: None  # filled from the card's below
    try:
        host = FrozenCLIPT5Encoder(device="cpu")
    finally:
        clip.init_parameters, t5.init_parameters = saved
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, strict=True)
    ids = (torch.tensor(HashTokenizer()(list(CLIP_T5_PROMPTS)), dtype=torch.int64),
           torch.tensor(byt5_tokenize(list(CLIP_T5_PROMPTS)), dtype=torch.int64))
    ids_card = tuple(x.cuda() for x in ids)
    out = {"params": n_params}
    with torch.no_grad():
        exact = host(ids)
        for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            for m in (card, host):
                _set_compute_dtype(torch, m, dtype)
            got = card(ids_card)
            plain = host(ids) if dtype is not None else exact
            for name, g, w, h in zip(("clip_z", "t5_z"), got, exact, plain):
                if not bool(torch.isfinite(g.float()).all()) or tuple(g.shape) != tuple(w.shape):
                    raise PhaseError(f"clip_t5 {label} {name}: not finite or of shape {tuple(g.shape)}")
                tol = CLIP_T5_TOL[label]
                if dtype is not None:
                    out[f"{label}_{name}_cpu_rel"] = rel_err(h, w)[1]
                    tol = max(tol, 2 * out[f"{label}_{name}_cpu_rel"])
                    print(f"FrozenCLIPT5Encoder {label} {name}: the CPU's bf16 against its fp32, rel err "
                          f"{out[f'{label}_{name}_cpu_rel']:.3e}", flush=True)
                err, rel = rel_err(g.cpu(), w)
                check(f"FrozenCLIPT5Encoder {label} {name} {tuple(g.shape)} card vs CPU fp32", rel, tol, log, err)
                out[f"{label}_{name}_rel"] = rel
            out[f"{label}_ms"] = time_ms(torch, lambda: card(ids_card), iters=5)
            print(f"FrozenCLIPT5Encoder {label}: {out[f'{label}_ms']:.3f} ms on the card for 2 prompts", flush=True)
    del card, host
    torch.cuda.empty_cache()
    return out


def run_context_unet(torch, log: list) -> dict:
    """(c) The SDXL UNet at full width in bf16 (batch 1, 1024 px latents, the
    label embedding), one forward and backward with ``context_axis`` set and
    the ring of a one-rank NCCL group on the axis (the wiring of
    context_parallel, whose ring of one runs the whole sequence, as JAX's
    dispatch does) against the same UNet with no axis: output and loss equal
    bit for bit, the grad norm within the bf16 gate (the flash backward sums
    dQ by atomics). Its zero-initialised parameters are drawn at 0.02, so
    that the output and every gradient are not 0."""
    import torch.distributed as dist

    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.ops.ring_attention import P2PRing, on_axis
    from neurosis_tpu_torch.parallel.mesh import DistEnv, init_distributed

    init_distributed("cuda", DistEnv())
    try:
        unet = UNetModel(**SDXL_UNET, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(19))
        g = torch.Generator("cuda").manual_seed(20)
        with torch.no_grad():  # the zero-initialised layers (out conv, proj_outs, biases) drawn too: at zero
            for p in unet.parameters():  # the output, the loss and every gradient but one layer's would be 0
                if not bool(p.any()):
                    p.normal_(0.0, 0.02, generator=g)
        x = torch.randn(1, 128, 128, 4, generator=g, device="cuda")
        t = torch.tensor([500.0], device="cuda")
        ctx = torch.randn(1, 77, 2048, generator=g, device="cuda")
        y = torch.randn(1, 2816, generator=g, device="cuda")

        def step():
            unet.zero_grad(set_to_none=True)
            out = unet(x, t, ctx, y=y)
            loss = out.float().square().mean()
            loss.backward()
            norm = torch.sqrt(sum(p.grad.float().square().sum() for p in unet.parameters() if p.grad is not None))
            return out.detach().float(), float(loss), float(norm)

        one = step()
        unet.context_axis = "context"
        with on_axis("context", P2PRing(dist.group.WORLD)):
            wired = step()
        unet.context_axis = None
        out_diff = float((wired[0] - one[0]).abs().max())
        loss_rel = abs(wired[1] - one[1]) / max(abs(one[1]), 1e-30)
        norm_rel = abs(wired[2] - one[2]) / max(abs(one[2]), 1e-30)
        if not (one[1] > 0 and one[2] > 0):
            raise PhaseError(f"the SDXL UNet's loss {one[1]} or grad norm {one[2]} is 0: the comparison would hold nothing")
        check("SDXL UNet bf16 with context_axis on a one-rank NCCL ring: output (abs)", out_diff, 0.0, log)
        check("SDXL UNet bf16 with context_axis on a one-rank NCCL ring: loss", loss_rel, 0.0, log)
        check("SDXL UNet bf16 with context_axis on a one-rank NCCL ring: grad norm", norm_rel, 5e-2, log)
        return dict(loss=one[1], loss_rel=loss_rel, grad_norm=one[2], grad_norm_rel=norm_rel, out_max_diff=out_diff)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def run_ring_phase(torch, rows: dict, log: list) -> dict:
    """Phase 18: (a) the ring on one card, (b) FrozenCLIPT5Encoder at full
    width, (c) the SDXL UNet wired for context_parallel at one NCCL rank."""
    t0 = time.perf_counter()
    out = {"ring": run_ring(torch, rows, log), "clip_t5": run_clip_t5(torch, log),
           "context_unet": run_context_unet(torch, log)}
    out["ring"]["phase_s"] = time.perf_counter() - t0
    print(f"phase 18: {out['ring']['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: the DreamSim VAE fit, the profiler, the vision towers
# ---------------------------------------------------------------------------

DS_LOSS_NODE = ("    loss:\n      class_path: neurosis.modules.autoencoding.losses.AutoencoderDreamsim\n"
                "      init_args:\n        recon_type: l1\n        recon_weight: 1.0\n        dreamsim_weight: 1.0\n"
                "        ensemble: true\n\n")
DS_PROFILER_NODE = ("  profiler:\n    init_args:\n      dirpath: profiles/dreamsim\n      capture_depth: 2\n"
                    "      schedule:\n        skip_first: 1\n        warmup: 1\n        active: 1\n")


def phase19_configs(repo: Path) -> dict:
    """Copies of configs/vae/vae.example.yaml with its ``loss:`` node
    swapped for AutoencoderDreamsim (l1, the weights 1.0, the ensemble) and
    fast_dev_run off: {"f32": 3 steps as written, "bf16": 3 steps,
    precision bf16-mixed, "profiled": the bf16 copy for 4 steps with a
    trainer.profiler: node}, written into CLI_DIR; each checked to differ
    from the file in those keys only."""
    from neurosis_tpu_torch.config.loader import load_config

    src = repo / "configs" / "vae" / "vae.example.yaml"
    text = src.read_text()
    start, end = text.index("    loss:\n"), text.index("    optimizer:\n")
    base = text[:start] + DS_LOSS_NODE + text[end:]
    written = "  fast_dev_run: true\n"
    if base.count(written) != 1:
        raise PhaseError(f"{src} no longer has the line {written!r}")
    trainers = {"f32": f"  fast_dev_run: false\n  max_steps: {DS_STEPS}\n",
                "bf16": f"  fast_dev_run: false\n  max_steps: {DS_STEPS}\n  precision: bf16-mixed\n",
                "profiled": f"  fast_dev_run: false\n  max_steps: {DS_PROFILED_STEPS}\n  precision: bf16-mixed\n"
                            + DS_PROFILER_NODE}
    want = load_config(src)
    want["model"]["init_args"]["loss"] = {
        "class_path": "neurosis.modules.autoencoding.losses.AutoencoderDreamsim",
        "init_args": {"recon_type": "l1", "recon_weight": 1.0, "dreamsim_weight": 1.0, "ensemble": True}}
    out = {}
    for name, trainer in trainers.items():
        path = (CLI_DIR / f"vae-dreamsim-{name}.yaml").resolve()
        path.write_text(base.replace(written, trainer))
        cfg = load_config(path)
        expect = json.loads(json.dumps(want))
        expect["trainer"].update(fast_dev_run=False, max_steps=DS_PROFILED_STEPS if name == "profiled" else DS_STEPS)
        if name != "f32":
            expect["trainer"]["precision"] = "bf16-mixed"
        if name == "profiled":
            expect["trainer"]["profiler"] = {"init_args": {"dirpath": "profiles/dreamsim", "capture_depth": 2,
                                                           "schedule": {"skip_first": 1, "warmup": 1, "active": 1}}}
        if cfg != expect:
            raise PhaseError(f"the DreamSim copy {path.name} differs from vae.example.yaml in more than its keys")
        out[name] = path
    return out


def _busy_share(run: dict) -> dict:
    """The profiled step's device ms by kind beside the host ms of the step before it (unprofiled)."""
    prof = run["profiles"][0]
    host = run["metrics"][-2]["step_ms"]
    share = None if prof["device_ms"] is None else prof["device_ms"] / host
    return dict(device_ms=prof["device_ms"], kinds_ms=prof["kinds_ms"], launches=prof["launches"],
                host_step_ms=host, busy_share=share, peak_gb=run["peak_bytes"] / 1e9)


def run_dreamsim_profiler(torch, rows: dict, config: Path) -> dict:
    """(b) The bf16 DreamSim copy for DS_PROFILED_STEPS steps with its
    trainer.profiler: node: profiles/dreamsim/run_000/trace.json holds
    device kernels; the summary's module rows hold the three towers and the
    VAE; every port kernel of the traced step is claimed by a CPU op (a
    ``neurosis::`` op or the flash function's backward) and sits under a
    VAE module; the towers' share of the step's device time."""
    import shutil

    from neurosis_tpu_torch.trainer import cli
    from neurosis_tpu_torch.trainer import profile as profile_mod

    shutil.rmtree("profiles/dreamsim", ignore_errors=True)
    made, inner_profiler, inner_aggregate, kept = [], cli._profiler, profile_mod.aggregate, []

    def profiler(node):
        made.append(inner_profiler(node))
        return made[-1]

    def aggregate(events, cuda):
        kept.append(events)
        return inner_aggregate(events, cuda)

    cli._profiler, profile_mod.aggregate = profiler, aggregate
    try:
        run = run_cli(torch, rows, config, "CLI fit DreamSim VAE bf16-mixed, trainer.profiler:", "cli_ds_profiler",
                      DS_PROFILED_STEPS, profiled=False)
    finally:
        cli._profiler, profile_mod.aggregate = inner_profiler, inner_aggregate
    if len(made) != 1 or len(kept) != 1:
        raise PhaseError(f"the profiled fit made {len(made)} profilers and {len(kept)} traces, not 1 and 1")
    prof, events = made[0], kept[0]
    trace = Path("profiles/dreamsim/run_000") / profile_mod.TRACE_FILE
    if not trace.exists() or Path("profiles/dreamsim/run_001").exists():
        raise PhaseError(f"the profiler did not write {trace} alone")
    trace_bytes = trace.stat().st_size
    device_events = sum(1 for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "kernel")
    shutil.rmtree("profiles/dreamsim")  # tens of MB: read here, not brought back
    if not device_events:
        raise PhaseError(f"{trace} holds no device kernels")
    ops_rows, mod_rows = prof.key_averages("op"), prof.key_averages("module")
    total_us = sum(r["device_time_us"] for r in mod_rows)
    for title, table in (("op", ops_rows), ("module", mod_rows)):
        for r in table[:10]:
            print(f"profiler summary by {title}: {r['key'][:70]:70s} {r['count']:6d} x, {r['device_time_us']:12.1f} us, "
                  f"{100 * r['device_time_us'] / total_us:5.1f}%", flush=True)
    towers = {t: sum(r["device_time_us"] for r in mod_rows if r["key"].startswith(f"dreamsim.{t}(")) for t in DS_TOWERS}
    vae_us = sum(r["device_time_us"] for r in mod_rows if r["key"].split("(")[0].split(".")[0] in
                 ("Encoder", "Decoder", "down", "up", "mid", "conv_in", "conv_out", "norm_out"))
    if not all(towers.values()) or not vae_us:
        raise PhaseError(f"the module rows lack a tower or the VAE: towers {towers} us, VAE {vae_us} us")
    # the port's kernels of the traced step: each claimed by its launching CPU op, under a VAE module
    cuda = torch.autograd.DeviceType.CUDA
    module_of = profile_mod.module_resolver(events)
    port = lambda name: kernel_kind(name) == "port kernels"  # noqa: E731
    traced = sum(1 for e in events if e.device_type == cuda and port(e.name))
    by_module: dict = {}
    for e in events:
        if e.device_type != cuda:
            for k in e.kernels:
                if port(k.name):
                    key = (module_of(e), e.name)
                    by_module[key] = by_module.get(key, 0) + 1
    for (mod, op), n in sorted(by_module.items()):
        print(f"profiler: port kernels under {mod} from {op}: {n}", flush=True)
    claimed = sum(by_module.values())
    if not traced or claimed != traced or any(mod == profile_mod.NO_SPAN or mod.startswith("dreamsim")
                                              for mod, _ in by_module):
        raise PhaseError(f"of {traced} port kernels in the trace {claimed} were claimed by a CPU op, under "
                         f"{sorted(set(m for m, _ in by_module))}")
    share = sum(towers.values()) / total_us
    print(f"profiler: the towers take {share:.4f} of the traced step's {total_us / 1e3:.3f} device ms "
          f"({', '.join(f'{t} {us / 1e3:.3f} ms' for t, us in towers.items())}); the VAE's modules "
          f"{vae_us / 1e3:.3f} ms; trace {trace_bytes} bytes, {device_events} device kernels", flush=True)
    run.update(towers_ms={t: us / 1e3 for t, us in towers.items()}, towers_share=share, vae_ms=vae_us / 1e3,
               traced_device_ms=total_us / 1e3, trace_bytes=trace_bytes, trace_kernels=device_events,
               top_ops=ops_rows[:10], top_modules=mod_rows[:10],
               port_kernels_by_module={f"{m} / {o}": n for (m, o), n in by_module.items()})
    return run


def _host_copy(torch, module_cls, card, kwargs: dict, *patched):
    """``module_cls(**kwargs)`` on the CPU without drawing its init (each of
    ``patched``' init_parameters stubbed), holding the card module's weights."""
    saved = [m.init_parameters for m in patched]
    for m in patched:
        m.init_parameters = lambda module, generator: None
    try:
        host = module_cls(**kwargs, device="cpu", generator=torch.Generator("cpu"))
    finally:
        for m, f in zip(patched, saved):
            m.init_parameters = f
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, strict=True)
    return host


def reference_dreamsim(torch, log: list) -> dict:
    """(c) The VAE at configs/smoke/vae-tiny.yaml's dims with
    AutoencoderDreamsim (full-width towers, AdamW 1e-4): 2 generator steps on
    the card against the CPU from the same weights and posterior noise, fp32
    and bf16, under DS_TOL (losses, grad norms)."""
    from neurosis_tpu_torch import ops
    from neurosis_tpu_torch.losses import dreamsim
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.optimizers.adamw import adamw
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    card_loss = dreamsim.AutoencoderDreamsim(device="cuda", generator=torch.Generator("cuda").manual_seed(19))
    host_loss = _host_copy(torch, dreamsim.AutoencoderDreamsim, card_loss, {}, dreamsim)
    images = make_images(torch, "cpu", 2, 64, torch.Generator("cpu").manual_seed(20))
    eps = torch.randn(2, 32, 32, TINY_VAE["z_channels"], generator=torch.Generator("cpu").manual_seed(21))
    out = {}
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        engines = {}
        for dev, loss in (("cpu", host_loss), ("cuda", card_loss)):
            g = torch.Generator(dev).manual_seed(22)
            enc = Encoder(**TINY_VAE, double_z=True, in_channels=3, dtype=dtype, device=dev, generator=g)
            dec = Decoder(**TINY_VAE, out_ch=3, dtype=dtype, device=dev, generator=g)
            if dev == "cuda":  # the CPU's weights
                enc.load_state_dict(engines["cpu"].encoder.state_dict())
                dec.load_state_dict(engines["cpu"].decoder.state_dict())
            engines[dev] = AutoencodingEngine(enc, dec, loss, g_optimizer=lambda ps: adamw(ps, 1e-4), kl_weight=1e-6,
                                              device=dev)
        metrics, before = {}, ops.launch_counts()
        for dev, eng in engines.items():
            state, steps = eng.init(seed=0), []
            for _ in range(2):
                state, lg = eng.g_step(state, {"image": images.to(dev)}, posterior_noise=eps.to(dev))
                norm = float(torch.stack([p.grad.float().norm() for p in eng.g_parameters()]).norm())
                steps.append(dict(total=float(lg["total"]), rec=float(lg["train/loss/rec"]),
                                  dreamsim=float(lg["train/loss/dreamsim"]), grad_norm=norm))
            if any(p.grad is not None for p in eng.loss.parameters()):
                raise PhaseError("a DreamSim tower took a grad")
            metrics[dev] = steps
        launched = {k: n - before[k] for k, n in ops.launch_counts().items() if n != before[k]}
        print(f"reference DreamSim VAE {label}: launches {launched}", flush=True)
        tol_loss, tol_norm = DS_TOL[label]
        for i, (c, h) in enumerate(zip(metrics["cuda"], metrics["cpu"])):
            for key in ("total", "rec", "dreamsim", "grad_norm"):
                tol = tol_norm if key == "grad_norm" else tol_loss
                check(f"DreamSim VAE at vae-tiny's dims {label} step {i + 1} {key}: cuda {c[key]:.6g} vs cpu "
                      f"{h[key]:.6g}", abs(c[key] - h[key]) / abs(h[key]), tol, log)
        out[label] = dict(metrics, launches=launched)
    del card_loss, host_loss
    torch.cuda.empty_cache()
    return out


def full_width_towers(torch, log: list) -> dict:
    """(c) At full width, batch 1, fp32, card against CPU within
    DS_FULL_WIDTH_TOL: one AutoencoderDreamsim distance (256 px pair, the
    three ViT-B/16 at 224), FrozenOpenCLIPImageEmbedder at ViT-H-14's widths
    (256 px in, resized to 224) and create_dinov2("dinov2_vitb14") at 224 px
    (no checkpoint: the seeded init); each one's device ms."""
    import tempfile

    from neurosis_tpu_torch.losses import dreamsim
    from neurosis_tpu_torch.models import dinov2
    from neurosis_tpu_torch.models.text_encoder import clip_image

    g = torch.Generator("cpu").manual_seed(23)
    x = make_images(torch, "cpu", 2, 256, g).float() / 127.5 - 1.0
    cases = {}
    card = dreamsim.AutoencoderDreamsim(device="cuda", generator=torch.Generator("cuda").manual_seed(24))
    cases["AutoencoderDreamsim distance"] = (card, _host_copy(torch, dreamsim.AutoencoderDreamsim, card, {}, dreamsim),
                                             lambda m, t: m(t[:1], t[1:])[1]["train/loss/dreamsim"][None])
    card = clip_image.FrozenOpenCLIPImageEmbedder(device="cuda", generator=torch.Generator("cuda").manual_seed(25))
    cases["FrozenOpenCLIPImageEmbedder ViT-H-14"] = (
        card, _host_copy(torch, clip_image.FrozenOpenCLIPImageEmbedder, card, {}, clip_image),
        lambda m, t: m(t[:1])[0])
    with tempfile.TemporaryDirectory(dir=CLI_DIR) as empty:
        card, _ = dinov2.create_dinov2("dinov2_vitb14", data_dir=empty, device="cuda",
                                       generator=torch.Generator("cuda").manual_seed(26))
    host = _host_copy(torch, dinov2.DinoVisionTransformer, card, dict(
        embed_dim=768, depth=12, heads=12, ffn_layer="mlp", init_values=1.0, interpolate_offset=0.1), dinov2)

    def dino_tokens(m, t):
        o = m((t[:1, 16:240, 16:240] + 1) / 2)  # 224 px in [0, 1]
        return torch.cat([o["x_norm_clstoken"], o["x_norm_patchtokens"].flatten(1)], dim=1)

    cases["create_dinov2 dinov2_vitb14"] = (card, host, dino_tokens)
    out = {}
    x_card = x.cuda()
    with torch.no_grad():
        for label, (card, host, fn) in cases.items():
            got, want = fn(card, x_card), fn(host, x)
            if not bool(torch.isfinite(got).all()) or tuple(got.shape) != tuple(want.shape):
                raise PhaseError(f"{label}: not finite or of shape {tuple(got.shape)}")
            err, rel = rel_err(got.cpu(), want)
            check(f"{label} {tuple(got.shape)} card vs CPU fp32", rel, DS_FULL_WIDTH_TOL, log, err)
            ms = time_ms(torch, lambda: fn(card, x_card), iters=5)
            print(f"{label}: {ms:.3f} ms on the card, batch 1", flush=True)
            out[label] = dict(rel_err=rel, max_abs_err=err, ms=ms,
                              params=sum(p.numel() for p in card.parameters()))
    del cases, card, host
    torch.cuda.empty_cache()
    return out


def run_dreamsim_phase(torch, rows: dict, log: list) -> dict:
    """Phase 19, in CLI_DIR: (a) the DreamSim copies of vae.example.yaml
    (fp32 as written, and bf16-mixed) for DS_STEPS steps, the last profiled
    alone; (b) the bf16 copy with trainer.profiler:; (c) the small engine
    and the full-width towers, card against CPU. Phase 3 held this path's
    kernels (cli_ds_bf16's rows, cli_vae's for fp32) at its shapes."""
    import os

    t0 = time.perf_counter()
    folder = CLI_DIR / "data" / "dataset" / "folder"
    if not any(folder.glob("*.png")):
        write_image_folder(torch, folder)
    configs = phase19_configs(Path.cwd().resolve())
    out = {}
    cwd, prefetch = os.getcwd(), os.environ.get("NEUROSIS_PREFETCH")
    os.chdir(CLI_DIR)
    # the prefetch workers as threads: a spawned worker's start (~10 s) each fit, not measured here
    os.environ["NEUROSIS_PREFETCH"] = "thread"
    try:
        for key, name, label in (("cli_ds_f32", "f32", "fp32"), ("cli_ds_bf16", "bf16", "bf16-mixed")):
            out[key] = run_cli(torch, rows, configs[name], f"CLI fit DreamSim VAE ({label})", key, DS_STEPS,
                               profiled=False, profile_step=DS_STEPS)
            if "train/loss/dreamsim" not in out[key]["metrics"][0]:
                raise PhaseError(f"{key}: the step logged no train/loss/dreamsim")
            out[key]["step"] = _busy_share(out[key])
            print(f"{key}: profiled step busy share {out[key]['step']['busy_share']:.4f} of the host step before it "
                  f"({out[key]['step']['host_step_ms']:.1f} ms)", flush=True)
        out["cli_ds_profiler"] = run_dreamsim_profiler(torch, rows, configs["profiled"])
    finally:
        os.chdir(cwd)
        if prefetch is None:
            os.environ.pop("NEUROSIS_PREFETCH", None)
        else:
            os.environ["NEUROSIS_PREFETCH"] = prefetch
    out["reference_dreamsim"] = reference_dreamsim(torch, log)
    out["dreamsim_full_width"] = full_width_towers(torch, log)
    for name, rs in rows.items():
        for r in rs:
            if r["path"] in ("cli_ds_bf16", "cli_vae"):
                lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
                print(f"phase 19 {name} {r['shape']} ({r['path']}, {r['per_step']} a step): {r['ms']:.3f} ms, "
                      f"bound {r['bound_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library {lib} ms, max abs err "
                      f"{r['max_abs_err']:.3e}", flush=True)
    out["cli_ds_f32"]["phase_s"] = time.perf_counter() - t0
    print(f"phase 19: {out['cli_ds_f32']['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: the Mongo datasets and checkpoints in a blob store
# ---------------------------------------------------------------------------

# the query of phase 20's metadata cache; its rows point at phase 11's PNGs (fs_type file, path_prefix)
MONGO_SETTINGS = dict(uri="mongodb://phase20", database="neurosis", collection="images",
                      query={"filter": {"split": "train"}})
MONGO_CACHE = "data/mongo_cache"  # under CLI_DIR, where the fits run
MONGO_STEPS = 2  # SDXL steps, the second profiled (device only)
VAE_STORE = "memory://phase20/vae"
VAE_STEPS, VAE_RESUMED_TO = 3, 4
MONGO_SETTINGS_NODE = ("    settings:\n      class_path: neurosis_tpu.data.mongo.MongoSettings\n      init_args:\n"
                       f"        uri: {MONGO_SETTINGS['uri']}\n        database: {MONGO_SETTINGS['database']}\n"
                       f"        collection: {MONGO_SETTINGS['collection']}\n        query:\n          filter:\n"
                       "            split: train\n"
                       f"    cache_dir: {MONGO_CACHE}\n    fs_type: file\n    path_prefix: data/dataset/folder\n")
MONGO_SDXL_DATA = ("data:\n  class_path: neurosis.dataset.mongo.MongoAspectDataset\n  init_args:\n"
                   + MONGO_SETTINGS_NODE + "    image_key: image\n    caption_key: caption\n    buckets:\n"
                   "      class_path: neurosis.dataset.aspect.SDXLBucketList\n    batch_size: 2\n    seed: 20\n")
MONGO_VAE_DATA = ("data:\n  class_path: neurosis.dataset.mongo.MongoVAEDataset\n  init_args:\n" + MONGO_SETTINGS_NODE
                  + "    image_key: image\n    resolution: 256\n    batch_size: 2\n    seed: 20\n")
PHASE20_CALLBACKS = ("  callbacks:\n    - class_path: neurosis_tpu.trainer.callbacks.ProgressCallback\n      init_args:\n"
                     "        every_n: 1\n    - class_path: neurosis_tpu.trainer.callbacks.SaveConfigCallback\n")
VAE_CHECKPOINT = f"model_checkpoint:\n  dirpath: {VAE_STORE}\n  every_n_train_steps: 1\n  save_top_k: 2\n"


def phase20_configs(repo: Path) -> dict:
    """{"sdxl": the bf16-mixed copy of sdxl.example.yaml (phase 11's) with
    ``data:`` a MongoAspectDataset (SDXLBucketList, batch 2) over phase 20's
    cache, ProgressCallback and SaveConfigCallback by their JAX class paths,
    MONGO_STEPS steps; "vae": vae.example.yaml with ``data:`` a
    MongoVAEDataset over the same rows, EMA on (so a resume has shadows to
    restore), a ``model_checkpoint:`` in the memory store, VAE_STEPS steps;
    "vae_resume": that copy with ``trainer.remote_checkpoint_url`` and
    VAE_RESUMED_TO steps}, written into CLI_DIR, each checked to differ
    from its source in those keys only."""
    from neurosis_tpu_torch.config.loader import load_config

    settings = {"class_path": "neurosis_tpu.data.mongo.MongoSettings",
                "init_args": {k: MONGO_SETTINGS[k] for k in ("uri", "database", "collection", "query")}}
    common = dict(settings=settings, cache_dir=MONGO_CACHE, fs_type="file", path_prefix="data/dataset/folder")
    written = {"sdxl": "  fast_dev_run: true  # disable to actually train\n", "vae": "  fast_dev_run: true\n"}
    trainers = {"sdxl": f"  fast_dev_run: false\n  max_steps: {MONGO_STEPS}\n  precision: bf16-mixed\n"
                        + PHASE20_CALLBACKS,
                "vae": f"  fast_dev_run: false\n  max_steps: {VAE_STEPS}\n",
                "vae_resume": f"  fast_dev_run: false\n  max_steps: {VAE_RESUMED_TO}\n"
                              f"  remote_checkpoint_url: {VAE_STORE}\n"}
    out = {}
    for name, trainer in trainers.items():
        src = repo / "configs" / ("sdxl/sdxl.example.yaml" if name == "sdxl" else "vae/vae.example.yaml")
        text = src.read_text()
        line = written["sdxl" if name == "sdxl" else "vae"]
        if text.count(line) != 1 or text.count("\ndata:\n") != 1:
            raise PhaseError(f"{src} no longer has the line {line!r} and one data: node")
        head = text[:text.index("\ndata:\n") + 1].replace(line, trainer)
        if name == "sdxl":
            body = head + MONGO_SDXL_DATA
        else:
            body = head.replace("    use_ema: false\n", "    use_ema: true\n") + MONGO_VAE_DATA + VAE_CHECKPOINT
        path = (CLI_DIR / f"phase20-{name}.yaml").resolve()
        path.write_text(body)
        expect = load_config(src)
        expect["trainer"].update(fast_dev_run=False, max_steps=MONGO_STEPS if name == "sdxl" else
                                 VAE_STEPS if name == "vae" else VAE_RESUMED_TO)
        if name == "sdxl":
            expect["trainer"].update(precision="bf16-mixed", callbacks=[
                {"class_path": "neurosis_tpu.trainer.callbacks.ProgressCallback", "init_args": {"every_n": 1}},
                {"class_path": "neurosis_tpu.trainer.callbacks.SaveConfigCallback"}])
            expect["data"] = {"class_path": "neurosis.dataset.mongo.MongoAspectDataset", "init_args": dict(
                common, image_key="image", caption_key="caption",
                buckets={"class_path": "neurosis.dataset.aspect.SDXLBucketList"}, batch_size=2, seed=20)}
        else:
            expect["model"]["init_args"]["use_ema"] = True
            expect["data"] = {"class_path": "neurosis.dataset.mongo.MongoVAEDataset", "init_args": dict(
                common, image_key="image", resolution=256, batch_size=2, seed=20)}
            expect["model_checkpoint"] = {"dirpath": VAE_STORE, "every_n_train_steps": 1, "save_top_k": 2}
            if name == "vae_resume":
                expect["trainer"]["remote_checkpoint_url"] = VAE_STORE
        if load_config(path) != expect:
            raise PhaseError(f"phase 20's copy {path.name} differs from {src.name} in more than its keys")
        out[name] = path
    return out


def write_mongo_cache(folder: Path) -> list:
    """Phase 20's metadata cache, as a pull of MONGO_SETTINGS' query would
    write it: a row for each PNG of ``folder`` (its name under the prefix,
    caption, aspect, size); no Mongo server and no pymongo."""
    from neurosis_tpu_torch.data import mongo
    from neurosis_tpu_torch.data.png import read_size

    rows = []
    for i, png in enumerate(sorted(folder.glob("*.png"))):
        w, h = read_size(png)
        rows.append({"_id": i, "s3_url": png.name, "caption": png.with_suffix(".txt").read_text(),
                     "aspect": w / h, "resolution": [w, h], "split": "train"})
    source = mongo.BaseMongoDataset(settings=mongo.MongoSettings(**MONGO_SETTINGS), cache_dir=MONGO_CACHE,
                                    skip_preload=True)
    print(f"phase 20: {len(rows)} metadata rows cached in {source.write_cache(rows)}", flush=True)
    return rows


def _check_mongo_batches(torch, config: Path, seen: list) -> None:
    """The fit's host batches against the same dataset's on the CPU for the
    seed (images exact, captions, sizes), each of one bucket."""
    import numpy as np

    from neurosis_tpu_torch.config.loader import instantiate, load_config
    from neurosis_tpu_torch.data.prefetch import get_batch, seeded_batches

    ds = instantiate(load_config(config)["data"])
    for n, ((indices, seed), got) in enumerate(zip(seeded_batches(ds, ds.get_batch_iterator()), seen)):
        if len({int(ds.bucket_idx[i]) for i in indices}) != 1:
            raise PhaseError(f"phase 20 (a): batch {n} {indices} mixes buckets")
        want = get_batch(ds, indices, seed)
        for k, v in want.items():
            same = np.array_equal(got[k], v) if isinstance(v, np.ndarray) else list(got[k]) == list(v)
            if not same:
                raise PhaseError(f"phase 20 (a): the fit's batch {n} differs from the CPU's in {k}")
        print(f"phase 20 (a): batch {n} = the CPU's for the seed (rows {indices}, bucket "
              f"{ds.buckets[int(ds.bucket_idx[indices[0]])].size}, {want['image'].shape})", flush=True)
    if len(seen) != MONGO_STEPS:
        raise PhaseError(f"phase 20 (a): the fit took {len(seen)} batches, not {MONGO_STEPS}")


def run_mongo_phase(torch, rows: dict) -> dict:
    """Phase 20, in CLI_DIR after phase 19 (phase 11's PNGs): the metadata
    cache, then (a) the bf16 SDXL copy fit from MongoAspectDataset for
    MONGO_STEPS steps (the last profiled, device only), its batches against
    the CPU's, its config.yaml read back, pymongo never imported; (b)
    vae.example.yaml's copy fit from MongoVAEDataset for VAE_STEPS steps,
    saving every step to the memory store (keep 2), then fit again to
    VAE_RESUMED_TO from ``remote_checkpoint_url``: the store's steps, the
    resumed state against the saved one bitwise, the checkpoint's bytes,
    serialize, write, wait and resume seconds. Launches held to the sdxl
    and cli_vae tables."""
    import os

    import numpy as np

    from neurosis_tpu_torch.checkpoint.blob import BlobCheckpointIO
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.config.yaml_reader import safe_load
    from neurosis_tpu_torch.trainer import cli
    from neurosis_tpu_torch.trainer.callbacks import CheckpointCallback, state_payload
    from neurosis_tpu_torch.trainer.loop import Trainer

    t0 = time.perf_counter()
    folder = CLI_DIR / "data" / "dataset" / "folder"
    if not any(folder.glob("*.png")):
        write_image_folder(torch, folder)
    configs = phase20_configs(Path.cwd().resolve())
    out = {}
    cwd, saved_env = os.getcwd(), {k: os.environ.get(k) for k in ("NEUROSIS_ALLOW_HASH_TOKENIZER", "NEUROSIS_PREFETCH")}
    os.chdir(CLI_DIR)
    seen, inner_factory = [], cli._batch_factory
    stores, resumed, inner_end, inner_resume = [], [], CheckpointCallback.on_fit_end, Trainer._maybe_resume

    def recording(cfg, dataset, mesh=None):
        make = inner_factory(cfg, dataset, mesh)

        def batches():
            for b in make():
                seen.append({k: v.copy() if isinstance(v, np.ndarray) else list(v) for k, v in b.items()})
                yield b

        return batches

    def fit_end(self, trainer, state):
        inner_end(self, trainer, state)
        b = self.blob
        stores.append(dict(bytes=b.last_bytes, serialize_s=b.last_serialize_s, write_s=b.last_write_s,
                           waited_s=b.waited_s, steps=b.list_steps()))

    def resume(self, state):
        t1 = time.perf_counter()
        state = inner_resume(self, state)
        seconds = time.perf_counter() - t1
        payload = state_payload(self.engine, state)
        resumed.append(dict(seconds=seconds, step=payload["step"], ema_num_updates=payload.get("ema_num_updates"),
                            params={k: v.detach().cpu().clone() for k, v in payload["params"].items()},
                            ema_params={k: v.detach().cpu().clone() for k, v in payload["ema_params"].items()}))
        return state

    try:
        os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = "1"
        write_mongo_cache(Path("data/dataset/folder"))
        cli._batch_factory = recording
        out["cli_mongo_sdxl"] = run_cli(torch, rows, configs["sdxl"], "CLI fit SDXL bf16 from MongoAspectDataset",
                                        "cli_mongo_sdxl", MONGO_STEPS, profiled=False, profile_step=MONGO_STEPS,
                                        device_only=True)
        cli._batch_factory = inner_factory
        if "pymongo" in sys.modules:
            raise PhaseError("phase 20 (a) imported pymongo: the fit read no metadata cache")
        _check_mongo_batches(torch, configs["sdxl"], seen)
        if safe_load(Path("projects/config.yaml").read_text()) != load_config(configs["sdxl"]):
            raise PhaseError("phase 20 (a): projects/config.yaml does not read back as the resolved config")
        prof = out["cli_mongo_sdxl"]["profiles"][0]
        print(f"phase 20 (a): config.yaml read back equal; step {MONGO_STEPS}: host "
              f"{out['cli_mongo_sdxl']['metrics'][-1]['step_ms']:.1f} ms (profiled), data "
              f"{out['cli_mongo_sdxl']['metrics'][-1]['data_ms']:.1f} ms, device {prof['device_ms']} ms", flush=True)

        os.environ["NEUROSIS_PREFETCH"] = "thread"
        CheckpointCallback.on_fit_end, Trainer._maybe_resume = fit_end, resume
        out["cli_mongo_vae"] = run_cli(torch, rows, configs["vae"], "CLI fit vae.example.yaml from MongoVAEDataset, "
                                       "saving to the memory store", "cli_mongo_vae", VAE_STEPS, profiled=False)
        store = BlobCheckpointIO(VAE_STORE)
        if store.list_steps() != [VAE_STEPS - 1, VAE_STEPS]:
            raise PhaseError(f"phase 20 (b): the store holds steps {store.list_steps()} after the first fit")
        saved = store.load_checkpoint(VAE_STEPS)
        resumed.clear()
        out["cli_mongo_vae_resume"] = run_cli(torch, rows, configs["vae_resume"], "CLI fit vae.example.yaml resumed "
                                              "from the memory store", "cli_mongo_vae_resume",
                                              VAE_RESUMED_TO - VAE_STEPS, profiled=False, first_step=VAE_STEPS + 1)
        if store.list_steps() != [VAE_STEPS, VAE_RESUMED_TO]:
            raise PhaseError(f"phase 20 (b): the store holds steps {store.list_steps()} after the resumed fit")
        if len(resumed) != 1 or resumed[0]["step"] != VAE_STEPS:
            raise PhaseError(f"phase 20 (b): the second fit resumed at {[r['step'] for r in resumed]}")
        got = resumed[0]
        for key in ("params", "ema_params"):
            if sorted(got[key]) != sorted(saved[key]) or not all(
                    got[key][k].dtype == saved[key][k].dtype and torch.equal(got[key][k], saved[key][k])
                    for k in saved[key]):
                raise PhaseError(f"phase 20 (b): the resumed {key} differ from the saved step's")
        if got["ema_num_updates"] != saved["ema_num_updates"]:
            raise PhaseError("phase 20 (b): the resumed EMA count differs from the saved one")
        print(f"phase 20 (b): resumed step {got['step']}: {len(saved['params'])} parameters and "
              f"{len(saved['ema_params'])} EMA shadows bitwise the saved ones, in {got['seconds']:.3f} s; store steps "
              f"{store.list_steps()}", flush=True)
        for n, s in enumerate(stores):
            print(f"phase 20 (b) fit {n + 1}: checkpoint {s['bytes']} bytes, serialized in {s['serialize_s']:.3f} s, "
                  f"written in {s['write_s']:.3f} s on its thread, {s['waited_s']:.3f} s waited at the fit's end",
                  flush=True)
        out["cli_mongo_vae"].update(store=stores[0], resume_store=stores[1:], resume_s=got["seconds"])
    finally:
        cli._batch_factory = inner_factory
        CheckpointCallback.on_fit_end, Trainer._maybe_resume = inner_end, inner_resume
        os.chdir(cwd)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name, rs in rows.items():
        for r in rs:
            if r["path"] in ("sdxl", "cli_vae"):
                lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
                print(f"phase 20 {name} {r['shape']} ({r['path']}, {r['per_step']} a step): {r['ms']:.3f} ms, bound "
                      f"{r['bound_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library {lib} ms, max abs err "
                      f"{r['max_abs_err']:.3e}", flush=True)
    out["cli_mongo_sdxl"]["phase_s"] = time.perf_counter() - t0
    print(f"phase 20: {out['cli_mongo_sdxl']['phase_s']:.1f} s", flush=True)
    return out


def kernel_kind(name: str) -> str:
    """Which layer a device kernel belongs to, by its name."""
    low = name.lower()
    if "flash_" in low or "conv3x3_wgmma" in low:
        return "port kernels"
    if "nccl" in low:
        return "collectives (NCCL)"
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn")):
        return "library conv"
    if any(s in low for s in ("gemm", "nvjet", "cublas", "cutlass")):
        return "library matmul"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, norms, reductions, optimizer)"


def profile_fn(torch, fn, label: str, step_ms, top: int = 15, host: bool = True) -> dict:
    """``fn`` once under torch.profiler: device time by kernel and by kind,
    and (given the median unprofiled ``step_ms``) the device's busy share.
    ``host=False`` traces the device alone (a long call's host events only
    cost time here)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
    report: dict = {"card": smi, "paths": {path: unit for path, (_key, unit) in PATHS.items()}, "phase_s": {}}
    log: list = []
    last = [t_start]

    def lap(phases: str) -> None:
        """Seconds since the previous lap, printed and kept under ``phases``."""
        now = time.perf_counter()
        report["phase_s"][phases] = now - last[0]
        last[0] = now
        print(f"phases {phases}: {report['phase_s'][phases]:.1f} s", flush=True)

    try:
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
        print(smi, flush=True)

        t0 = time.perf_counter()
        compile_s = _nvcc.build_all(_nvcc.SOURCES, verbose=True)
        report["build_s"] = time.perf_counter() - t0
        print(f"build: {report['build_s']:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in compile_s.items())})",
              flush=True)

        lap("1-2")
        rows = {**check_flash(torch, log), **check_overlap(torch, log), **check_conv(torch, log)}
        report["kernel_rows"] = rows
        for name, rs in rows.items():
            for r in rs:
                lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
                ffma = f", FFMA bound {r['ffma_bound_ms']:.3f} ms" if "ffma_bound_ms" in r else ""
                if "kernels_ms" in r:
                    ffma += "; " + ", ".join(f"{k} {v:.3f}" for k, v in r["kernels_ms"].items())
                print(f"{name} {r['shape']} ({r['path']}): {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                      f"library {lib} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}){ffma}", flush=True)

        report["reference"] = reference_step(torch, log)
        report["reference_sdxl"] = reference_step(torch, log, sdxl=True)
        report["reference_vae_gan"] = reference_vae_pair(torch, log)
        report["reference_vae_gan_f32"] = reference_vae_pair(torch, log, fp32=True)
        report["reference_vae_tiny"] = reference_vae_pair(torch, log, fp32=True, tiny=True)
        lap("3")
        report["reference_encode"] = reference_encode(torch, log)
        lap("4")
        report["slice"] = run_slice(torch, rows)
        torch.cuda.empty_cache()
        report["sd15_f32"] = run_slice(torch, rows, "sd15_f32")
        torch.cuda.empty_cache()
        lap("5-6b")
        report["vae_gan"] = run_vae_gan(torch, rows)
        torch.cuda.empty_cache()
        report["vae_gan_f32"] = run_vae_gan(torch, rows, "vae_gan_f32")
        torch.cuda.empty_cache()
        lap("7-8")
        report["sdxl"] = run_slice(torch, rows, "sdxl")
        sdxl_engine = report["sdxl"].pop("engine")
        lap("9")
        report["reference_sample"] = reference_sample(torch, log)
        report.update(run_sample(torch, rows, sdxl_engine))
        del sdxl_engine
        torch.cuda.empty_cache()
        lap("12")
        report["overlap"] = run_overlap(torch, rows, log)
        torch.cuda.empty_cache()
        lap("10")
        report.update(run_cli_phase(torch, rows))
        torch.cuda.empty_cache()
        lap("11")
        report.update(run_cli_sampling(torch, rows))
        torch.cuda.empty_cache()
        lap("13")
        report["cli_sdxl_te"] = run_te_phase(torch, rows)
        torch.cuda.empty_cache()
        lap("14")
        report.update(run_options_phase(torch, rows, report, log))
        torch.cuda.empty_cache()
        lap("15")
        report.update(run_vq_phase(torch, rows, log))
        torch.cuda.empty_cache()
        lap("16")
        report.update(run_mesh_phase(torch, rows, report))
        torch.cuda.empty_cache()
        lap("17")
        report.update(run_ring_phase(torch, rows, log))
        torch.cuda.empty_cache()
        lap("18")
        report.update(run_dreamsim_phase(torch, rows, log))
        torch.cuda.empty_cache()
        lap("19")
        report.update(run_mongo_phase(torch, rows))
        lap("20")
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
                            shape=head["shape"], path=head["path"],
                            **({"ffma_bound_ms": head["ffma_bound_ms"]} if "ffma_bound_ms" in head else {})))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _write(report: dict, log: list) -> None:
    OUT_FILE.parent.mkdir(parents=True, exist_ok=True)
    OUT_FILE.write_text(json.dumps(dict(report, checks=log), indent=1, default=str))


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == [RANK_FLAG] else main())
