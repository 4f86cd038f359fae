"""Host time, device time and UNet-phase memory of a few SDXL training steps through the CLI.

    python -m neurosis_tpu_torch.tools.step_probe [--steps N] [--remat none,none,dots_names] [--label NAME]
        # repository root, one CUDA card

Fits a copy of ``configs/sdxl/sdxl.example.yaml`` as ``chip_smoke.py``'s
phase 11 runs its bf16 copy: ``precision: bf16-mixed``, random weights, the
hash tokenizer, an image folder of 8 PNGs at 1024-1280 px. ``--remat`` sets
the UNet's ``remat_policy`` (one policy, or one a level, comma-separated);
without it the UNet runs full remat as the config is written. Environment
variables the package reads (``NEUROSIS_GN_VJP``) reach it as they are set.
The run takes ``--steps`` unprofiled steps, then one more under
torch.profiler. Prints one JSON line:

- ``host_ms``: each unprofiled step's ``step_ms`` from ``metrics.jsonl``
  (the step and a device sync, on the host's clock);
- ``device_ms``, ``launches``: the profiled step's device busy time (the
  union of its kernels' intervals) and kernel count;
- ``unet_base_bytes``, ``unet_peak_bytes``: each step's device memory
  allocated when the UNet's forward starts, and the peak from there to the
  optimizer's step (the UNet forward and backward: the peak statistics are
  reset at the forward's start and read at the step's);
- ``run_peak_bytes``: the whole run's peak; ``card``: the card's name and
  power limit as nvidia-smi gives them.

The work directory, ``chiprun_out/step_probe/<label>``, is removed at the
end. The probe drives
only what the CLI has long offered, so it also runs from an older checkout
(copy this file into it).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

SIZES = [(1024, 1024), (1088, 1024), (1024, 1088), (1152, 1040), (1040, 1152), (1100, 1040), (1280, 1216),
         (1216, 1280)]
WRITTEN = "  fast_dev_run: true  # disable to actually train\n"
EPOCHS = "  max_epochs: 1\n"  # 8 images at batch 2: 4 steps an epoch
CHECKPOINTED = "        use_checkpoint: true\n"
SPAN = "neurosis/train_step"


def write_folder(torch, folder: Path, seed: int = 11) -> None:
    """SIZES as PNGs of smooth random fields, each with a caption."""
    import torch.nn.functional as F

    from neurosis_tpu_torch.data.png import write_png

    folder.mkdir(parents=True, exist_ok=True)
    g = torch.Generator("cpu").manual_seed(seed)
    tags = ["a photo", "smooth field", "soft light", "outdoors", "blue sky", "grass", "portrait", "landscape"]
    for i, (w, h) in enumerate(SIZES):
        img = F.interpolate(torch.rand(1, 3, h // 32, w // 32, generator=g), size=(h, w), mode="bilinear",
                            align_corners=False)
        img = (img + 0.05 * torch.randn(1, 3, h, w, generator=g)).clamp(0, 1)
        write_png(folder / f"img_{i}.png", (img[0] * 255).round().to(torch.uint8).permute(1, 2, 0).numpy())
        picks = torch.randperm(len(tags), generator=g)[:4].tolist()
        (folder / f"img_{i}.txt").write_text(", ".join(tags[j] for j in picks))


def config_text(repo: Path, steps: int, remat: str | None) -> str:
    text = (repo / "configs/sdxl/sdxl.example.yaml").read_text()
    for line in (WRITTEN, EPOCHS, CHECKPOINTED):
        if text.count(line) != 1:
            raise SystemExit(f"sdxl.example.yaml no longer has the line {line!r} once")
    text = text.replace(WRITTEN, f"  fast_dev_run: false\n  max_steps: {steps}\n  precision: bf16-mixed\n")
    text = text.replace(EPOCHS, f"  max_epochs: {steps}\n")
    if remat:
        text = text.replace(CHECKPOINTED, CHECKPOINTED + f"        remat_policy: [{', '.join(remat.split(','))}]\n")
    return text


def busy_ms(torch, prof) -> tuple[float | None, int]:
    """The device busy ms and kernel count inside the profile's step span."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events if e.name == SPAN and e.device_type != cuda]
    if len(spans) != 1:
        raise SystemExit(f"the profile holds {len(spans)} step spans, not 1")
    s0, s1 = spans[0]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
                     and e.time_range.start >= s0 and e.time_range.end <= s1)
    busy, end = 0.0, -math.inf
    for k0, k1 in kernels:
        if k1 > end:
            busy += k1 - max(k0, end)
            end = k1
    return (busy / 1e3 if kernels else None), len(kernels)


def main() -> int:
    parser = argparse.ArgumentParser(prog="step_probe")
    parser.add_argument("--steps", type=int, default=6, help="unprofiled steps (one profiled step follows)")
    parser.add_argument("--remat", default=None, help="remat_policy, one or a level each, comma-separated")
    parser.add_argument("--label", default="probe")
    args = parser.parse_args()

    import torch
    from torch.optim.optimizer import register_optimizer_step_pre_hook
    from torch.profiler import ProfilerActivity, profile

    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.trainer import cli
    from neurosis_tpu_torch.trainer.loop import Trainer

    if not torch.cuda.is_available():
        print("step_probe needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    repo = Path.cwd().resolve()
    work = repo / "chiprun_out" / "step_probe" / args.label
    shutil.rmtree(work, ignore_errors=True)
    write_folder(torch, work / "data" / "dataset" / "folder")
    config = work / "sdxl.yaml"
    config.write_text(config_text(repo, args.steps + 1, args.remat))

    base, peaks, run_peaks, profiles, steps = [], [], [], [], []
    inner_forward, inner_step = UNetModel.forward, Trainer._step
    now = dict(in_step=False, forward_seen=False)

    def forward(self, *a, **k):  # the step's first UNet forward that records a graph
        if now["in_step"] and not now["forward_seen"] and torch.is_grad_enabled():
            now["forward_seen"] = True
            torch.cuda.synchronize()
            base.append(torch.cuda.memory_allocated())
            run_peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        return inner_forward(self, *a, **k)

    def before_update(optimizer, *a):
        if now["in_step"]:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())

    def step(self, *a, **k):
        now.update(in_step=True, forward_seen=False)
        try:
            if len(steps) < args.steps:
                return inner_step(self, *a, **k)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = inner_step(self, *a, **k)
            profiles.append(prof)
            return out
        finally:
            now["in_step"] = False
            steps.append(1)

    UNetModel.forward, Trainer._step = forward, step
    hook = register_optimizer_step_pre_hook(before_update)
    os.environ["NEUROSIS_ALLOW_HASH_TOKENIZER"] = "1"
    os.chdir(work)
    try:
        rc = cli.main(["fit", "-c", str(config)])
        torch.cuda.synchronize()
    finally:
        UNetModel.forward, Trainer._step = inner_forward, inner_step
        hook.remove()
        os.chdir(repo)
    run_peak = max(run_peaks + [torch.cuda.max_memory_allocated()])
    if rc != 0:
        raise SystemExit(f"main() returned {rc}")
    lines = [json.loads(x) for x in (work / "projects/logs/metrics.jsonl").read_text().splitlines()]
    shutil.rmtree(work)
    if len(lines) != args.steps + 1 or not all(math.isfinite(r["loss"]) for r in lines):
        raise SystemExit(f"metrics.jsonl: {[(r['step'], r['loss']) for r in lines]}")
    device_ms, launches = busy_ms(torch, profiles[0])
    print(json.dumps(dict(label=args.label, remat=args.remat, gn_vjp=os.environ.get("NEUROSIS_GN_VJP", "0"),
                          host_ms=[r["step_ms"] for r in lines[:-1]], device_ms=device_ms, launches=launches,
                          unet_base_bytes=base, unet_peak_bytes=peaks, run_peak_bytes=run_peak, card=card)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
