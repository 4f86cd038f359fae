"""Device times of the port's flash kernels at the shapes of the paths of chip_smoke.py.

    python3 flash_times.py          # from the root of a checkout, one CUDA card

It times the ``neurosis_tpu_torch`` beside it, so a copy of this file in another
checkout's root times that checkout's kernels: two commits are compared in one
run on one card with one method, which is what it is for. One JSON line
per shape: ``flash_fwd`` and ``flash_bwd`` (the wrappers, extra passes included;
fp32 inputs go to the fp32 kernels) and SDPA's forward and backward on the same
inputs, each the mean device ms of 10 calls queued while the card sleeps
(chip_smoke.py's method), and the card. A shape the checkout's kernels refuse
gets its error in place of the times. Then one line per shape and chunk count
of the flash-overlap tool: ``chunked_ms`` (``flash_fwd_chunked``),
``split2_ms`` (``flash_fwd_split2``, at 2 chunks), ``base_ms`` (the shipped
``flash_fwd`` on the same inputs, the tool's base case) and SDPA's forward.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

# (B, H, Sq, Skv, D, dtype, backward timed): SD1.5 (512 px, batch 4) and SDXL (1024
# px, batch 2) self and cross attention, the flash-overlap tool's base case, the
# bf16 VAE-GAN pair's mid attention; in fp32 the frozen encodes of SDXL and SD1.5,
# the fp32 VAE-GAN pair, the fp32 UNets of sd15.example.yaml (256 px, batch 1)
# and sdxl.example.yaml, and the smoke VAEs (sd15-tiny's encode, vae-tiny's training)
SHAPES = [(4, 8, 4096, 4096, 40, "bf16", True), (4, 8, 4096, 77, 40, "bf16", True),
          (4, 8, 1024, 1024, 80, "bf16", True), (4, 8, 1024, 77, 80, "bf16", True),
          (2, 10, 4096, 4096, 64, "bf16", True), (2, 10, 4096, 77, 64, "bf16", True),
          (2, 20, 1024, 1024, 64, "bf16", True), (2, 20, 1024, 77, 64, "bf16", True),
          (1, 2, 1024, 1024, 64, "bf16", True), (8, 1, 1024, 1024, 512, "bf16", True),
          (2, 1, 16384, 16384, 512, "fp32", False), (4, 1, 4096, 4096, 512, "fp32", False),
          (8, 1, 1024, 1024, 512, "fp32", True), (1, 8, 1024, 1024, 40, "fp32", True),
          (1, 8, 1024, 77, 40, "fp32", True), (2, 10, 4096, 4096, 64, "fp32", True),
          (2, 10, 4096, 77, 64, "fp32", True), (2, 20, 1024, 1024, 64, "fp32", True),
          (2, 20, 1024, 77, 64, "fp32", True), (1, 1, 1024, 1024, 64, "fp32", False),
          (2, 1, 1024, 1024, 64, "fp32", True)]
# (B, H, Sq, Skv, chunks): the shapes and chunk counts of the flash-overlap
# tool's cases (neurosis_tpu_torch/tools/overlap_bench.py), bf16 at head dim 64
OVERLAP_SHAPES = [(2, 20, 1024, 1024, 2), (2, 20, 1024, 1024, 4), (2, 20, 1024, 1024, 8), (2, 10, 4096, 4096, 2),
                  (2, 10, 4096, 4096, 4), (2, 10, 4096, 4096, 8), (2, 10, 4096, 4096, 16), (2, 20, 1024, 128, 1)]


def device_ms(torch, fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # clock cycles: the host queues the calls meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_times needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for b, h, sq, skv, d, dtype_name, with_bwd in SHAPES:
        dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
        g = torch.Generator("cuda").manual_seed(sq + skv + d)
        q, do = (torch.randn(b, h, sq, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(b, h, skv, d, generator=g, device="cuda").to(dtype) for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        qs = (q * (scale * fa.LOG2_E)).to(dtype)
        line = dict(shape=[b, h, sq, skv, d], dtype=dtype_name, card=card)
        try:
            o, lse = fa.flash_fwd(qs, k, v)
        except ValueError as e:  # a head dim this checkout's kernels do not take
            print(json.dumps(dict(line, error=str(e))), flush=True)
            continue
        line["fwd_ms"] = device_ms(torch, lambda: fa.flash_fwd(qs, k, v))
        line["sdpa_fwd_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        if with_bwd:
            di = (do.float() * o.float()).sum(-1)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qg, kg, vg)
            line["bwd_ms"] = device_ms(torch, lambda: fa.flash_bwd(qs, k, v, do, lse, di, scale))
            line["sdpa_bwd_ms"] = device_ms(
                torch, lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True))
            del lib_out, qg, kg, vg
        print(json.dumps(line), flush=True)
        del q, k, v, do, qs, o, lse
        torch.cuda.empty_cache()

    from neurosis_tpu_torch.ops import flash_overlap as fo

    for b, h, sq, skv, chunks in OVERLAP_SHAPES:
        g = torch.Generator("cuda").manual_seed(sq + skv + chunks)
        q = torch.randn(b, h, sq, 64, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(b, h, skv, 64, generator=g, device="cuda").bfloat16() for _ in range(2))
        qs = (q * (fa.LOG2_E / 8.0)).to(q.dtype)
        line = dict(shape=[b, h, sq, skv, 64], dtype="bf16", chunks=chunks, card=card)
        line["chunked_ms"] = device_ms(torch, lambda: fo.flash_fwd_chunked(qs, k, v, chunks))
        if chunks == 2:
            line["split2_ms"] = device_ms(torch, lambda: fo.flash_fwd_split2(qs, k, v))
        line["base_ms"] = device_ms(torch, lambda: fa.flash_fwd(qs, k, v))
        line["sdpa_fwd_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        print(json.dumps(line), flush=True)
        del q, k, v, qs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
