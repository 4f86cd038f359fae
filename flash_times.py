"""Device times of the port's bf16 flash kernels at every shape of the SD1.5 and SDXL steps.

    python3 flash_times.py          # from the root of a checkout, one CUDA card

It times the ``neurosis_tpu_torch`` beside it, so a copy of this file in another
checkout's root times that checkout's kernels: two commits are compared in one
run on one card with one method, which is what it is for. One JSON line
per shape: ``flash_fwd`` and ``flash_bwd`` (the wrappers, extra passes included)
and SDPA's forward and backward on the same inputs, each the mean device ms of
10 calls queued while the card sleeps (chip_smoke.py's method), and the card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

# (B, H, Sq, Skv, D): SD1.5 (512 px, batch 4) and SDXL (1024 px, batch 2) self and
# cross attention, and the flash-overlap tool's base case
SHAPES = [(4, 8, 4096, 4096, 40), (4, 8, 4096, 77, 40), (4, 8, 1024, 1024, 80), (4, 8, 1024, 77, 80),
          (2, 10, 4096, 4096, 64), (2, 10, 4096, 77, 64), (2, 20, 1024, 1024, 64), (2, 20, 1024, 77, 64),
          (1, 2, 1024, 1024, 64)]


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
    for b, h, sq, skv, d in SHAPES:
        g = torch.Generator("cuda").manual_seed(sq + skv + d)
        q, do = (torch.randn(b, h, sq, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(b, h, skv, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        qs = (q * (scale * fa.LOG2_E)).to(q.dtype)
        o, lse = fa.flash_fwd(qs, k, v)
        di = (do.float() * o.float()).sum(-1)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg)
        print(json.dumps(dict(
            shape=[b, h, sq, skv, d], card=card,
            fwd_ms=device_ms(torch, lambda: fa.flash_fwd(qs, k, v)),
            bwd_ms=device_ms(torch, lambda: fa.flash_bwd(qs, k, v, do, lse, di, scale)),
            sdpa_fwd_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            sdpa_bwd_ms=device_ms(torch, lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do, retain_graph=True)),
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
