"""Experiment: does forming the next chunk's logits ahead of this chunk's
softmax speed up the flash forward? (port of tools/overlap_bench.py)

    python -m neurosis_tpu_torch.tools.overlap_bench      # one CUDA card

Prints one JSON line ``{"check_maxabs_l2": ...}`` (base against split2 at
(1, 2, 1024, 1024, 64)), then one line per case with ``tf_s`` (4·B·H·Sq·Skv·D
operations over the time) and ``us_per_call``, timed with CUDA events over
50 calls after 3 to warm up. Inputs are bf16 at head dim 64, from a seed.

Variants, and how the TPU tool's cases map onto the card:
  base    — the port's shipped forward, ``flash_fwd``. The TPU cases name
            block sizes (one-pass 1024/1024, 512/1024) that exist to fit
            VMEM; the CUDA kernel has one tiling at head dim 64 (128 query
            rows, 128-row kv tiles), so both base cases launch it as it ships.
  split2  — ``flash_fwd_split2``: the kv row as 2 halves.
  chunkN  — ``flash_fwd_chunked`` with N chunks (1 to 16).
The TPU kernels' ``block_q`` (512, 1024, 2048) sizes the VMEM block of one
grid cell and is no launch parameter here: a CUDA block owns 128 query rows
whatever the case. Cases that differ only in ``block_q`` keep their labels
and launch the same kernel, so their spread is the run-to-run noise. A chunk
is staged through shared memory in at most 128 rows (``csrc/flash_overlap.cu``),
so every case of this list, whose chunks are 128 to 2048 rows, runs 128-row
stages; the chunk count changes the schedule only below 128 rows a chunk.
split2 and chunkN differ from base in their schedule alone: the next stage's
logits are issued before this stage's softmax, so the tensor cores form them
while the CUDA cores run the exponentials.
"""

from __future__ import annotations

import json
import math
import sys

import torch

from .._device import DeviceLike, resolve_device
from ..ops.flash_attention import LOG2_E, flash_fwd
from ..ops.flash_overlap import flash_fwd_chunked, flash_fwd_split2

HEAD_DIM = 64
WARMUP, ITERS = 3, 50  # calls of a case before and under the clock
# (label, variant, chunks, sq, skv, batch, heads): the shapes of tools/overlap_bench.py:192-208
CASES = (
    ("l2-1024 base(onepass)", "base", 1, 1024, 1024, 2, 20),
    ("l2-1024 split2", "split2", 2, 1024, 1024, 2, 20),
    ("l1-4096 base(512/1024)", "base", 1, 4096, 4096, 2, 10),
    ("l1-4096 split2(bk=4096→2x2048)", "split2", 2, 4096, 4096, 2, 10),
    ("l2-1024 chunk2", "chunked", 2, 1024, 1024, 2, 20),
    ("l2-1024 chunk4", "chunked", 4, 1024, 1024, 2, 20),
    ("l1-4096 chunk4x1024", "chunked", 4, 4096, 4096, 2, 10),
    ("l1-4096 chunk8x512", "chunked", 8, 4096, 4096, 2, 10),
    ("l1-4096 chunk4-bq1024", "chunked", 4, 4096, 4096, 2, 10),
    ("l1-4096 chunk8-bq1024", "chunked", 8, 4096, 4096, 2, 10),
    ("l1-4096 chunk16-bq1024", "chunked", 16, 4096, 4096, 2, 10),
    ("l1-4096 chunk8-bq2048", "chunked", 8, 4096, 4096, 2, 10),
    ("l2-1024 chunk8", "chunked", 8, 1024, 1024, 2, 20),
    ("x77 chunk1-bq1024", "chunked", 1, 1024, 128, 2, 20),
)


def variant_fwd(variant: str, chunks: int):
    """fn(q, k, v) → o for one variant; q is scaled by scale·log2(e) and
    rounded first, as every variant of the TPU tool does (:104,130,154)."""
    def fwd(q, k, v):
        qs = (q * (LOG2_E / math.sqrt(q.shape[-1]))).to(q.dtype)
        if variant == "base":
            return flash_fwd(qs, k, v)[0]
        if variant == "split2":
            return flash_fwd_split2(qs, k, v)
        if variant == "chunked":
            return flash_fwd_chunked(qs, k, v, chunks)
        raise ValueError(f"unknown variant {variant!r}")

    return fwd


def make_inputs(sq: int, skv: int, batch: int, heads: int, device: DeviceLike = None):
    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(0)
    q = torch.randn(batch, heads, sq, HEAD_DIM, generator=g, device=device).bfloat16()
    k, v = (torch.randn(batch, heads, skv, HEAD_DIM, generator=g, device=device).bfloat16() for _ in range(2))
    return q, k, v


def check(fn_a, fn_b, sq: int, skv: int, batch: int, heads: int, device: DeviceLike = None) -> float:
    """max |fn_a − fn_b| on one seeded input."""
    q, k, v = make_inputs(sq, skv, batch, heads, device)
    return float((fn_a(q, k, v).float() - fn_b(q, k, v).float()).abs().max())


def bench(fn, sq: int, skv: int, batch: int, heads: int, device: DeviceLike = None):
    """(TFLOP/s, µs per call) of ``fn`` on the card, by CUDA events."""
    q, k, v = make_inputs(sq, skv, batch, heads, device)
    if q.device.type != "cuda":
        raise RuntimeError("bench times kernels on a CUDA card")
    for _ in range(WARMUP):
        fn(q, k, v)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn(q, k, v)
    end.record()
    torch.cuda.synchronize()
    dt = start.elapsed_time(end) / ITERS * 1e-3
    return 4 * batch * heads * sq * skv * HEAD_DIM / dt / 1e12, dt * 1e6


def main() -> int:
    err = check(variant_fwd("base", 1), variant_fwd("split2", 2), 1024, 1024, 1, 2)
    print(json.dumps({"check_maxabs_l2": err}), flush=True)
    for label, variant, chunks, sq, skv, batch, heads in CASES:
        tf, us = bench(variant_fwd(variant, chunks), sq, skv, batch, heads)
        print(json.dumps({"case": label, "tf_s": round(tf, 2), "us_per_call": round(us, 1)}, ensure_ascii=False),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
