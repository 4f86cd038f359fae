"""What paces the fp32 flash kernels: device times of the kernels and of patched builds.

    python -m neurosis_tpu_torch.tools.flash_f32_probes     # repository root, one CUDA card

``flash_fwd_f32`` and ``flash_bwd_f32`` form every fp32 product as three TF32
tensor-core products of split operands (``csrc/flash_attention.cu``). This tool
times them at the fp32 shapes of chip_smoke.py's paths (the backward's split
passes, dQ and dK/dV kernels together), with the largest error against the plain
fp32 version, and times two variants of the source (text replacements, listed in
PROBES) built into neurosis_tpu_torch/_build. Their outputs are wrong by design;
they take work away and show what the rest costs:
  - ``one_pass``: only hi.hi of each product (a third of the tensor work and
    of the operand reads from shared memory; the same loads by TMA);
  - ``no_products``: no wgmma at all (the loads, the softmax or the elementwise
    work of the backward, the barriers).
A probe whose text no longer matches the source is reported and skipped.
One JSON line per shape and direction: each build's device ms (the mean of 10 calls queued
while the card sleeps) and the card's name and power limit. No library call is
timed here: the package never calls one (flash_times.py times SDPA beside it).
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

SHAPES = [(2, 1, 16384, 16384, 512), (4, 1, 4096, 4096, 512), (8, 1, 1024, 1024, 512), (1, 1, 1024, 1024, 512),
          (2, 10, 4096, 4096, 64), (1, 8, 1024, 1024, 40), (1, 8, 1024, 77, 40)]
BWD_SHAPES = [(8, 1, 1024, 1024, 512), (2, 10, 4096, 4096, 64), (1, 8, 1024, 1024, 40)]
_SMALL_QK = "for (int kk = 0; kk < 4; ++kk) {\n    WgmmaTf32<N>::ss(d, sw128_desc(qh + 32 * kk, 0), sw128_desc(kl"
_SMALL_PV = "for (int kk = 0; kk < 4; ++kk) {\n      const unsigned char* pk"
_QK_BODY = "const unsigned char* kh, const unsigned char* kl, int accumulate) {\n"
_PV_BODY = "const unsigned char* vh1, int v_lo) {\n"
PROBES = {
    "one_pass": [(_SMALL_QK, _SMALL_QK.replace("kk < 4", "kk < 0")), (_SMALL_PV, _SMALL_PV.replace("kk < 4", "kk < 0"))],
    "no_products": [(_QK_BODY, _QK_BODY + "  return;\n"), (_PV_BODY, _PV_BODY + "  return;\n")],
}


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


def build_probes(nvcc_mod, source: str = "flash_attention", probes: dict = PROBES) -> dict:
    """name -> path of the built library of each probe (text replacements in
    csrc/<source>.cu) that applies to the source."""
    src = (nvcc_mod.CSRC / f"{source}.cu").read_text()
    nvcc_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, reps in probes.items():
        text = src
        for old, new in reps:
            if old not in text:
                print(json.dumps(dict(probe=name, skipped=f"its text is not in csrc/{source}.cu")), flush=True)
                break
            text = text.replace(old, new)
        else:
            cu = nvcc_mod.BUILD_DIR / f"probe_{source}_{name}.cu"
            cu.write_text(text)
            so = nvcc_mod.BUILD_DIR / f"libprobe_{source}_{name}.so"
            cmd = [nvcc_mod.nvcc(), *nvcc_mod.NVCC_FLAGS, "-I", str(nvcc_mod.CSRC), "-o", str(so), str(cu)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
        out[name] = so
    return out


def main() -> int:
    import torch

    from neurosis_tpu_torch import _nvcc
    from neurosis_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_f32_probes needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = {"kernel": _nvcc.load("flash_attention")}
    libs.update({name: ctypes.CDLL(str(so)) for name, so in build_probes(_nvcc).items()})
    for direction, shape in [("fwd", sh) for sh in SHAPES] + [("bwd", sh) for sh in BWD_SHAPES]:
        b, h, sq, skv, d = shape
        g = torch.Generator("cuda").manual_seed(sum(shape))
        q, do = (torch.randn(b, h, sq, d, generator=g, device="cuda") for _ in range(2))
        k, v = (torch.randn(b, h, skv, d, generator=g, device="cuda") for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        qs = q * (scale * fa.LOG2_E)
        o_ref, lse = fa.flash_fwd_plain(qs, k, v)
        di = (do * o_ref).sum(-1)
        if direction == "fwd":
            run, plain = (lambda: fa.flash_fwd_f32(qs, k, v)[:1]), (lambda: (o_ref,))
        else:
            run = lambda: fa.flash_bwd_f32(qs, k, v, do, lse, di, scale)
            plain = lambda: fa.flash_bwd_plain(qs, k, v, do, lse, di, scale)
        row = dict(direction=direction, shape=list(shape), card=card)
        for name, lib in libs.items():
            _nvcc._loaded["flash_attention"] = lib  # the wrapper launches this build
            if name == "kernel":
                row["rel_err"] = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(run(), plain()))
            row[f"{name}_ms"] = device_ms(torch, run)
        _nvcc._loaded["flash_attention"] = libs["kernel"]
        print(json.dumps(row), flush=True)
        del q, k, v, do, qs, o_ref, lse, di
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
