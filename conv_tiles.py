"""Device times of the 3x3 conv kernel at every tile it takes, and of probes of its prologue.

    python3 conv_tiles.py            # from the root of a checkout, one CUDA card
    python3 conv_tiles.py --probes   # also two patched builds of csrc/conv3x3.cu

``ops/conv3x3.py:conv_tile`` picks a launch's tile (tr image rows, cw columns, bn
output channels); its cost model was fitted to this sweep. For each shape below it
times the plain conv and the fused GroupNorm+SiLU conv at each tile, calling the
library's C entry points with the tile given, and prints one JSON line per shape
and tile: device ms (chip_smoke.py's method), the error against the plain PyTorch
versions, whether the picker takes that tile, and the card's name and power limit.

With ``--probes`` it also builds two variants of the kernel source (text
replacements, listed in PROBES) into neurosis_tpu_torch/_build and times them the
same way. Their outputs are wrong by design; they show what paces the prologue:
  - ``ignore_prologue``: the consumers wait for the raw halo, not for the
    activated one, so the prologue still runs but nothing waits for it;
  - ``prologue_twice``: the prologue's arithmetic runs twice per element.
A probe whose text no longer matches the source is reported and skipped.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

from chip_smoke import time_ms

SHAPES = [(8, 64, 64, 512, 512), (8, 32, 32, 512, 512), (2, 32, 32, 1280, 1280), (2, 64, 64, 640, 640),
          (4, 32, 32, 640, 640), (2, 64, 64, 1280, 1280), (2, 64, 64, 1920, 640)]
TILES = [(8, 16, 256), (8, 16, 160), (8, 16, 128), (8, 16, 64), (4, 32, 128), (2, 64, 128), (2, 64, 256)]
_ACT = """#pragma unroll
          for (int k = 0; k < ACT_ROWS; ++k) gn_silu_chunk(v[k], a0, a1, b0, b1);"""
PROBES = {
    "ignore_prologue": [("uint64_t* halo_bar = GN ? halo_ready : halo_full;", "uint64_t* halo_bar = halo_full;")],
    "prologue_twice": [(_ACT, _ACT + "\n" + _ACT)],
}
_P, _I = ctypes.c_void_p, ctypes.c_int64


def _bind(lib):
    lib.conv3x3_bf16.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    lib.gn_silu_conv3x3_bf16.argtypes = [_P] * 5 + [_I] * 8 + [_P]
    return lib


def _build_probes(nvcc_mod) -> dict:
    """name -> loaded library of each probe that applies to the source."""
    src = (nvcc_mod.CSRC / "conv3x3.cu").read_text()
    nvcc_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, reps in PROBES.items():
        text = src
        for old, new in reps:
            if old not in text:
                print(json.dumps(dict(probe=name, skipped="its text is not in csrc/conv3x3.cu")), flush=True)
                break
            text = text.replace(old, new)
        else:
            cu = nvcc_mod.BUILD_DIR / f"probe_{name}.cu"
            cu.write_text(text)
            so = nvcc_mod.BUILD_DIR / f"libprobe_{name}.so"
            cmd = [nvcc_mod.nvcc(), *nvcc_mod.NVCC_FLAGS, "-I", str(nvcc_mod.CSRC), "-o", str(so), str(cu)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
        libs[name] = _bind(ctypes.CDLL(str(so)))
    return libs


def main() -> int:
    import torch

    from neurosis_tpu_torch import _nvcc
    from neurosis_tpu_torch.ops import conv3x3 as cv

    if not torch.cuda.is_available():
        print("conv_tiles needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = {"kernel": _bind(_nvcc.load("conv3x3"))}
    if "--probes" in sys.argv[1:]:
        libs.update(_build_probes(_nvcc))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in SHAPES:
        b, h, w, c, f = shape
        g = torch.Generator("cuda").manual_seed(sum(shape))
        x = torch.randn(b, h, w, c, generator=g, device="cuda").bfloat16()
        w_k = (torch.randn(3, 3, c, f, generator=g, device="cuda") / math.sqrt(9 * c)).bfloat16()
        a = 1.0 + 0.2 * torch.randn(b, c, generator=g, device="cuda")
        bb = 0.3 * torch.randn(b, c, generator=g, device="cuda")
        refs = {"plain": cv.conv3x3_plain(x, w_k).float(), "fused": cv.gn_silu_conv3x3_plain(x, a, bb, w_k).float()}
        out = torch.empty(b, h, w, f, device="cuda", dtype=torch.bfloat16)
        picks = {"plain": cv.conv_tile(b, h, w, f, sms), "fused": cv.conv_tile(b, h, w, f, sms, prologue=True)}
        for name, lib in libs.items():
            for tile in TILES:
                if tile[1] > w or f % tile[2] != 0 or (name != "kernel" and tile not in picks.values()):
                    continue
                stream = torch.cuda.current_stream().cuda_stream
                calls = {
                    "plain": lambda: lib.conv3x3_bf16(x.data_ptr(), w_k.data_ptr(), out.data_ptr(), b, h, w, c, f,
                                                      *tile, stream),
                    "fused": lambda: lib.gn_silu_conv3x3_bf16(x.data_ptr(), a.data_ptr(), bb.data_ptr(),
                                                              w_k.data_ptr(), out.data_ptr(), b, h, w, c, f, *tile,
                                                              stream),
                }
                row = dict(build=name, shape=list(shape), tile=list(tile), card=card)
                for kind, fn in calls.items():
                    _nvcc.check(fn(), f"{kind} at {tile}")
                    torch.cuda.synchronize()
                    ref = refs[kind]
                    row[f"{kind}_rel_err"] = float((out.float() - ref).abs().max() / ref.abs().max())
                    row[f"{kind}_ms"] = time_ms(torch, fn)
                    row[f"{kind}_picked"] = picks[kind] == tile
                print(json.dumps(row), flush=True)
        del x, w_k, a, bb, refs, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
