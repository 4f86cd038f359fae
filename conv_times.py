"""Device times of the port's 3x3 conv kernels at every conv shape of chip_smoke.py's tables.

    python3 conv_times.py          # from the root of a checkout, one CUDA card

It times the ``neurosis_tpu_torch`` beside it, so a copy of this file in another
checkout's root times that checkout's kernels: two commits are compared in one
run on one card with one method, which is what it is for (flash_times.py does the
same for the flash kernels). The shapes are chip_smoke.py's conv tables (SD1.5
step, bf16 VAE-GAN pair, SDXL step). One JSON line per shape and kind:

  - ``fwd`` and ``dgrad`` of each shape of the ``*CONV_SHAPES`` tables through
    ``conv3x3_nhwc`` (the dgrad on the flipped, in/out-swapped filter, as the
    backward runs it), beside ``F.conv2d`` on the same inputs;
  - ``fused`` for each shape of the ``*GN_CONV_SHAPES`` tables through
    ``gn_silu_conv3x3_nhwc``, beside ``F.conv2d`` on the same x and the
    unfused library pair (the elementwise affine + SiLU, then ``F.conv2d``),
    a yardstick only;

each the mean device ms of 10 calls queued while the card sleeps (chip_smoke.py's
method), with the launches a unit of its path makes, the bound (operations over
989 TFLOP/s bf16 or bytes over 3.35 TB/s, whichever is larger), the kernel's
TFLOP/s and the card's name and power limit. A last line per path sums
launches x kernel ms over its tables.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

from chip_smoke import (
    CONV_SHAPES,
    GN_CONV_SHAPES,
    SDXL_CONV_SHAPES,
    SDXL_GN_CONV_SHAPES,
    VAE_CONV_SHAPES,
    VAE_GN_CONV_SHAPES,
    bound_ms,
    time_ms,
)

TABLES = {"sd15": (CONV_SHAPES, GN_CONV_SHAPES), "vae_gan": (VAE_CONV_SHAPES, VAE_GN_CONV_SHAPES),
          "sdxl": (SDXL_CONV_SHAPES, SDXL_GN_CONV_SHAPES)}


def main() -> int:
    import torch
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops import conv3x3 as cv

    if not torch.cuda.is_available():
        print("conv_times needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for path, (conv_shapes, gn_shapes) in TABLES.items():
        total = 0.0
        for shape, (n_fwd, n_dgrad) in conv_shapes.items():
            b, hh, ww, c, f = shape
            g = torch.Generator("cuda").manual_seed(sum(shape))
            x = torch.randn(b, hh, ww, c, generator=g, device="cuda").bfloat16()
            dy = torch.randn(b, hh, ww, f, generator=g, device="cuda").bfloat16()
            w = (torch.randn(f, c, 3, 3, generator=g, device="cuda") / math.sqrt(9 * c)).bfloat16()
            w_flip = w.flip(2, 3).permute(2, 3, 0, 1).contiguous()  # dgrad filter [3, 3, F, C]
            for kind, n, inp, filt, lib_w, (ci, fo) in (
                ("fwd", n_fwd, x, cv._kernel_filter(w), w, (c, f)),
                ("dgrad", n_dgrad, dy, w_flip, w_flip.permute(3, 2, 0, 1), (f, c)),
            ):
                inp_nchw = inp.permute(0, 3, 1, 2)
                flops = 2.0 * 9 * b * hh * ww * ci * fo
                ms = time_ms(torch, lambda: cv.conv3x3_nhwc(inp, filt))
                total += n * ms
                print(json.dumps(dict(
                    path=path, kind=kind, shape=[b, hh, ww, ci, fo], launches=n, card=card, ms=ms,
                    conv2d_ms=time_ms(torch, lambda: F.conv2d(inp_nchw, lib_w, padding=1)),
                    bound_ms=bound_ms(flops, 2 * (b * hh * ww * (ci + fo) + 9 * ci * fo))[0],
                    tflops=flops / ms / 1e9)), flush=True)
            del x, dy, w, w_flip
        for shape, n in gn_shapes.items():
            b, hh, ww, c, f = shape
            g = torch.Generator("cuda").manual_seed(sum(shape) + 7)
            x = torch.randn(b, hh, ww, c, generator=g, device="cuda").bfloat16()
            w = (torch.randn(f, c, 3, 3, generator=g, device="cuda") / math.sqrt(9 * c)).bfloat16()
            a = 1.0 + 0.2 * torch.randn(b, c, generator=g, device="cuda")
            bb = 0.3 * torch.randn(b, c, generator=g, device="cuda")
            w_k = cv._kernel_filter(w)
            x_nchw = x.permute(0, 3, 1, 2)
            flops = 2.0 * 9 * b * hh * ww * c * f
            ms = time_ms(torch, lambda: cv.gn_silu_conv3x3_nhwc(x, a, bb, w_k))
            total += n * ms
            print(json.dumps(dict(
                path=path, kind="fused", shape=[b, hh, ww, c, f], launches=n, card=card, ms=ms,
                conv2d_ms=time_ms(torch, lambda: F.conv2d(x_nchw, w, padding=1)),
                unfused_ms=time_ms(torch, lambda: F.conv2d(
                    cv.gn_silu_affine(x, a, bb).permute(0, 3, 1, 2), w, padding=1)),
                bound_ms=bound_ms(flops, 2 * (b * hh * ww * (c + f) + 9 * c * f) + 8 * b * c)[0],
                tflops=flops / ms / 1e9)), flush=True)
            del x, w, a, bb, w_k
        torch.cuda.empty_cache()
        print(json.dumps(dict(path=path, card=card, kernel_ms_per_unit=total)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
