"""Does the overlap forward gain from its schedule? Device times of the kernel and of a patched build.

    python -m neurosis_tpu_torch.tools.overlap_probes      # repository root, one CUDA card

``flash_fwd_chunked`` (``csrc/flash_overlap.cu``) issues stage s+1's logits
before stage s's softmax, so the tensor cores form them while the CUDA cores
run the exponentials. The ``serial`` probe (text replacements, built into
neurosis_tpu_torch/_build) issues them after stage s's P V is done, as the
shipped forward ``flash_fwd`` orders its work; all else is the same kernel,
so the two builds' difference is the schedule's. One JSON line per shape and
chunk count of the overlap tool's cases: the kernel's and the probe's device ms
(the mean of 10 calls queued while the card sleeps), the shipped forward's on
the same inputs, each build's largest error against the plain version, and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from .flash_f32_probes import build_probes, device_ms

# (B, H, Sq, Skv, chunks): the overlap tool's shapes and chunk counts
SHAPES = [(2, 20, 1024, 1024, 2), (2, 20, 1024, 1024, 8), (2, 10, 4096, 4096, 2), (2, 10, 4096, 4096, 8),
          (2, 10, 4096, 4096, 16)]
_EARLY = "  if (s + 1 < p.n_stages) issue_logits(nxt, q_wg, sK, kv_full, s + 1);\n"
_WAIT = "  wgmma_wait<0>();\n  reg_fence(nxt);\n  reg_fence(st.o);\n"
PROBES = {
    "serial": [(_EARLY, ""), (_WAIT, "  wgmma_wait<0>();\n  reg_fence(st.o);\n  if (s + 1 < p.n_stages) {\n"
                                     "    issue_logits(nxt, q_wg, sK, kv_full, s + 1);\n    wgmma_wait<0>();\n"
                                     "    reg_fence(nxt);\n  }\n")],
}


def main() -> int:
    import torch

    from neurosis_tpu_torch import _nvcc
    from neurosis_tpu_torch.ops import flash_attention as fa
    from neurosis_tpu_torch.ops import flash_overlap as fo

    if not torch.cuda.is_available():
        print("overlap_probes needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = {"kernel": _nvcc.load("flash_overlap")}
    libs.update({name: ctypes.CDLL(str(so)) for name, so in build_probes(_nvcc, "flash_overlap", PROBES).items()})
    for b, h, sq, skv, chunks in SHAPES:
        g = torch.Generator("cuda").manual_seed(sq + skv + chunks)
        q = torch.randn(b, h, sq, 64, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(b, h, skv, 64, generator=g, device="cuda").bfloat16() for _ in range(2))
        qs = (q * (fa.LOG2_E / 8.0)).to(q.dtype)
        want = fo.flash_fwd_chunked_plain(qs, k, v, chunks).float()
        row = dict(shape=[b, h, sq, skv, 64], chunks=chunks, card=card)
        for name, lib in libs.items():
            _nvcc._loaded["flash_overlap"] = lib  # the wrapper launches this build
            got = fo.flash_fwd_chunked(qs, k, v, chunks).float()
            row[f"{name}_rel_err"] = float((got - want).abs().max() / want.abs().max())
            row[f"{name}_ms"] = device_ms(torch, lambda: fo.flash_fwd_chunked(qs, k, v, chunks))
        _nvcc._loaded["flash_overlap"] = libs["kernel"]
        row["base_ms"] = device_ms(torch, lambda: fa.flash_fwd(qs, k, v))
        print(json.dumps(row), flush=True)
        del q, k, v, qs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
