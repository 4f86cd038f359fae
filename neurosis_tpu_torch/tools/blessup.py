"""VAE brightness and contrast "blessing" (port of
neurosis_tpu/tools/blessup.py; parity: utils/blessup/bless.py:14-200):
scales or offsets the decoder's conv_out (or the encoder's conv_in) weights
of an LDM-layout VAE checkpoint.

    python -m neurosis_tpu_torch.tools.blessup model.safetensors out.safetensors \\
        --contrast 1.05 --brightness 0.02 [--encoder]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

ADJUST_KEYS = {
    "decoder": {"contrast": "decoder.conv_out.weight", "brightness": "decoder.conv_out.bias"},
    "encoder": {"contrast": "encoder.conv_in.weight", "brightness": "encoder.conv_in.bias"},
}


def bless(state: dict, contrast: float = 1.0, brightness: float = 0.0,
          contrast_op: str = "mul", brightness_op: str = "add", target: str = "decoder") -> dict:
    """``state`` with the contrast applied to the target's weight and the
    brightness to its bias (also under ``first_stage_model.``); the value
    is cast to the tensor's dtype first, as numpy casts a Python float."""
    keys = ADJUST_KEYS[target]
    out = dict(state)
    ops = {"mul": torch.mul, "add": torch.add}
    for what in ("contrast", "brightness"):
        key = keys[what]
        if key not in out:
            key = f"first_stage_model.{key}"  # a full checkpoint
            if key not in out:
                continue
        t = torch.as_tensor(out[key])
        value = contrast if what == "contrast" else brightness
        op = ops[contrast_op if what == "contrast" else brightness_op]
        out[key] = op(t, torch.tensor(value, dtype=t.dtype))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model_path", type=Path)
    parser.add_argument("output_path", type=Path)
    parser.add_argument("--contrast", type=float, default=1.0)
    parser.add_argument("--brightness", type=float, default=0.0)
    parser.add_argument("--contrast-op", choices=["mul", "add"], default="mul")
    parser.add_argument("--brightness-op", choices=["mul", "add"], default="add")
    parser.add_argument("--encoder", action="store_true", help="adjust encoder conv_in instead")
    args = parser.parse_args(argv)

    from ..checkpoint.safetensors import save_file
    from ..checkpoint.sgm import load_state_dict

    state = bless(load_state_dict(args.model_path), contrast=args.contrast, brightness=args.brightness,
                  contrast_op=args.contrast_op, brightness_op=args.brightness_op,
                  target="encoder" if args.encoder else "decoder")
    args.output_path.parent.mkdir(parents=True, exist_ok=True)
    save_file(state, args.output_path)
    print(f"blessed → {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
