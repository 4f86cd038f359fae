"""Checkpoint conversion tools (port of neurosis_tpu/tools/convert.py;
parity: scripts/convert/*), on the port's safetensors reader and writer:

    python -m neurosis_tpu_torch.tools.convert sd15-ldm2neurosis IN OUT
        # cond_stage_model. → conditioner.embedders.0. (sd15-ldm2neurosis.py:21-30)
    python -m neurosis_tpu_torch.tools.convert extract-vae IN OUT
        # first_stage_model.* as a bare VAE file (vae-neurosis2ldm.py)
    python -m neurosis_tpu_torch.tools.convert patch-te BASE DONOR OUT
        # the donor's text-encoder tensors into the base (sdxl-patch-te.py)
    python -m neurosis_tpu_torch.tools.convert vae2hf IN OUT_DIR [-C sdxl|sd1.5] [--extract]
        # a diffusers AutoencoderKL directory: config.json and
        # diffusion_pytorch_model.safetensors (vae-neurosis2ldm.py --diffusers)

Inputs are ``.safetensors`` files or torch checkpoints (``state_dict``
inside or not); tensors keep their dtypes.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

SD15_LDM_REMAP = {
    "cond_stage_model.": "conditioner.embedders.0.",
}


def remap_sd15_ldm(state: dict) -> dict:
    out = {}
    for k, v in state.items():
        for old, new in SD15_LDM_REMAP.items():
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


def extract_vae(state: dict, prefix: str = "first_stage_model.") -> dict:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def patch_te(base: dict, donor: dict, prefixes=("conditioner.embedders.",)) -> dict:
    out = dict(base)
    n = 0
    for k, v in donor.items():
        if any(k.startswith(p) for p in prefixes) and k in out:
            out[k] = v
            n += 1
    print(f"patched {n} text-encoder tensors")
    return out


# -- VAE → diffusers (vae-neurosis2ldm.py --diffusers) ---------------------------

#: diffusers AutoencoderKL config.json payloads (vae-neurosis2ldm.py:35-60)
VAE_HF_CONFIGS = {
    "sdxl": {
        "_class_name": "AutoencoderKL",
        "act_fn": "silu",
        "block_out_channels": [128, 256, 512, 512],
        "down_block_types": ["DownEncoderBlock2D"] * 4,
        "force_upcast": False,
        "in_channels": 3,
        "latent_channels": 4,
        "layers_per_block": 2,
        "norm_num_groups": 32,
        "out_channels": 3,
        "sample_size": 512,
        "scaling_factor": 0.13025,
        "up_block_types": ["UpDecoderBlock2D"] * 4,
    },
    "sd1.5": {
        "_class_name": "AutoencoderKL",
        "act_fn": "silu",
        "block_out_channels": [128, 256, 512, 512],
        "down_block_types": ["DownEncoderBlock2D"] * 4,
        "in_channels": 3,
        "latent_channels": 4,
        "layers_per_block": 2,
        "norm_num_groups": 32,
        "out_channels": 3,
        "sample_size": 512,
        "scaling_factor": 0.18215,
        "up_block_types": ["UpDecoderBlock2D"] * 4,
    },
}

_MID_ATTN = {
    "norm.weight": "group_norm.weight", "norm.bias": "group_norm.bias",
    "q.weight": "to_q.weight", "q.bias": "to_q.bias",
    "k.weight": "to_k.weight", "k.bias": "to_k.bias",
    "v.weight": "to_v.weight", "v.bias": "to_v.bias",
    "proj_out.weight": "to_out.0.weight", "proj_out.bias": "to_out.0.bias",
}


def _remap_mid(key: str, scope: str) -> str:
    """sgm ``mid.block_N``/``mid.attn_1`` → diffusers mid_block resnets/attentions."""
    key = key.replace(f"{scope}.mid.block_1.", f"{scope}.mid_block.resnets.0.")
    key = key.replace(f"{scope}.mid.block_2.", f"{scope}.mid_block.resnets.1.")
    a = f"{scope}.mid.attn_1."
    if key.startswith(a):
        rest = key[len(a):]
        key = f"{scope}.mid_block.attentions.0.{_MID_ATTN.get(rest, rest)}"
    return key


def sgm_vae_to_diffusers(state: dict, num_levels: int = 4) -> dict:
    """sgm/ldm VAE keys → diffusers AutoencoderKL keys: down and up resnet
    blocks (nin_shortcut → conv_shortcut, the up levels reversed), the mid
    blocks and their one-head attention (1x1-conv q, k, v, proj_out →
    linear weights), norm_out → conv_norm_out; the quant convs pass as
    they are."""
    out = {}
    for k, v in state.items():
        nk = k
        for scope in ("encoder", "decoder"):
            nk = _remap_mid(nk, scope)
        if nk.startswith("encoder.down."):
            parts = nk.split(".")
            i, kind = parts[2], parts[3]
            if kind == "block":
                rest = ".".join(parts[5:]).replace("nin_shortcut", "conv_shortcut")
                nk = f"encoder.down_blocks.{i}.resnets.{parts[4]}.{rest}"
            elif kind == "downsample":
                nk = f"encoder.down_blocks.{i}.downsamplers.0." + ".".join(parts[4:])
        elif nk.startswith("decoder.up."):  # diffusers reverses the level order
            parts = nk.split(".")
            ri, kind = num_levels - 1 - int(parts[2]), parts[3]
            if kind == "block":
                rest = ".".join(parts[5:]).replace("nin_shortcut", "conv_shortcut")
                nk = f"decoder.up_blocks.{ri}.resnets.{parts[4]}.{rest}"
            elif kind == "upsample":
                nk = f"decoder.up_blocks.{ri}.upsamplers.0." + ".".join(parts[4:])
        nk = nk.replace("encoder.norm_out.", "encoder.conv_norm_out.")
        nk = nk.replace("decoder.norm_out.", "decoder.conv_norm_out.")
        t = torch.as_tensor(v)
        if ".attentions.0.to_" in nk and t.ndim == 4:
            t = t.reshape(t.shape[0], t.shape[1])  # 1x1 conv → linear
        out[nk] = t
    return out


def export_vae_diffusers(state: dict, out_dir, config: str = "sdxl") -> None:
    """A diffusers AutoencoderKL model directory (save_pretrained's layout,
    written directly)."""
    from ..checkpoint.safetensors import save_file

    cfg = VAE_HF_CONFIGS[config]
    sd = sgm_vae_to_diffusers(state, num_levels=len(cfg["block_out_channels"]))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "config.json").write_text(json.dumps(cfg, indent=2, sort_keys=True))
    save_file(sd, out_dir / "diffusion_pytorch_model.safetensors")
    print(f"wrote diffusers VAE to {out_dir}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sd15-ldm2neurosis")
    p.add_argument("input", type=Path)
    p.add_argument("output", type=Path)

    p = sub.add_parser("extract-vae")
    p.add_argument("input", type=Path)
    p.add_argument("output", type=Path)

    p = sub.add_parser("patch-te")
    p.add_argument("base", type=Path)
    p.add_argument("donor", type=Path)
    p.add_argument("output", type=Path)

    p = sub.add_parser("vae2hf", help="VAE → HF-diffusers model dir (vae-neurosis2ldm.py -D)")
    p.add_argument("input", type=Path)
    p.add_argument("output", type=Path, help="output directory")
    p.add_argument("--model-config", "-C", default="sdxl", choices=sorted(VAE_HF_CONFIGS))
    p.add_argument("--extract", action="store_true", help="pull first_stage_model.* first")

    args = parser.parse_args(argv)

    from ..checkpoint.safetensors import save_file
    from ..checkpoint.sgm import load_state_dict

    if args.cmd == "sd15-ldm2neurosis":
        out = remap_sd15_ldm(load_state_dict(args.input))
    elif args.cmd == "extract-vae":
        out = extract_vae(load_state_dict(args.input))
    elif args.cmd == "patch-te":
        out = patch_te(load_state_dict(args.base), load_state_dict(args.donor))
    else:  # vae2hf
        state = load_state_dict(args.input)
        if args.extract:
            state = extract_vae(state)
        export_vae_diffusers(state, args.output, config=args.model_config)
        return 0

    args.output.parent.mkdir(parents=True, exist_ok=True)
    save_file(out, args.output)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
