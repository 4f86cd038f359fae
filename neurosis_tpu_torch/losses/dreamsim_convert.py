"""DreamSim checkpoint converters: the LoRA merge and the CLIP key remap
(port of neurosis_tpu/losses/dreamsim_convert.py; parity:
modules/losses/dreamsim/utils.py:22-162).

The published DreamSim checkpoints are ViT bases plus qkv-only LoRA adapters
saved by an old PEFT; the converters merge them offline. They are numpy
state-dict transforms on local files: safetensors through the port's own
reader (``checkpoint/safetensors.py``), ``.pt`` through ``torch.load``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike
from ..models.dinov2 import load_matching, load_state

logger = logging.getLogger(__name__)

#: the double-PEFT prefix on the shipped LoRA keys (utils.py:76)
LORA_PREFIX = "base_model.model.base_model.model.model."
#: DreamSim trains q and v only (utils.py:88-90)
QKV_SWITCHES = (True, False, True)
LORA_SCALE = 0.5 / 16


def calculate_merged_weight(lora_a: np.ndarray, lora_b: np.ndarray, base: np.ndarray, scale: float = LORA_SCALE,
                            qkv_switches: Sequence[bool] = QKV_SWITCHES) -> np.ndarray:
    """Merge a grouped qkv LoRA delta into the fused base weight
    (utils.py:22-50): lora_b @ lora_a per active group, scattered into the
    q/k/v row blocks that ``qkv_switches`` selects."""
    n_switches = len(qkv_switches)
    n_groups = int(np.sum(qkv_switches))
    qkv_mask = np.broadcast_to(np.asarray(qkv_switches, bool).reshape(n_switches, 1),
                               (n_switches, base.shape[0] // n_switches)).reshape(-1)
    lora_b = np.squeeze(np.asarray(lora_b))
    lora_a = np.asarray(lora_a)
    delta_w = np.zeros((lora_b.shape[0], base.shape[1]), base.dtype)
    grp_in = lora_a.shape[0] // n_groups
    grp_out = lora_b.shape[0] // n_groups
    for i in range(n_groups):
        delta_w[i * grp_out:(i + 1) * grp_out, :] = \
            lora_b[i * grp_out:(i + 1) * grp_out, :] @ lora_a[i * grp_in:(i + 1) * grp_in, :]
    delta_full = np.zeros_like(base)
    delta_full[qkv_mask, :] = delta_w
    return (base + scale * delta_full).astype(base.dtype)


def merge_dreamsim_lora(base_state: dict, lora_state_or_path) -> dict:
    """Merge the LoRA adapters into every ``attn.qkv.weight`` of
    ``base_state`` (utils.py:53-96); takes a loaded state dict or a
    .safetensors/.pt path."""
    lora_sd = load_state(Path(lora_state_or_path)) if isinstance(lora_state_or_path, (str, Path)) \
        else dict(lora_state_or_path)
    group_weights = {k[len(LORA_PREFIX):]: np.asarray(v) for k, v in lora_sd.items() if k.startswith(LORA_PREFIX)}
    group_layers = {k.rsplit(".", 2)[0] for k in group_weights}
    out = dict(base_state)
    for key in [k for k in out if "attn.qkv.weight" in k]:
        param_name = key.rsplit(".", 1)[0]
        if param_name not in group_layers:
            logger.warning(f"QKV param '{param_name}' not found in lora weights")
            continue
        out[key] = calculate_merged_weight(group_weights[f"{param_name}.lora_A.weight"],
                                           group_weights[f"{param_name}.lora_B.weight"], np.asarray(out[key]))
    return out


def remap_clip(state_dict: dict, variant: str) -> dict:
    """Original-DreamSim key remap (utils.py:99-118): drop the patch bias
    CLIP never had, pos_drop → norm_pre, a zero head bias where there is
    none; the single variants gain the 'extractor.' prefix."""
    sd = dict(state_dict)
    if "clip" in variant:
        sd.pop("patch_embed.proj.bias", None)
        if "pos_drop.weight" in sd:
            sd["norm_pre.weight"] = sd.pop("pos_drop.weight")
            sd["norm_pre.bias"] = sd.pop("pos_drop.bias")
        if "head.weight" in sd and "head.bias" not in sd:
            sd["head.bias"] = np.zeros(np.asarray(sd["head.weight"]).shape[0], np.float32)
    if variant.endswith("single"):
        sd = {f"extractor.{k}": v for k, v in sd.items()}
    return sd


_VARIANTS = {
    # variant → (layer_norm_eps, pre_norm, act_layer)
    "open_clip_vitb16": (1e-5, True, "gelu"),
    "open_clip_vitb32": (1e-5, True, "gelu"),
    "clip_vitb16": (1e-5, True, "quick_gelu"),
    "clip_vitb32": (1e-5, True, "quick_gelu"),
    "dino_vitb16": (1e-6, False, "gelu"),
}


def convert_dreamsim_single(ckpt_path, variant: str, ensemble: bool = False, dtype: Optional[torch.dtype] = None,
                            device: DeviceLike = None,
                            generator: Optional[torch.Generator] = None) -> Tuple[torch.nn.Module, Optional[dict]]:
    """A DreamsimModel for ``variant`` with its merged checkpoint loaded
    (utils.py:120-162): ``ckpt_path`` is the file, or a directory holding
    ``<ensemble|variant>/<variant>_merged.safetensors``. Returns (module, the
    state dict loaded, or None when there is no file: the default init, with
    a warning)."""
    from .dreamsim import DreamsimModel, split_vit_qkv

    if variant not in _VARIANTS:
        raise NotImplementedError(f"Unsupported model variant '{variant}'")
    eps, pre_norm, act = _VARIANTS[variant]
    model = DreamsimModel(pre_norm=pre_norm, act_layer=act, layer_norm_eps=eps, dtype=dtype, device=device,
                          generator=generator)
    path = Path(ckpt_path)
    if path.exists() and path.is_dir():
        path = path / ("ensemble" if ensemble else variant) / f"{variant}_merged.safetensors"
    if not path.exists():
        logger.warning(f"no DreamSim checkpoint at {path}; returning default init")
        return model, None
    sd = split_vit_qkv(remap_clip(load_state(path), variant + "_single"))
    return model, load_matching(model, sd, "dreamsim")
