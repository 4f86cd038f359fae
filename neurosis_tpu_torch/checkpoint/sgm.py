"""Reference-layout (sgm) checkpoints: load and export (port of
neurosis_tpu/checkpoint/sgm.py; parity: models/diffusion.py:127-144
init_from_ckpt).

  model.diffusion_model.*    ↔ the UNet
  conditioner.embedders.N.*  ↔ the conditioner's towers (open_clip's fused
                               qkv split by ``split_openclip_qkv``)
  first_stage_model.*        ↔ the frozen AutoencoderKL
  model_ema.*                ↔ the EMA shadows of the UNet, under LitEma's
                               '.'-free names, with ``decay`` and ``num_updates``

Loading is non-strict: missing and unexpected keys are logged and returned,
never raised. ``.safetensors`` goes through the port's own reader;
``.ckpt``, ``.pt`` and ``.pth`` through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..models.text_encoder.clip import split_openclip_qkv
from ..parallel.fsdp import assign
from .safetensors import load_file, save_file

logger = logging.getLogger(__name__)

CHECKPOINT_EXTNS = (".safetensors", ".ckpt", ".pt", ".pth")
_EMA_BUFFERS = ("model_ema.decay", "model_ema.num_updates")
_KNOWN = ("model.diffusion_model.", "conditioner.", "first_stage_model.", "model_ema.")


def load_state_dict(path) -> dict:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    if path.suffix == ".safetensors":
        return load_file(path)
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _ema_mangled_name(dotted: str) -> str:
    """LitEma's buffer name: the '.'-free parameter name under ``model_ema.``
    (modules/ema.py:24-29, over ``self.model``'s names, which carry the
    ``diffusion_model.`` prefix)."""
    return "model_ema." + dotted.replace(".", "_")


@torch.no_grad()
def _fill(targets: dict, sd: dict, prefix: str) -> tuple[list, list]:
    """Copy ``sd[prefix + name]`` into each target tensor; (missing, unexpected)."""
    missing = []
    used = set()
    for name, tensor in targets.items():
        key = prefix + name
        if key not in sd:
            missing.append(key)
            continue
        value = sd[key]
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, module shape {tuple(tensor.shape)}")
        assign(tensor, value.to(tensor.dtype))
        used.add(key)
    return missing, [k for k in sd if k.startswith(prefix) and k not in used]


def load_sgm_checkpoint(engine, state, path, with_report: bool = False):
    """Fill the engine's modules (and ``state.ema``) from a reference-layout
    checkpoint, in place. Returns the state, or (state, report) with
    ``with_report``: {'missing', 'unexpected', 'per_component'}."""
    sd = split_openclip_qkv(load_state_dict(path))
    missing, unexpected, report = [], [], {}

    def component(name, module, prefix):
        m, u = _fill(module.state_dict(keep_vars=True), sd, prefix)
        missing.extend(m)
        unexpected.extend(u)
        report[name] = (len(m), len(u))

    component("unet", engine.model, "model.diffusion_model.")
    component("conditioner", engine.conditioner, "conditioner.")
    if engine.first_stage is not None:
        component("first_stage", engine.first_stage, "first_stage_model.")
    else:
        unexpected += [k for k in sd if k.startswith("first_stage_model.")]

    has_ema = any(k.startswith("model_ema.") for k in sd)
    if state.ema is not None and has_ema:
        shadows = {_ema_mangled_name("diffusion_model." + n): s
                   for (n, _), s in zip(engine.model.named_parameters(), state.ema.params)}
        m_ema, u_ema = _fill(shadows, sd, "")
        u_ema = [k for k in u_ema if k.startswith("model_ema.") and k not in _EMA_BUFFERS]
        if "model_ema.num_updates" in sd:
            state.ema.num_updates = int(np.asarray(sd["model_ema.num_updates"]))
        missing += m_ema
        unexpected += u_ema
        report["model_ema"] = (len(m_ema), len(u_ema))
    else:
        unexpected += [k for k in sd if k.startswith("model_ema.") and k not in _EMA_BUFFERS]
    unexpected += [k for k in sd if not k.startswith(_KNOWN)]

    for name, (n_missing, n_unexpected) in report.items():
        if n_missing or n_unexpected:
            logger.warning(f"checkpoint import: {name} missing {n_missing} / unexpected {n_unexpected} keys")
        else:
            logger.info(f"checkpoint import: {name} fully loaded")
    if with_report:
        return state, {"missing": missing, "unexpected": unexpected, "per_component": report}
    return state


def export_sgm_checkpoint(engine, state, path) -> None:
    """Write the reference layout as .safetensors (fp32 parameters)."""
    sd = {}
    for prefix, module in (("model.diffusion_model.", engine.model), ("conditioner.", engine.conditioner),
                           ("first_stage_model.", engine.first_stage)):
        if module is not None:
            sd.update({prefix + k: v.float() for k, v in module.state_dict().items()})
    if state.ema is not None:
        for (name, _), shadow in zip(engine.model.named_parameters(), state.ema.params):
            sd[_ema_mangled_name("diffusion_model." + name)] = shadow
        sd["model_ema.decay"] = np.asarray(engine.ema_decay, np.float32)
        sd["model_ema.num_updates"] = np.asarray(state.ema.num_updates, np.int32)
    save_file(sd, path)
