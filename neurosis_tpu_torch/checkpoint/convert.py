"""JAX parameter trees → torch state dicts (port of
neurosis_tpu/checkpoint/torch_import.py and torch_export.py).

The JAX modules are named with the reference's torch dotted paths, so a
flax path ('input_blocks.1.0', 'in_layers.2', 'Conv_0', 'kernel') becomes
the key 'input_blocks.1.0.in_layers.2.weight': wrapper-internal auto names
are dropped, leaves renamed, and kernels transposed HWIO → OIHW (conv) or
(in, out) → (out, in) (dense). The same rules name the VAE
('encoder.down.0.block.1.conv1.weight', 'encoder.mid.attn_1.q.weight',
'quant_conv.weight'), LPIPS ('perceptual_loss.pnet.features.3.weight',
'perceptual_loss.lin0.model.1.weight') and the discriminator
('discr.layers.2.weight'); a ``batch_stats`` tree gives the BatchNorm
buffers ('discr.layers.3.running_mean', '...running_var').
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_SKIP_COMPONENTS = re.compile(r"^(Conv|Dense|GroupNorm|LayerNorm|Embed)_\d+$")
_LEAF_MAP = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
_EMBEDDER = re.compile(r"^embedders_(\d+)$")


def flax_path_to_torch_key(path: tuple, prefix: str = "") -> str:
    *mods, leaf = [str(p) for p in path]
    # flax renames the conditioner's sequence-field children 'embedders_N';
    # the reference key is 'embedders.N' (as checkpoint/sgm.py translates)
    mods = [_EMBEDDER.sub(r"embedders.\1", c) for c in mods if not _SKIP_COMPONENTS.match(c)]
    return prefix + ".".join(mods + [_LEAF_MAP.get(leaf, leaf)])


def _to_torch_layout(leaf_name: str, w: np.ndarray) -> np.ndarray:
    if leaf_name == "kernel":
        if w.ndim == 4:  # HWIO -> OIHW
            return np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        if w.ndim == 2:  # (in, out) -> (out, in)
            return np.ascontiguousarray(w.T)
        if w.ndim == 3:  # WIO -> OIW
            return np.ascontiguousarray(w.transpose(2, 1, 0))
    return w


def _flatten(tree: Mapping, path: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, path + (str(key),))
        else:
            yield path + (str(key),), val


def jax_params_to_state_dict(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested mapping of numpy arrays (a flax ``params`` tree) → state dict
    of float32 CPU tensors, for ``module.load_state_dict(..., strict=True)``."""
    out = {}
    for path, leaf in _flatten(tree):
        w = _to_torch_layout(path[-1], np.array(leaf, dtype=np.float32))
        out[flax_path_to_torch_key(path, prefix)] = torch.from_numpy(np.ascontiguousarray(w))
    return out
