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
buffers ('discr.layers.3.running_mean', '...running_var'). SDXL's modules
follow from the same rules: the UNet's label embedding
('label_emb.0.0.weight'), the open_clip text tower
('model.transformer.resblocks.0.attn.q_proj.weight', 'model.ln_final.bias')
and its bare parameters, which keep their names and layouts
('model.positional_embedding', 'model.text_projection' as [width, proj]).
T5 names its modules with HF's dotted paths, so the same rules give
'transformer.encoder.block.0.layer.0.SelfAttention.q.weight',
'...relative_attention_bias.weight' and 'transformer.shared.weight' (under
CLIP-T5's 'clip_encoder.'/'t5_encoder.'), and a ClassEmbedder's table
'embedding.weight'. The vision towers' leaves follow too: the patch convs
('model.visual.conv1.weight', 'dreamsim.dino.patch_embed.proj.weight', OIHW),
the bare tokens and embeddings, which keep their names and layouts
('model.visual.class_embedding', '...positional_embedding', 'cls_token',
'pos_embed', 'register_tokens', and 'model.visual.proj' as [width, out],
used as ``x @ proj``), DINOv2's LayerScales ('blocks.0.ls1.gamma') and its
SwiGLU ('blocks.0.mlp.w12.weight', '...mlp.w3.weight').
Two leaves are named by their place: a codebook (a bare ``embedding`` leaf
at the root of the tree, or of a ``regularizer`` or ``quantizer``, where
flax's ``nn.Embed`` always sits inside a named module) becomes
'embedding.weight', as the reference's VectorQuantizer holds it, and an
ActNorm's ``scale`` (beside its ``loc``) keeps its name.
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


_CODEBOOK_OWNERS = ("regularizer", "quantizer")


def flax_path_to_torch_key(path: tuple, prefix: str = "", siblings=()) -> str:
    """The torch key of the leaf at ``path``; ``siblings`` are the names
    beside it in its module."""
    *mods, leaf = [str(p) for p in path]
    # flax renames the conditioner's sequence-field children 'embedders_N';
    # the reference key is 'embedders.N' (as checkpoint/sgm.py translates)
    mods = [_EMBEDDER.sub(r"embedders.\1", c) for c in mods if not _SKIP_COMPONENTS.match(c)]
    if leaf == "embedding" and (not mods or mods[-1] in _CODEBOOK_OWNERS):
        name = "embedding.weight"
    elif leaf == "scale" and "loc" in siblings:
        name = "scale"
    else:
        name = _LEAF_MAP.get(leaf, leaf)
    return prefix + ".".join(mods + [name])


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
    """(path, leaf, the names beside it) of every leaf."""
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, path + (str(key),))
        else:
            yield path + (str(key),), val, tuple(str(k) for k in tree)


def jax_params_to_state_dict(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested mapping of numpy arrays (a flax ``params`` tree) → state dict
    of float32 CPU tensors, for ``module.load_state_dict(..., strict=True)``."""
    out = {}
    for path, leaf, siblings in _flatten(tree):
        w = _to_torch_layout(path[-1], np.array(leaf, dtype=np.float32))
        out[flax_path_to_torch_key(path, prefix, siblings)] = torch.from_numpy(np.ascontiguousarray(w))
    return out
