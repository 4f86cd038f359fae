"""GeneralConditioner and its embedders (port of
neurosis_tpu/modules/encoders/embedding.py).

Tokenization happens on the host: text embedders read
``batch[f"{input_key}_ids"]`` (int [B, 77]); numeric embedders read
``batch[input_key]``. Outputs route by rank: 2 → 'vector', 3 → 'crossattn',
4/5 → 'concat' (NHWC channel axis), concatenated in embedder order (SDXL:
CLIP-L 768 ⊕ bigG 1280 → 2048 on 'crossattn'; pooled 1280 ⊕ 3×512 → 2816 on
'vector'). Unconditional-guidance dropout (UCG) is ported at rate 0, the
configs': an embedder with ``ucg_rate > 0`` raises. Extended prompt chunks
(ids [B, chunks, 77]) are not ported and raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..._device import DeviceLike
from ...models.text_encoder.clip import CLIPTextTower, OpenCLIPTextTower
from ..layers import timestep_embedding

OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
KEY2CATDIM = {"vector": 1, "crossattn": 2, "concat": -1}


class AbstractEmbModel(nn.Module):
    """Base embedder: names the batch entry it reads and emits a tuple of
    conditioning tensors. Frozen unless ``is_trainable``: its parameters do
    not require grad."""

    def __init__(self, input_key: str, ucg_rate: float = 0.0, is_trainable: bool = False):
        super().__init__()
        if ucg_rate > 0.0:
            raise NotImplementedError(f"ucg_rate={ucg_rate}: this port covers ucg_rate=0")
        self.input_key = input_key
        self.is_trainable = is_trainable

    def token_key(self) -> Optional[str]:
        """Batch key of this embedder's tokenized input (None: it reads
        ``batch[input_key]``, a numeric tensor)."""
        return None


class _TextEmbedder(AbstractEmbModel):
    def token_key(self) -> str:
        return f"{self.input_key}_ids"

    @staticmethod
    def _check_ids(input_ids: torch.Tensor) -> None:
        if input_ids.ndim != 2:
            raise NotImplementedError(f"token ids must be [B, T], got {tuple(input_ids.shape)}: "
                                      "extended prompts are not ported")


class FrozenCLIPEmbedder(_TextEmbedder):
    """HF CLIP-L text encoder embedder. ``layer``: 'last' | 'pooled' |
    'hidden' | 'penultimate'; hidden and penultimate select
    ``hidden_states[idx + 1]`` (0 = embeddings), idx = ``layer_idx``
    (negative counts from the end) or 10 for penultimate."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 max_length: int = 77, layer: str = "last", layer_idx: Optional[int] = None,
                 vocab_size: int = 49408, width: int = 768, layers: int = 12, heads: int = 12,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable)
        if layer not in ("last", "pooled", "hidden", "penultimate"):
            raise ValueError(f"unknown layer {layer!r}")
        if layer == "hidden" and layer_idx is None:
            raise ValueError("layer_idx must be specified for hidden layer")
        self.layer = layer
        if layer == "penultimate":
            self.hidden_idx = 10
        elif layer == "hidden":
            self.hidden_idx = layer_idx + layers if layer_idx < 0 else layer_idx
        self.transformer = CLIPTextTower(vocab_size, width, layers, heads, max_length, dtype, device, generator)
        self.requires_grad_(is_trainable)

    def forward(self, input_ids: torch.Tensor) -> tuple:
        self._check_ids(input_ids)
        out = self.transformer(input_ids)
        if self.layer == "last":
            z = out["last_hidden_state"]
        elif self.layer == "pooled":
            z = out["pooler_output"][:, None, :]
        else:
            z = out["hidden_states"][self.hidden_idx + 1]
        return (z,)


class FrozenOpenCLIPEmbedder2(_TextEmbedder):
    """OpenCLIP bigG text embedder. ``layer``: 'last' | 'penultimate' (the
    resblock outputs before ln_final); pooled = ln_final(last) at the EOS
    token times text_projection. ``legacy`` returns ln_final's output for
    'last' (and the penultimate as it is) and never the pooled vector."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 max_length: int = 77, layer: str = "penultimate", always_return_pooled: bool = False,
                 legacy: bool = False, vocab_size: int = 49408, width: int = 1280, layers: int = 32,
                 heads: int = 20, dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable)
        if layer not in ("last", "penultimate"):
            raise ValueError(f"unknown layer {layer!r}")
        self.layer = layer
        self.always_return_pooled = always_return_pooled
        self.legacy = legacy
        self.model = OpenCLIPTextTower(vocab_size, width, layers, heads, max_length, dtype=dtype, device=device,
                                       generator=generator)
        self.requires_grad_(is_trainable)

    def forward(self, input_ids: torch.Tensor) -> tuple:
        self._check_ids(input_ids)
        out = self.model(input_ids)
        if self.legacy:
            return (out["last_ln"] if self.layer == "last" else out["penultimate"],)
        z = out["last"] if self.layer == "last" else out["penultimate"]
        if self.always_return_pooled:
            return (z, out["pooled"])
        return (z,)


class ConcatTimestepEmbedderND(AbstractEmbModel):
    """Each scalar of a [B, n] tensor (SDXL's sizes and crop offsets) →
    ``outdim`` Fourier features, concatenated → [B, n·outdim] 'vector'."""

    def __init__(self, outdim: int = 256, input_key: str = "caption", ucg_rate: float = 0.0,
                 is_trainable: bool = False):
        super().__init__(input_key, ucg_rate, is_trainable)
        self.outdim = outdim

    def forward(self, x: torch.Tensor) -> tuple:
        if x.ndim == 1:
            x = x[:, None]
        b, dims = x.shape
        emb = timestep_embedding(x.reshape(b * dims), self.outdim)
        return (emb.reshape(b, dims * self.outdim),)


class GeneralConditioner(nn.Module):
    """Routes embedder outputs into {'vector', 'crossattn', 'concat'}."""

    def __init__(self, embedders: Sequence[AbstractEmbModel]):
        super().__init__()
        self.embedders = nn.ModuleList(embedders)

    def forward(self, batch: dict, force_zero_embeddings: Sequence[str] = ()) -> dict:
        output: dict[str, torch.Tensor] = {}
        for embedder in self.embedders:
            tkey = embedder.token_key()
            inputs = batch[embedder.input_key if tkey is None else tkey]
            for emb in embedder(inputs):
                out_key = OUTPUT_DIM2KEYS[emb.ndim]
                if embedder.input_key in force_zero_embeddings:
                    emb = torch.zeros_like(emb)
                if out_key in output:
                    output[out_key] = torch.cat([output[out_key], emb], dim=KEY2CATDIM[out_key])
                else:
                    output[out_key] = emb
        return output
