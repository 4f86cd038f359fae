"""GeneralConditioner and the CLIP-L embedder (port of
neurosis_tpu/modules/encoders/embedding.py).

Tokenization happens on the host: text embedders read
``batch[f"{input_key}_ids"]`` (int [B, 77]). Outputs route by rank:
2 → 'vector', 3 → 'crossattn', 4/5 → 'concat' (NHWC channel axis).
Unconditional-guidance dropout (UCG) is ported at rate 0, the SD1.5
config's: an embedder with ``ucg_rate > 0`` raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..._device import DeviceLike
from ...models.text_encoder.clip import CLIPTextTower

OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
KEY2CATDIM = {"vector": 1, "crossattn": 2, "concat": -1}


class FrozenCLIPEmbedder(nn.Module):
    """HF CLIP-L text encoder embedder with ``layer: last``. Frozen unless
    ``is_trainable``: its parameters do not require grad."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 max_length: int = 77, layer: str = "last", vocab_size: int = 49408, width: int = 768,
                 layers: int = 12, heads: int = 12, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if layer != "last":
            raise NotImplementedError(f"layer={layer!r}: this port covers layer='last'")
        if ucg_rate > 0.0:
            raise NotImplementedError(f"ucg_rate={ucg_rate}: this port covers ucg_rate=0")
        self.input_key = input_key
        self.is_trainable = is_trainable
        self.transformer = CLIPTextTower(vocab_size, width, layers, heads, max_length, dtype, device, generator)
        self.requires_grad_(is_trainable)

    def token_key(self) -> str:
        return f"{self.input_key}_ids"

    def forward(self, input_ids: torch.Tensor) -> tuple:
        return (self.transformer(input_ids)["last_hidden_state"],)


class GeneralConditioner(nn.Module):
    """Routes embedder outputs into {'vector', 'crossattn', 'concat'}."""

    def __init__(self, embedders: Sequence[nn.Module]):
        super().__init__()
        self.embedders = nn.ModuleList(embedders)

    def forward(self, batch: dict, force_zero_embeddings: Sequence[str] = ()) -> dict:
        output: dict[str, torch.Tensor] = {}
        for embedder in self.embedders:
            for emb in embedder(batch[embedder.token_key()]):
                out_key = OUTPUT_DIM2KEYS[emb.ndim]
                if embedder.input_key in force_zero_embeddings:
                    emb = torch.zeros_like(emb)
                if out_key in output:
                    output[out_key] = torch.cat([output[out_key], emb], dim=KEY2CATDIM[out_key])
                else:
                    output[out_key] = emb
        return output
