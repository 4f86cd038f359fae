"""FrozenCLIPT5Encoder: CLIP-L and a T5 encoder on one prompt (port of
neurosis_tpu/modules/encoders/clip_t5.py).

The prompt comes tokenized twice, by CLIP's tokenizer (``<key>_ids``) and
by T5's (``<key>_t5_ids``, ``token_keys()``); the embedder returns (clip_z,
t5_z), two 'crossattn' outputs that the conditioner concatenates on the
feature axis. Its submodules are ``clip_encoder`` and ``t5_encoder``, as
JAX's, so the reference checkpoints' keys load one to one.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..._device import DeviceLike
from ...models.text_encoder.t5 import FrozenT5Embedder
from .embedding import AbstractEmbModel, FrozenCLIPEmbedder


class FrozenCLIPT5Encoder(AbstractEmbModel):
    """Two crossattn outputs: CLIP-L's last hidden state and the T5
    encoder's. ``clip_version`` and ``t5_version`` (the reference's HF names)
    are taken and unused, as JAX's fields are; the widths say the
    architectures (CLIP-L, T5 v1.1-XL by default)."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 base_lr: Optional[float] = None, emb_name: Optional[str] = None,
                 clip_version: str = "openai/clip-vit-large-patch14", t5_version: str = "google/t5-v1_1-xl",
                 clip_max_length: int = 77, t5_max_length: int = 77, clip_width: int = 768, clip_layers: int = 12,
                 clip_heads: int = 12, clip_vocab_size: int = 49408, t5_d_model: int = 2048, t5_d_kv: int = 64,
                 t5_d_ff: int = 5120, t5_num_layers: int = 24, t5_num_heads: int = 32, t5_vocab_size: int = 32128,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        self.clip_version, self.t5_version = clip_version, t5_version
        self.clip_encoder = FrozenCLIPEmbedder(input_key, layer="last", max_length=clip_max_length,
                                               vocab_size=clip_vocab_size, width=clip_width, layers=clip_layers,
                                               heads=clip_heads, version=clip_version, dtype=dtype, device=device,
                                               generator=generator, is_trainable=is_trainable)
        self.t5_encoder = FrozenT5Embedder(input_key, is_trainable=is_trainable, version=t5_version,
                                           max_length=t5_max_length, vocab_size=t5_vocab_size, d_model=t5_d_model,
                                           d_kv=t5_d_kv, d_ff=t5_d_ff, num_layers=t5_num_layers,
                                           num_heads=t5_num_heads, dtype=dtype, device=device, generator=generator)

    def token_key(self) -> Optional[str]:
        return None  # two streams: token_keys()

    def token_keys(self) -> list:
        return [f"{self.input_key}_ids", f"{self.input_key}_t5_ids"]

    def forward(self, inputs: tuple) -> tuple:
        clip_ids, t5_ids = inputs
        return (self.clip_encoder(clip_ids)[0], self.t5_encoder(t5_ids)[0])
