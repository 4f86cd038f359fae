"""GeneralConditioner and its embedders (port of
neurosis_tpu/modules/encoders/embedding.py).

Tokenization happens on the host: text embedders read
``batch[f"{input_key}_ids"]`` (int [B, 77], or [B, chunks, 77] for extended
prompts: the chunks run through the tower as one batch, their outputs are
concatenated on the sequence axis and the pooled vector is chunk 0's);
numeric embedders read ``batch[input_key]``. Outputs route by rank: 2 →
'vector', 3 → 'crossattn', 4/5 → 'concat' (NHWC channel axis), concatenated
in embedder order (SDXL: CLIP-L 768 ⊕ bigG 1280 → 2048 on 'crossattn';
pooled 1280 ⊕ 3×512 → 2816 on 'vector').

An embedder with several token streams (``token_keys()``: CLIP-T5's
``<key>_ids`` and ``<key>_t5_ids``) gets a tuple of them.

Unconditional-guidance dropout (UCG, ``ucg_rate``) as the JAX package does it
(embedding.py:218-295): a text embedder swaps the whole batch to
``batch["uncond_ids"]`` with probability ucg_rate (one draw an embedder; a
multi-stream embedder swaps all its streams on that one draw, each to its
own uncond row, ``<key>_t5_ids`` → ``uncond_t5_ids`` falling back to
``uncond_ids``); a numeric embedder zeroes each sample's output with that
probability (one Bernoulli mask an output). The draws come from the generator a caller passes
(training); without one, as in sampling and evaluation, no UCG applies (the
reference's ``zero_ucg``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..._device import DeviceLike
from ...parallel import rows
from ...models.text_encoder.clip import CLIPTextTower, OpenCLIPTextTower
from ..layers import timestep_embedding

OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
KEY2CATDIM = {"vector": 1, "crossattn": 2, "concat": -1}


class AbstractEmbModel(nn.Module):
    """Base embedder: names the batch entry it reads and emits a tuple of
    conditioning tensors. Frozen unless ``is_trainable``: its parameters do
    not require grad. ``base_lr`` (the builder's per-embedder learning rate)
    and ``emb_name`` are kept, as in JAX."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 base_lr: Optional[float] = None, emb_name: Optional[str] = None):
        super().__init__()
        self.input_key = input_key
        self.ucg_rate = ucg_rate
        self.is_trainable = is_trainable
        self.base_lr = base_lr
        self.emb_name = emb_name

    def token_key(self) -> Optional[str]:
        """Batch key of this embedder's tokenized input (None: it reads
        ``batch[input_key]``, a numeric tensor)."""
        return None

    def token_keys(self) -> Optional[list]:
        """The batch keys of several token streams (None: one or none)."""
        return None


class _TextEmbedder(AbstractEmbModel):
    def token_key(self) -> str:
        return f"{self.input_key}_ids"

    @staticmethod
    def _flat(input_ids: torch.Tensor) -> tuple[torch.Tensor, int]:
        """[B, T] ids as they are, or [B, chunks, T] as [B·chunks, T]; and the chunk count."""
        if input_ids.ndim == 3:
            return input_ids.reshape(-1, input_ids.shape[-1]), input_ids.shape[1]
        if input_ids.ndim != 2:
            raise ValueError(f"token ids must be [B, T] or [B, chunks, T], got {tuple(input_ids.shape)}")
        return input_ids, 0

    @staticmethod
    def _unchunk(z: torch.Tensor, pooled: torch.Tensor, chunks: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The chunks' outputs side by side on the sequence axis; chunk 0's pooled vector."""
        if not chunks:
            return z, pooled
        b = z.shape[0] // chunks
        return z.reshape(b, chunks * z.shape[1], z.shape[-1]), pooled.reshape(b, chunks, -1)[:, 0]


class FrozenCLIPEmbedder(_TextEmbedder):
    """HF CLIP-L text encoder embedder. ``layer``: 'last' | 'pooled' |
    'hidden' | 'penultimate'; hidden and penultimate select
    ``hidden_states[idx + 1]`` (0 = embeddings), idx = ``layer_idx``
    (negative counts from the end) or 10 for penultimate. ``version`` (the
    reference's HF model name) is taken and unused, as the JAX field is.
    ``always_return_pooled`` adds the pooled vector as a second output;
    ``extended_chunks`` > 1 has the trainer tokenize prompts in that many
    chunks."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 max_length: int = 77, layer: str = "last", layer_idx: Optional[int] = None,
                 vocab_size: int = 49408, width: int = 768, layers: int = 12, heads: int = 12,
                 version: Optional[str] = None, dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, always_return_pooled: bool = False,
                 extended_chunks: int = 0, base_lr: Optional[float] = None, emb_name: Optional[str] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        self.always_return_pooled = always_return_pooled
        self.extended_chunks = extended_chunks
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
        flat, chunks = self._flat(input_ids)
        out = self.transformer(flat)
        if self.layer == "last":
            z = out["last_hidden_state"]
        elif self.layer == "pooled":
            z = out["pooler_output"][:, None, :]
        else:
            z = out["hidden_states"][self.hidden_idx + 1]
        z, pooled = self._unchunk(z, out["pooler_output"], chunks)
        return (z, pooled) if self.always_return_pooled else (z,)


class FrozenOpenCLIPEmbedder2(_TextEmbedder):
    """OpenCLIP bigG text embedder. ``layer``: 'last' | 'penultimate' (the
    resblock outputs before ln_final); pooled = ln_final(last) at the EOS
    token times text_projection. ``legacy`` returns ln_final's output for
    'last' (and the penultimate as it is) and never the pooled vector.
    ``arch`` and ``version`` (the reference's open_clip names) are taken and
    unused, as the JAX fields are; the widths say the architecture.
    ``extended_chunks`` as ``FrozenCLIPEmbedder``'s."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 max_length: int = 77, layer: str = "penultimate", always_return_pooled: bool = False,
                 legacy: bool = False, vocab_size: int = 49408, width: int = 1280, layers: int = 32,
                 heads: int = 20, arch: str = "ViT-bigG-14", version: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, extended_chunks: int = 0,
                 base_lr: Optional[float] = None, emb_name: Optional[str] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        self.extended_chunks = extended_chunks
        if layer not in ("last", "penultimate"):
            raise ValueError(f"unknown layer {layer!r}")
        self.layer = layer
        self.always_return_pooled = always_return_pooled
        self.legacy = legacy
        self.model = OpenCLIPTextTower(vocab_size, width, layers, heads, max_length, dtype=dtype, device=device,
                                       generator=generator)
        self.requires_grad_(is_trainable)

    def forward(self, input_ids: torch.Tensor) -> tuple:
        flat, chunks = self._flat(input_ids)
        out = self.model(flat)
        if self.legacy:  # the JAX package returns the legacy output unchunked too
            return (out["last_ln"] if self.layer == "last" else out["penultimate"],)
        z = out["last"] if self.layer == "last" else out["penultimate"]
        z, pooled = self._unchunk(z, out["pooled"], chunks)
        return (z, pooled) if self.always_return_pooled else (z,)


class ConcatTimestepEmbedderND(AbstractEmbModel):
    """Each scalar of a [B, n] tensor (SDXL's sizes and crop offsets) →
    ``outdim`` Fourier features, concatenated → [B, n·outdim] 'vector'."""

    def __init__(self, outdim: int = 256, input_key: str = "caption", ucg_rate: float = 0.0,
                 is_trainable: bool = False, base_lr: Optional[float] = None, emb_name: Optional[str] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        self.outdim = outdim

    def forward(self, x: torch.Tensor) -> tuple:
        if x.ndim == 1:
            x = x[:, None]
        b, dims = x.shape
        emb = timestep_embedding(x.reshape(b * dims), self.outdim)
        return (emb.reshape(b, dims * self.outdim),)


class IdentityEncoder(AbstractEmbModel):
    """Pass-through: ``batch[input_key]`` as it is."""

    def forward(self, x: torch.Tensor) -> tuple:
        return (x,)


def _uncond_key(token_key: str, input_key: str) -> str:
    """'caption_t5_ids' → 'uncond_t5_ids' (the caller falls back to 'uncond_ids')."""
    suffix = token_key[len(input_key):] if token_key.startswith(input_key) else "_ids"
    return f"uncond{suffix}"


class GeneralConditioner(nn.Module):
    """Routes embedder outputs into {'vector', 'crossattn', 'concat'}."""

    def __init__(self, embedders: Sequence[AbstractEmbModel]):
        super().__init__()
        self.embedders = nn.ModuleList(embedders)

    def forward(self, batch: dict, force_zero_embeddings: Sequence[str] = (),
                generator: Optional[torch.Generator] = None, ucg: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """The conditioning of ``batch``. UCG draws come from ``generator``, or
        in order from ``ucg`` (a 0-d bool swap per text embedder, a [B] bool
        keep mask per numeric output, JAX's order); with neither, no UCG."""
        draws = iter(ucg) if ucg is not None else None
        active = generator is not None or draws is not None
        output: dict[str, torch.Tensor] = {}
        for embedder in self.embedders:
            tkey = embedder.token_key()
            tkeys = embedder.token_keys()
            rate = embedder.ucg_rate if active else 0.0
            if tkeys is not None:
                inputs = tuple(batch[k] for k in tkeys)
                if rate > 0.0:
                    swap = next(draws) if draws is not None else \
                        torch.rand((), generator=generator, device=inputs[0].device) < rate
                    inputs = tuple(torch.where(swap.to(x.device), batch.get(_uncond_key(k, embedder.input_key),
                                                                          batch["uncond_ids"]).expand(x.shape), x)
                                   for k, x in zip(tkeys, inputs))
                tkey = tkeys[0]  # the token streams' UCG is done: no per-sample zeroing
            elif tkey is not None:
                inputs = batch[tkey]
                if rate > 0.0:
                    swap = next(draws) if draws is not None else \
                        torch.rand((), generator=generator, device=inputs.device) < rate
                    inputs = torch.where(swap.to(inputs.device), batch["uncond_ids"].expand(inputs.shape), inputs)
            else:
                inputs = batch[embedder.input_key]
            for emb in embedder(inputs):
                out_key = OUTPUT_DIM2KEYS[emb.ndim]
                if embedder.input_key in force_zero_embeddings:
                    emb = torch.zeros_like(emb)
                elif rate > 0.0 and tkey is None:
                    keep = next(draws) if draws is not None else \
                        rows.draw(torch.rand, (emb.shape[0],), generator=generator, device=emb.device) < 1.0 - rate
                    emb = emb * keep.to(emb.device).reshape((-1,) + (1,) * (emb.ndim - 1)).to(emb.dtype)
                if out_key in output:
                    output[out_key] = torch.cat([output[out_key], emb], dim=KEY2CATDIM[out_key])
                else:
                    output[out_key] = emb
        return output

    def get_unconditional_conditioning(self, batch_c: dict, batch_uc: Optional[dict] = None,
                                       force_uc_zero_embeddings: Sequence[str] = (),
                                       force_cond_zero_embeddings: Sequence[str] = ()) -> tuple[dict, dict]:
        """(cond, uncond) for CFG sampling (embedding.py:165-183), without UCG.
        Without ``batch_uc`` the uncond batch is ``batch_c`` with each token
        stream replaced by its uncond row (``uncond_t5_ids`` for
        ``<key>_t5_ids``, else ``uncond_ids``) broadcast to the batch; numeric
        inputs keep their values."""
        c = self(batch_c, force_zero_embeddings=force_cond_zero_embeddings)
        if batch_uc is None:
            batch_uc = dict(batch_c)
            for embedder in self.embedders:
                tkeys = embedder.token_keys() or ([embedder.token_key()] if embedder.token_key() else [])
                for tkey in tkeys:
                    if tkey in batch_uc:
                        unc = batch_c.get(_uncond_key(tkey, embedder.input_key), batch_c["uncond_ids"])
                        batch_uc[tkey] = unc.expand(batch_c[tkey].shape)
        return c, self(batch_uc, force_zero_embeddings=force_uc_zero_embeddings)
