"""T5 and ByT5 text encoders (port of neurosis_tpu/models/text_encoder/t5.py).

The encoder stack of HF's T5 (v1.0 relu and v1.1/ByT5 gated-gelu): RMSNorm,
bias-free projections, unscaled attention with one relative-position bias
shared by every layer. Submodules follow HF's torch key layout
(``encoder.block.{i}.layer.0.SelfAttention.q``...), so the JAX package's
parameters load through ``jax_params_to_state_dict``. The prompts are 77
tokens, so attention is the plain matmul-softmax with fp32 logits plus the
bias, as JAX's (:79-93).

ByT5 tokenization is byte-level (utf-8 bytes + 3) and needs no vocabulary.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..._device import DeviceLike, resolve_device
from ...modules.encoders.embedding import AbstractEmbModel
from ...modules.layers import Dense, Embed, init_parameters


class RMSNorm(nn.Module):
    """T5's LayerNorm: a scale over the RMS, computed in fp32, cast back."""

    def __init__(self, features: int, epsilon: float = 1e-6, device: DeviceLike = None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features, device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x.dtype
        x = x.float()
        var = x.square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.epsilon)
        return (x * self.weight).to(orig)


def _rel_pos_bucket(relative_position: torch.Tensor, num_buckets: int = 32, max_distance: int = 128) -> torch.Tensor:
    """Bidirectional relative-position buckets (HF T5's)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_large)


class _T5SelfAttention(nn.Module):
    def __init__(self, d_model: int, heads: int, d_kv: int, has_rel_bias: bool = False, num_buckets: int = 32,
                 max_distance: int = 128, dtype=None, device: DeviceLike = None):
        super().__init__()
        self.heads, self.d_kv = heads, d_kv
        self.num_buckets, self.max_distance = num_buckets, max_distance
        inner = heads * d_kv
        self.q = Dense(d_model, inner, bias=False, dtype=dtype, device=device)
        self.k = Dense(d_model, inner, bias=False, dtype=dtype, device=device)
        self.v = Dense(d_model, inner, bias=False, dtype=dtype, device=device)
        self.o = Dense(inner, d_model, bias=False, dtype=dtype, device=device)
        self.relative_attention_bias = Embed(num_buckets, heads, device=device) if has_rel_bias else None

    def forward(self, x: torch.Tensor, pos_bias: Optional[torch.Tensor]):
        b, s, _ = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))  # T5 does not scale by 1/sqrt(d)
        if self.relative_attention_bias is not None:
            pos = torch.arange(s, device=x.device)
            buckets = _rel_pos_bucket(pos[None, :] - pos[:, None], self.num_buckets, self.max_distance)
            pos_bias = self.relative_attention_bias(buckets).permute(2, 0, 1)[None]  # (1, h, s, s)
        if pos_bias is not None:
            logits = logits + pos_bias
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, self.heads * self.d_kv)
        return self.o(out), pos_bias


class _DenseReluDense(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated_act: bool, dtype, device):
        super().__init__()
        self.gated_act = gated_act
        if gated_act:
            self.wi_0 = Dense(d_model, d_ff, bias=False, dtype=dtype, device=device)
            self.wi_1 = Dense(d_model, d_ff, bias=False, dtype=dtype, device=device)
        else:
            self.wi = Dense(d_model, d_ff, bias=False, dtype=dtype, device=device)
        self.wo = Dense(d_ff, d_model, bias=False, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.gated_act:
            h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        else:
            h = F.relu(self.wi(h))
        return self.wo(h)


class _AttentionLayer(nn.Module):
    def __init__(self, attention: _T5SelfAttention, d_model: int, device):
        super().__init__()
        self.layer_norm = RMSNorm(d_model, device=device)
        self.SelfAttention = attention


class _FeedForwardLayer(nn.Module):
    def __init__(self, ff: _DenseReluDense, d_model: int, device):
        super().__init__()
        self.layer_norm = RMSNorm(d_model, device=device)
        self.DenseReluDense = ff


class _Block(nn.Module):
    def __init__(self, d_model, d_kv, d_ff, heads, gated_act, has_rel_bias, dtype, device):
        super().__init__()
        self.layer = nn.ModuleList([
            _AttentionLayer(_T5SelfAttention(d_model, heads, d_kv, has_rel_bias, dtype=dtype, device=device),
                            d_model, device),
            _FeedForwardLayer(_DenseReluDense(d_model, d_ff, gated_act, dtype, device), d_model, device),
        ])

    def forward(self, x: torch.Tensor, pos_bias):
        attn, ff = self.layer
        out, pos_bias = attn.SelfAttention(attn.layer_norm(x), pos_bias)
        x = x + out
        return x + ff.DenseReluDense(ff.layer_norm(x)), pos_bias


class _Stack(nn.Module):
    def __init__(self, blocks: list, d_model: int, device):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.final_layer_norm = RMSNorm(d_model, device=device)


class T5EncoderModel(nn.Module):
    """HF-layout T5 encoder stack: ids [B, S] → hidden states [B, S, d_model]."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 768, d_kv: int = 64, d_ff: int = 2048,
                 num_layers: int = 12, num_heads: int = 12, gated_act: bool = True,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.shared = Embed(vocab_size, d_model, device=device)
        self.encoder = _Stack([_Block(d_model, d_kv, d_ff, num_heads, gated_act, i == 0, dtype, device)
                               for i in range(num_layers)], d_model, device)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids).to(self.dtype or torch.float32)
        pos_bias = None
        for block in self.encoder.block:
            x, pos_bias = block(x, pos_bias)
        return self.encoder.final_layer_norm(x)


class FrozenT5Embedder(AbstractEmbModel):
    """T5-XXL-style text embedder: the ``<input_key>_t5_ids`` token stream →
    (hidden states,), a 'crossattn' conditioning. ``version`` (the
    reference's HF model name) is taken and unused, as the JAX field is; the
    widths say the architecture."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 base_lr: Optional[float] = None, emb_name: Optional[str] = None,
                 version: str = "google/t5-v1_1-xxl", max_length: int = 77, vocab_size: int = 32128,
                 d_model: int = 768, d_kv: int = 64, d_ff: int = 2048, num_layers: int = 12, num_heads: int = 12,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name)
        self.version, self.max_length = version, max_length
        self.transformer = T5EncoderModel(vocab_size, d_model, d_kv, d_ff, num_layers, num_heads, dtype=dtype,
                                          device=device, generator=generator)
        self.requires_grad_(is_trainable)

    def token_key(self) -> str:
        return f"{self.input_key}_t5_ids"

    def forward(self, input_ids: torch.Tensor) -> tuple:
        return (self.transformer(input_ids),)


class FrozenByT5Embedder(FrozenT5Embedder):
    """Byte-level T5: a vocabulary of 256 bytes, 3 specials and extras."""

    def __init__(self, input_key: str = "caption", ucg_rate: float = 0.0, is_trainable: bool = False,
                 base_lr: Optional[float] = None, emb_name: Optional[str] = None,
                 version: str = "google/byt5-small", max_length: int = 77, vocab_size: int = 384,
                 d_model: int = 1472, d_kv: int = 64, d_ff: int = 3584, num_layers: int = 12, num_heads: int = 6,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_key, ucg_rate, is_trainable, base_lr, emb_name, version, max_length, vocab_size,
                         d_model, d_kv, d_ff, num_layers, num_heads, dtype, device, generator)


def byt5_tokenize(texts, max_length: int = 77) -> np.ndarray:
    """ByT5 tokenization: utf-8 bytes + 3 (0 = pad, 1 = eos, 2 = unk)."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), max_length), np.int32)
    for i, t in enumerate(texts):
        ids = [b + 3 for b in t.encode("utf-8")][: max_length - 1] + [1]
        out[i, : len(ids)] = ids
    return out
