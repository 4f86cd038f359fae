"""CLIP text towers (port of neurosis_tpu/models/text_encoder/clip.py): the HF
CLIP-L layout and the open_clip (ViT-bigG) layout.

Both are pre-LN causal transformers; they differ in naming (for weight
import), activation (quick_gelu against exact gelu) and the text projection.
Submodules follow the HF CLIPTextModel key layout
(``text_model.encoder.layers.{i}.self_attn.q_proj``...) and open_clip's
(``transformer.resblocks.{i}.attn.q_proj``..., q/k/v split from the fused
``in_proj`` by ``split_openclip_qkv``). Sequences are 77 tokens, so attention
is the plain causal matmul-softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..._device import DeviceLike, resolve_device
from ...modules.layers import Dense, Embed, LayerNorm32, init_parameters
from ...ops.attention import plain_attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _SelfAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device):
        super().__init__()
        self.heads = heads
        self.q_proj = Dense(width, width, dtype=dtype, device=device)
        self.k_proj = Dense(width, width, dtype=dtype, device=device)
        self.v_proj = Dense(width, width, dtype=dtype, device=device)
        self.out_proj = Dense(width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, width = x.shape
        d = width // self.heads

        def split(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2)

        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        out = plain_attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)), causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, width))


class _MLP(nn.Module):
    def __init__(self, width: int, dtype, device):
        super().__init__()
        self.fc1 = Dense(width, width * 4, dtype=dtype, device=device)
        self.fc2 = Dense(width * 4, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class _EncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device):
        super().__init__()
        self.layer_norm1 = LayerNorm32(width, device=device)
        self.self_attn = _SelfAttention(width, heads, dtype, device)
        self.layer_norm2 = LayerNorm32(width, device=device)
        self.mlp = _MLP(width, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, width: int, max_positions: int, device):
        super().__init__()
        self.token_embedding = Embed(vocab_size, width, device=device)
        self.position_embedding = Embed(max_positions, width, device=device)


class _Encoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(_EncoderLayer(width, heads, dtype, device) for _ in range(layers))


class _TextModel(nn.Module):
    def __init__(self, vocab_size, width, layers, heads, max_positions, dtype, device):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, width, max_positions, device)
        self.encoder = _Encoder(width, layers, heads, dtype, device)
        self.final_layer_norm = LayerNorm32(width, device=device)


class CLIPTextTower(nn.Module):
    """CLIPTextModel parity. Returns 'hidden_states' ([0] = embeddings, [i] =
    output of layer i), 'last_hidden_state' (after the final LN) and
    'pooler_output' (last_hidden_state at the argmax token id, CLIP's EOS)."""

    def __init__(self, vocab_size: int = 49408, width: int = 768, layers: int = 12, heads: int = 12,
                 max_positions: int = 77, dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.text_model = _TextModel(vocab_size, width, layers, heads, max_positions, dtype, device)
        init_parameters(self, generator if generator is not None else torch.Generator(device).manual_seed(0))

    def forward(self, input_ids: torch.Tensor) -> dict:
        tm = self.text_model
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)
        x = x.to(self.dtype or x.dtype)
        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
        last = tm.final_layer_norm(x)
        pooled = last[torch.arange(b, device=last.device), input_ids.argmax(dim=-1)]
        return {"hidden_states": hidden_states, "last_hidden_state": last, "pooler_output": pooled}


class _OpenCLIPMLP(nn.Module):
    def __init__(self, width: int, dtype, device):
        super().__init__()
        self.c_fc = Dense(width, width * 4, dtype=dtype, device=device)
        self.c_proj = Dense(width * 4, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))  # exact (erf) gelu


class _ResBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device):
        super().__init__()
        self.ln_1 = LayerNorm32(width, device=device)
        self.attn = _SelfAttention(width, heads, dtype, device)
        self.ln_2 = LayerNorm32(width, device=device)
        self.mlp = _OpenCLIPMLP(width, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype, device):
        super().__init__()
        self.resblocks = nn.ModuleList(_ResBlock(width, heads, dtype, device) for _ in range(layers))


class OpenCLIPTextTower(nn.Module):
    """open_clip-layout text tower (ViT-bigG: width 1280, 32 layers, 20 heads).

    Returns 'penultimate' (the input of the last resblock), 'last' (after
    all blocks, before ln_final), 'last_ln' (after ln_final) and 'pooled'
    (last_ln at the argmax token id, CLIP's EOS, times text_projection)."""

    def __init__(self, vocab_size: int = 49408, width: int = 1280, layers: int = 32, heads: int = 20,
                 max_positions: int = 77, dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.token_embedding = Embed(vocab_size, width, device=device)
        self.positional_embedding = nn.Parameter(torch.empty(max_positions, width, device=device))
        self.transformer = _Transformer(width, layers, heads, dtype, device)
        self.ln_final = LayerNorm32(width, device=device)
        self.text_projection = nn.Parameter(torch.empty(width, width, device=device))
        generator = generator if generator is not None else torch.Generator(device).manual_seed(0)
        init_parameters(self, generator)
        with torch.no_grad():
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
            self.text_projection.normal_(0.0, 0.01, generator=generator)

    def forward(self, input_ids: torch.Tensor) -> dict:
        b, s = input_ids.shape
        x = self.token_embedding(input_ids) + self.positional_embedding[None, :s]
        x = x.to(self.dtype or x.dtype)
        penultimate = None
        blocks = self.transformer.resblocks
        for i, block in enumerate(blocks):
            if i == len(blocks) - 1:
                penultimate = x
            x = block(x)
        last_ln = self.ln_final(x)
        eos = last_ln[torch.arange(b, device=x.device), input_ids.argmax(dim=-1)]
        pooled = eos @ self.text_projection.to(last_ln.dtype)
        return {"penultimate": penultimate, "last": x, "last_ln": last_ln, "pooled": pooled}


def split_openclip_qkv(state_dict: dict) -> dict:
    """open_clip's fused ``attn.in_proj_{weight,bias}`` (nn.MultiheadAttention,
    [3·width, ...]) → the tower's separate ``attn.{q,k,v}_proj``; other
    entries pass through. Values are torch tensors."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith(("attn.in_proj_weight", "attn.in_proj_bias")):
            base, suffix = key.rsplit("attn.in_proj_", 1)
            for name, part in zip("qkv", torch.chunk(val, 3, dim=0)):
                out[f"{base}attn.{name}_proj.{suffix}"] = part
        else:
            out[key] = val
    return out
