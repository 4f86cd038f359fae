"""Self-contained CLIP BPE tokenizer, no network (port of
neurosis_tpu/models/text_encoder/tokenizer.py).

The reference delegates to ``transformers.CLIPTokenizer.from_pretrained`` (a
runtime download, models/text_encoder/clip.py:48); here the BPE algorithm is
implemented directly and the learned vocab is loaded from local files:

  - HF layout: vocab.json + merges.txt (searched in an explicit path, the
    NEUROSIS_TOKENIZER_DIR env var, or the standard HF cache), or
  - openai CLIP layout: bpe_simple_vocab_16e6.txt.gz.

Matches CLIP tokenization: NFC-ish cleanup, lowercase, regex split, byte-level
BPE with `</w>` end-of-word markers, BOS=49406 / EOS=49407, pad with EOS (the
HF CLIPTokenizer pads with its pad_token = EOS for CLIP; SD uses this).

Also provides ``tokenize_extended`` — the reference's long-prompt chunking
(clip.py:168-196): tokenize without specials into N×75 chunks, re-add BOS/EOS
per chunk.

The ``regex`` package (the CLIP pattern's ``\\p{L}`` classes) is imported
when a tokenizer is built, not with this module: a run without a vocabulary
never needs it, and one with a vocabulary on a machine without ``regex``
raises ``ImportError`` naming it.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np

_PAT = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""


@functools.lru_cache()
def _pattern():
    try:
        import regex
    except ImportError as e:
        raise ImportError("the CLIP BPE tokenizer needs the 'regex' package for its split pattern") from e
    return regex.compile(_PAT, regex.IGNORECASE)


@functools.lru_cache()
def bytes_to_unicode() -> dict:
    """Reversible byte↔unicode mapping (GPT-2/CLIP standard)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class CLIPTokenizer:
    """Byte-level BPE with CLIP semantics."""

    def __init__(self, encoder: dict, bpe_merges: Sequence[tuple], max_length: int = 77):
        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(bpe_merges)}
        self.cache: dict[str, str] = {}
        self.max_length = max_length
        self.bos_token_id = self.encoder.get("<|startoftext|>", len(self.encoder) - 2)
        self.eos_token_id = self.encoder.get("<|endoftext|>", len(self.encoder) - 1)
        self.pad_token_id = self.eos_token_id  # HF CLIPTokenizer pads with EOS
        self.model_max_length = max_length
        self._pat = _pattern()

    # -- vocab loading -----------------------------------------------------

    @classmethod
    def from_pretrained(cls, name_or_path: str = "openai/clip-vit-large-patch14", max_length: int = 77):
        path = _resolve_vocab_dir(name_or_path)
        if path is None:
            raise FileNotFoundError(
                f"No local tokenizer vocab for {name_or_path!r}. Place vocab.json+merges.txt "
                "in NEUROSIS_TOKENIZER_DIR, the HF cache, or pass a directory path."
            )
        if (path / "vocab.json").exists():
            encoder = json.loads((path / "vocab.json").read_text())
            merges_lines = (path / "merges.txt").read_text().split("\n")
            merges = [tuple(m.split()) for m in merges_lines if m and not m.startswith("#version")]
            return cls(encoder, merges, max_length=max_length)
        gz = path / "bpe_simple_vocab_16e6.txt.gz"
        if gz.exists():
            merges_lines = gzip.open(gz).read().decode("utf-8").split("\n")[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges_lines]
            vocab = list(bytes_to_unicode().values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab.extend("".join(m) for m in merges)
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            encoder = dict(zip(vocab, range(len(vocab))))
            return cls(encoder, merges, max_length=max_length)
        raise FileNotFoundError(f"no vocab files found under {path}")

    # -- BPE ---------------------------------------------------------------

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Token ids WITHOUT special tokens."""
        bpe_tokens: list[int] = []
        for token in self._pat.findall(_clean_text(text)):
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token_bytes).split(" ") if t in self.encoder
            )
        return bpe_tokens

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        special = {self.bos_token_id, self.eos_token_id} if skip_special_tokens else set()
        text = "".join(self.decoder.get(i, "") for i in ids if i not in special)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # -- batch APIs (reference tokenize/tokenize_extended parity) ----------

    def __call__(self, texts: str | Sequence[str], max_length: Optional[int] = None) -> np.ndarray:
        """[B, max_length] int32: BOS + tokens (truncated) + EOS + EOS-pad."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        out = np.full((len(texts), max_length), self.pad_token_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)[: max_length - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            out[i, : len(row)] = row
        return out

    def tokenize_extended(self, texts: str | Sequence[str], chunks: int) -> np.ndarray:
        """[B, chunks, max_length] int32 — clip.py:168-196 chunking contract."""
        if isinstance(texts, str):
            texts = [texts]
        chunk_tokens = self.max_length - 2
        max_tokens = chunks * chunk_tokens
        out = np.zeros((len(texts), chunks, self.max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)[:max_tokens]
            ids = ids + [0] * (max_tokens - len(ids))
            arr = np.asarray(ids, dtype=np.int32).reshape(chunks, chunk_tokens)
            out[i, :, 0] = self.bos_token_id
            out[i, :, 1:-1] = arr
            out[i, :, -1] = self.eos_token_id
        return out


def _resolve_vocab_dir(name_or_path: str) -> Optional[Path]:
    p = Path(name_or_path)
    if p.is_dir():
        return p
    env = os.environ.get("NEUROSIS_TOKENIZER_DIR")
    if env and Path(env).is_dir():
        return Path(env)
    # HF cache layout: ~/.cache/huggingface/hub/models--org--name/snapshots/*/
    cache = Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")) / "hub"
    model_dir = cache / ("models--" + name_or_path.replace("/", "--"))
    if model_dir.is_dir():
        snaps = sorted((model_dir / "snapshots").glob("*"))
        for s in reversed(snaps):
            if (s / "vocab.json").exists():
                return s
    return None


def make_test_tokenizer(words: Sequence[str] = (), max_length: int = 16) -> CLIPTokenizer:
    """Tiny tokenizer for unit tests: byte-level vocab + given whole words."""
    vocab = list(bytes_to_unicode().values())
    vocab = vocab + [v + "</w>" for v in vocab]
    merges = []
    for w in words:
        chars = tuple(w[:-1]) + (w[-1] + "</w>",)
        while len(chars) > 1:
            merges.append((chars[0], chars[1]))
            chars = (chars[0] + chars[1],) + chars[2:]
        vocab.append(w + "</w>")
    vocab.extend(["<|startoftext|>", "<|endoftext|>"])
    encoder = dict(zip(vocab, range(len(vocab))))
    return CLIPTokenizer(encoder, merges, max_length=max_length)
