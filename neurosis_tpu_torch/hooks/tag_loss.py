"""Tag-frequency loss scaling (port of neurosis_tpu/hooks/tag_loss.py).

The reference ships only the config interface
(configs/hook/loss_scale.example.yml); the semantics are the JAX package's:

- ``TagFreqScale(scales=[[threshold, scale], ...])``: a tag's count so far →
  the scale of the largest threshold ≤ count;
- ``TagRewards(**{tag: multiplier})``: fixed per-tag multipliers;
- ``TagFrequencyHook``: per sample, the mean over its counted tags (those
  ``check_fn`` passes) of freq_scale(count) and over its tags of their
  rewards other than 1; ``beta`` smooths the batch mean across steps,
  ``alpha`` blends each sample with that running mean, ``strength`` lerps
  the result toward 1. ``pre_hook`` puts it in the batch as ``loss_scale``
  (float32, one a sample) and then counts the batch's tags; ``batch_hook``
  logs ``train/tag_loss_scale_mean`` and ``train/tag_vocab_size``.

Host numpy throughout.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .common import LossHook


def is_artist_or_character(tag: str) -> bool:
    """The default filter: namespace-prefixed artist and character tags."""
    return tag.strip().lower().startswith(("artist:", "character:", "art:", "char:"))


class TagFreqScale:
    """count → multiplier step table."""

    def __init__(self, scales: Sequence[Sequence[float]]):
        table = sorted((int(t), float(s)) for t, s in scales)
        self.thresholds = np.asarray([t for t, _ in table])
        self.values = np.asarray([s for _, s in table])

    def __call__(self, count: int) -> float:
        idx = max(int(np.searchsorted(self.thresholds, count, side="right")) - 1, 0)
        return float(self.values[idx])


class TagRewards:
    """Fixed per-tag multipliers; a key matches with '_' or ' '."""

    def __init__(self, **rewards: float):
        self.rewards = {}
        for k, v in rewards.items():
            if isinstance(v, str):
                v = float(v.rstrip(", "))
            self.rewards[k.replace("_", " ").strip()] = float(v)
            self.rewards[k.strip()] = float(v)

    def __call__(self, tag: str) -> float:
        return self.rewards.get(tag, self.rewards.get(tag.replace("_", " "), 1.0))


def _resolve_check_fn(check_fn):
    """A dotted name → the function: ``...is_artist_or_character`` is this
    module's (the reference's module path does not exist here), any other
    is imported."""
    if not isinstance(check_fn, str):
        return check_fn
    if check_fn.rsplit(".", 1)[-1] == "is_artist_or_character":
        return is_artist_or_character
    mod, _, fn = check_fn.rpartition(".")
    return getattr(importlib.import_module(mod), fn)


class TagFrequencyHook(LossHook):
    def __init__(self, input_key: str = "caption", tag_sep: str = ", ",
                 check_fn: Optional[Union[str, Callable[[str], bool]]] = None, alpha: float = 0.2,
                 beta: float = 0.99, strength: float = 1.0, freq_scale: Optional[TagFreqScale] = None,
                 tag_rewards: Optional[TagRewards] = None, **kwargs):
        super().__init__(**kwargs)
        self.input_key = input_key
        self.tag_sep = tag_sep
        self.check_fn = _resolve_check_fn(check_fn)
        self.alpha = alpha
        self.beta = beta
        self.strength = strength
        self.freq_scale = freq_scale or TagFreqScale([[-1, 1.0]])
        self.tag_rewards = tag_rewards or TagRewards()
        self.counts: dict[str, int] = {}
        self._ema = 1.0

    def _sample_tags(self, caption: str) -> tuple[list, list]:
        tags = [t.strip() for t in str(caption).split(self.tag_sep) if t.strip()]
        counted = [t for t in tags if self.check_fn(t)] if self.check_fn is not None else tags
        return tags, counted

    def _sample_scale(self, caption: str) -> float:
        tags, counted = self._sample_tags(caption)
        factors = [self.freq_scale(self.counts.get(t, 0)) for t in counted]
        factors += [r for r in (self.tag_rewards(t) for t in tags) if r != 1.0]
        return float(np.mean(factors)) if factors else 1.0

    def pre_hook(self, trainer, engine, batch: dict, batch_idx: int) -> dict:
        captions = batch.get(self.input_key)
        if captions is None:
            return batch
        if isinstance(captions, (str, bytes)):
            captions = [captions]
        raw = [c.decode() if isinstance(c, (bytes, np.bytes_)) else str(c) for c in captions]
        scales = np.asarray([self._sample_scale(c) for c in raw], np.float32)
        self._ema = self.beta * self._ema + (1.0 - self.beta) * float(scales.mean())
        blended = self.alpha * scales + (1.0 - self.alpha) * self._ema
        batch = dict(batch)
        batch["loss_scale"] = (1.0 + self.strength * (blended - 1.0)).astype(np.float32)
        for c in raw:  # counted after the scales: a tag's first batch gets the unseen boost
            for t in self._sample_tags(c)[1]:
                self.counts[t] = self.counts.get(t, 0) + 1
        return batch

    def batch_hook(self, engine, batch: dict, loss, loss_dict: dict) -> tuple:
        loss_dict = dict(loss_dict)
        if "loss_scale" in batch:
            loss_dict["train/tag_loss_scale_mean"] = float(np.mean(batch["loss_scale"]))
        loss_dict["train/tag_vocab_size"] = float(len(self.counts))
        return loss, loss_dict
