"""Hugging Face datasets adapter (port of neurosis_tpu/data/hfds.py; the
reference README.md:35: "it should work if the keys match").

Wraps any indexable dataset of dict rows (a ``datasets.Dataset``, a list of
dicts, anything with ``__len__`` and ``__getitem__``) into the batch
contract: cover-resize and random-crop to a fixed square, or to an aspect
bucket when ``buckets`` is given, SDXL's size conditionings, the caption
cleaned, and a same-bucket batch schedule, drawn from
``np.random.default_rng(seed)`` in the JAX package's order. Images are
numpy arrays (uint8 as they are; float arrays taken as [0, 1], the
``datasets`` convention, scaled by 255, clipped and truncated to uint8) or
PIL images, read through Pillow where it imports. Nothing here imports
``datasets``; column access (``dataset["width"]``) is used where the
dataset offers it.
"""

from __future__ import annotations

from typing import Any, Generator, Optional, Sequence

import numpy as np

from .utils import (clean_caption, collate_dict_stack, cropped_sample_fields, pil_ensure_rgb, pillow_to_rgb,
                    shuffled_chunk_batches)


def _as_rgb(image) -> np.ndarray:
    """A row's image → RGB uint8 HWC, by the JAX package's dtype rule
    (hfds.py:21-37)."""
    if hasattr(image, "convert"):  # a PIL image
        return pillow_to_rgb(image)
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr * 255.0
        arr = np.clip(arr, 0.0, 255.0).astype(np.uint8)
    return pil_ensure_rgb(arr)


class HFDatasetAdapter:
    """dataset[i][image_key / caption_key] → training batches."""

    def __init__(
        self,
        dataset: Any,
        image_key: str = "image",
        caption_key: str = "caption",
        resolution: int = 256,
        batch_size: int = 1,
        buckets: Optional[Any] = None,  # AspectBucketList → aspect mode
        clamp_orig: bool = True,
        process_tags: bool = True,
        shuffle_tags: bool = False,
        shuffle_keep: int = 0,
        tag_sep: str = ", ",
        word_sep: str = " ",
        seed: int = 0,
    ):
        self.dataset = dataset
        self.image_key = image_key
        self.caption_key = caption_key
        self.resolution = (resolution, resolution) if isinstance(resolution, int) else tuple(resolution)
        self.batch_size = batch_size
        self.buckets = buckets
        self.clamp_orig = clamp_orig
        self.process_tags = process_tags
        self.shuffle_tags = shuffle_tags
        self.shuffle_keep = shuffle_keep
        self.tag_sep = tag_sep
        self.word_sep = word_sep
        self.rng = np.random.default_rng(seed)
        self._bucket_idx: Optional[np.ndarray] = None
        if buckets is not None:
            self._assign_buckets()

    def __len__(self) -> int:
        return len(self.dataset)

    # -- aspect mode ---------------------------------------------------------

    def _assign_buckets(self) -> None:
        """Each row's bucket, from the ``aspect`` or ``width``/``height``
        columns where the dataset gives them whole, else row by row (its
        fields, or the decoded image's size)."""
        n = len(self.dataset)
        aspects = None
        for cols in (("aspect",), ("width", "height")):
            try:
                vals = [np.asarray(self.dataset[c], dtype=np.float64) for c in cols]
            except (KeyError, IndexError, TypeError, ValueError):
                continue
            if all(v.shape == (n,) for v in vals):
                aspects = vals[0] if len(vals) == 1 else vals[0] / vals[1]
                break
        idxs = np.zeros(n, np.int64)
        for i in range(n):
            if aspects is not None:
                aspect = float(aspects[i])
            else:
                row = self.dataset[i]
                if "aspect" in row:
                    aspect = float(row["aspect"])
                elif "width" in row and "height" in row:
                    aspect = float(row["width"]) / float(row["height"])
                else:
                    h, w = _as_rgb(row[self.image_key]).shape[:2]
                    aspect = w / h
            idxs[i] = int(self.buckets.bucket_idx(aspect))
        self._bucket_idx = idxs

    # -- samples -------------------------------------------------------------

    def __getitem__(self, index: int) -> dict:
        return self._item(index, self.rng)

    def _item(self, index: int, rng: np.random.Generator) -> dict:
        row = self.dataset[index]
        image = _as_rgb(row[self.image_key])
        bucket = self.buckets[int(self._bucket_idx[index])] if self.buckets is not None else None
        arr, fields = cropped_sample_fields(image, bucket=bucket, resolution=self.resolution, rng=rng,
                                            clamp_orig=self.clamp_orig)
        caption = row.get(self.caption_key, "") if hasattr(row, "get") else row[self.caption_key]
        caption = clean_caption(str(caption), process_tags=self.process_tags, shuffle_tags=self.shuffle_tags,
                                shuffle_keep=self.shuffle_keep, tag_sep=self.tag_sep, word_sep=self.word_sep, rng=rng)
        return {self.image_key: arr, self.caption_key: caption, **fields}

    # -- batches -------------------------------------------------------------

    def get_batch(self, indices: Sequence[int], rng: Optional[np.random.Generator] = None) -> dict:
        """The collated samples, their draws from ``rng`` when given."""
        return collate_dict_stack([self._item(i, self.rng if rng is None else rng) for i in indices])

    def get_batch_iterator(self) -> Generator[list, None, None]:
        if self.buckets is None:
            return shuffled_chunk_batches(len(self.dataset), self.batch_size, self.rng)
        # same-bucket batches: rows in one shuffled order, cut by bucket, the batches shuffled
        order = np.arange(len(self.dataset), dtype=np.int64)
        self.rng.shuffle(order)
        by_bucket: dict = {}
        for i in order:
            by_bucket.setdefault(int(self._bucket_idx[i]), []).append(int(i))
        sched = []
        for items in by_bucket.values():
            for b in range(len(items) // self.batch_size):
                sched.append(items[b * self.batch_size:(b + 1) * self.batch_size])
        self.rng.shuffle(sched)
        return iter(sched)
