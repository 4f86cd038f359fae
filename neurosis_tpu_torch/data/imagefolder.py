"""ImageFolder datasets: aspect-bucketed and square variants, and the
aspect variant with captions drawn from a tag list (port of
neurosis_tpu/data/imagefolder.py; parity: dataset/imagefolder/aspect.py:26-191,
nobucket.py:19-123, nocaption.py:19-78, meme.py:26-204).

Without pandas: the sample table is lists and numpy arrays. The merge of
undersized portrait buckets and the batch schedule keep the JAX package's
order and its draws from ``np.random.default_rng(seed)``, so both packages
give the same batches. Image sizes come from the PNG header, without
decoding (other formats from Pillow). Samples are numpy NHWC; the trainer
moves a batch to the device. ``get_batch`` takes the generator a batch
draws from, so prefetch workers give the batches of the main process
(``data/prefetch.py``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Generator, Optional, Sequence

import numpy as np

from .aspect import AspectBucket, AspectBucketList, SDXLBucketList
from .utils import (
    clean_caption,
    collate_dict_stack,
    image_size,
    image_to_array,
    load_bucket_image_file,
    load_crop_image_file,
    same_bucket_batches,
)

logger = logging.getLogger(__name__)

IMAGE_EXTNS = {".png", ".jpg", ".jpeg", ".webp", ".bmp", ".gif", ".tiff"}


def _image_files(folder: Path, recursive: bool) -> list[Path]:
    file_iter = folder.rglob("**/*.*") if recursive else folder.glob("*.*")
    return sorted(x for x in file_iter if x.is_file() and x.suffix.lower() in IMAGE_EXTNS)


class ImageFolderDataset:
    """Folder of images + sidecar caption files, bucketed by aspect."""

    def __init__(
        self,
        folder,
        buckets: Optional[AspectBucketList] = None,
        batch_size: int = 1,
        image_key: str = "image",
        caption_key: str = "caption",
        caption_ext: str = ".txt",
        tag_sep: str = ", ",
        word_sep: str = " ",
        recursive: bool = False,
        clamp_orig: bool = True,
        process_tags: bool = True,
        shuffle_tags: bool = True,
        shuffle_keep: int = 0,
        seed: int = 0,
        image_dtype: str = "float32",  # "uint8": the engines dequantize on the device
    ):
        self.folder = Path(folder).resolve()
        if not self.folder.is_dir():
            raise FileNotFoundError(f"Folder {self.folder} does not exist or is not a directory.")
        self.buckets = buckets if buckets is not None else SDXLBucketList()
        self.batch_size = batch_size
        self.image_key = image_key
        self.caption_key = caption_key
        self.caption_ext = caption_ext
        self.tag_sep = tag_sep
        self.word_sep = word_sep
        self.recursive = recursive
        self.clamp_orig = clamp_orig
        self.process_tags = process_tags
        self.shuffle_tags = shuffle_tags
        self.shuffle_keep = shuffle_keep
        self.image_dtype = image_dtype
        self.rng = np.random.default_rng(seed)
        self.preload()

    # -- metadata ----------------------------------------------------------

    def preload(self):
        image_files = _image_files(self.folder, self.recursive)
        if not image_files:
            raise FileNotFoundError(f"no images in {self.folder}")
        self.image_paths: list[str] = []
        self.captions: list[str] = []
        resolutions, bucket_idx = [], []
        for path in image_files:
            caption = self._read_caption(path)
            width, height = image_size(path)
            self.image_paths.append(str(path))
            self.captions.append(caption)
            resolutions.append((width, height))
            bucket_idx.append(self.buckets.bucket_idx(float(width) / float(height)))
        self.resolutions = np.asarray(resolutions, np.int32)
        self.bucket_idx = np.asarray(bucket_idx, np.int32)

        # merge undersized portrait buckets into the next one (aspect.py:111-118),
        # deciding on the counts taken before any merge
        ids, counts = np.unique(self.bucket_idx, return_counts=True)
        for bucket_id, n in zip(ids, counts):
            if n >= self.batch_size:
                continue
            if self.buckets[int(bucket_id)].aspect < 1.0:
                self.bucket_idx[self.bucket_idx == bucket_id] = int(bucket_id) + 1

    def _read_caption(self, path: Path) -> str:
        caption_file = path.with_suffix(self.caption_ext)
        if not caption_file.exists():
            raise FileNotFoundError(f"Caption {self.caption_ext} for image {path} does not exist.")
        return caption_file.read_text(encoding="utf-8")

    # -- items -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int) -> dict:
        return self._item(index, self.rng)

    def _item(self, index: int, rng: np.random.Generator) -> dict:
        bucket: AspectBucket = self.buckets[int(self.bucket_idx[index])]
        image, crop = load_bucket_image_file(self.image_paths[index], bucket, rng=rng)
        caption = clean_caption(
            self.captions[index],
            process_tags=self.process_tags,
            shuffle_tags=self.shuffle_tags,
            shuffle_keep=self.shuffle_keep,
            tag_sep=self.tag_sep,
            word_sep=self.word_sep,
            rng=rng,
        )
        return {
            self.image_key: image_to_array(image, self.image_dtype),
            self.caption_key: caption,
            "original_size_as_tuple": self._get_osize(tuple(self.resolutions[index]), bucket),
            "crop_coords_top_left": crop,
            "target_size_as_tuple": bucket.size,
        }

    def get_batch(self, indices: Sequence[int], rng: Optional[np.random.Generator] = None) -> dict:
        """The collated samples; their draws (crops, tag shuffles) come from
        ``rng`` when given, else from the dataset's own generator."""
        return collate_dict_stack([self._item(i, self.rng if rng is None else rng) for i in indices])

    def _get_osize(self, resolution, bucket: AspectBucket):
        if not self.clamp_orig:
            return tuple(int(x) for x in resolution)
        return (min(int(resolution[0]), bucket.width), min(int(resolution[1]), bucket.height))

    # -- batch schedule (aspect.py:160-191) --------------------------------

    def get_batch_iterator(self) -> Generator[list[int], None, None]:
        return same_bucket_batches(self.bucket_idx, self.batch_size, self.rng)


class FolderSquareDataset:
    """Square-resize variant with captions (nobucket.py:19-123)."""

    def __init__(
        self,
        folder,
        resolution: int = 256,
        batch_size: int = 1,
        image_key: str = "image",
        caption_key: str = "caption",
        caption_ext: str = ".txt",
        recursive: bool = False,
        process_tags: bool = True,
        shuffle_tags: bool = False,
        shuffle_keep: int = 0,
        tag_sep: str = ", ",
        word_sep: str = " ",
        seed: int = 0,
        image_dtype: str = "float32",  # "uint8": the engines dequantize on the device
    ):
        self.folder = Path(folder).resolve()
        self.resolution = resolution
        self.image_dtype = image_dtype
        self.batch_size = batch_size
        self.image_key = image_key
        self.caption_key = caption_key
        self.caption_ext = caption_ext
        self.process_tags = process_tags
        self.shuffle_tags = shuffle_tags
        self.shuffle_keep = shuffle_keep
        self.tag_sep = tag_sep
        self.word_sep = word_sep
        self.rng = np.random.default_rng(seed)
        self.paths = _image_files(self.folder, recursive)
        if not self.paths:
            raise FileNotFoundError(f"no images in {self.folder}")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> dict:
        return self._item(index, self.rng)

    def _item(self, index: int, rng: np.random.Generator) -> dict:
        path = self.paths[index]
        image, _ = load_crop_image_file(str(path), self.resolution, rng=rng)
        caption_file = path.with_suffix(self.caption_ext)
        caption = caption_file.read_text(encoding="utf-8") if caption_file.exists() else ""
        caption = clean_caption(
            caption,
            process_tags=self.process_tags,
            shuffle_tags=self.shuffle_tags,
            shuffle_keep=self.shuffle_keep,
            tag_sep=self.tag_sep,
            word_sep=self.word_sep,
            rng=rng,
        )
        return {self.image_key: image_to_array(image, self.image_dtype), self.caption_key: caption}

    def get_batch(self, indices: Sequence[int], rng: Optional[np.random.Generator] = None) -> dict:
        """The collated samples, their draws from ``rng`` when given."""
        return collate_dict_stack([self._item(i, self.rng if rng is None else rng) for i in indices])

    def get_batch_iterator(self) -> Generator[list[int], None, None]:
        order = self.rng.permutation(len(self.paths))
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield [int(j) for j in order[i : i + self.batch_size]]


class FolderVAEDataset(FolderSquareDataset):
    """No-caption VAE variant (nocaption.py:19-78)."""

    def _item(self, index: int, rng: np.random.Generator) -> dict:
        image, _ = load_crop_image_file(str(self.paths[index]), self.resolution, rng=rng)
        return {self.image_key: image_to_array(image, self.image_dtype)}


class MemeAspectDataset(ImageFolderDataset):
    """Aspect dataset whose captions are drawn from a global tag list
    (meme.py:26-204): each sample gets ``tags_per_img`` tags of
    ``tag_list_path`` (relative to the folder unless absolute), without
    repeats, and ``prepend_tag`` first with probability ``prepend_rate``;
    the draws follow the crop's, from the same generator, in the JAX
    package's order. No caption files are read."""

    def __init__(self, folder, tag_list_path="tag_list.txt", tags_per_img: int = 50, prepend_tag: Optional[str] = None,
                 prepend_rate: float = 0.0, **kwargs):
        tag_path = Path(tag_list_path)
        if not tag_path.is_absolute():
            tag_path = Path(folder) / tag_path
        self.tag_list = [t.strip() for t in tag_path.read_text().splitlines() if t.strip()]
        self.tags_per_img = tags_per_img
        self.prepend_tag = prepend_tag
        self.prepend_rate = prepend_rate
        kwargs.setdefault("process_tags", False)
        super().__init__(folder, **kwargs)

    def _read_caption(self, path: Path) -> str:
        return ""  # drawn per sample

    def _item(self, index: int, rng: np.random.Generator) -> dict:
        sample = super()._item(index, rng)
        n = min(self.tags_per_img, len(self.tag_list))
        tags = [self.tag_list[i] for i in rng.choice(len(self.tag_list), size=n, replace=False)]
        if self.prepend_tag and rng.random() < self.prepend_rate:
            tags = [self.prepend_tag] + tags
        sample[self.caption_key] = self.tag_sep.join(tags)
        return sample
