"""Dataset utilities on numpy HWC uint8 images: decode, alpha over white,
Pillow's BICUBIC cover resize, crops with their coordinates, tag cleaning
and the batch collate (port of neurosis_tpu/data/utils.py).

The JAX package does this with Pillow; the card's machine has none, so:
  - ``.png`` files decode through ``data/png.py``; other extensions through
    Pillow, imported at that call (without it they raise ``ImportError``);
  - ``cover_resize`` reproduces ``ImageOps.cover(image, size, BICUBIC)`` pixel
    for pixel: Pillow's cubic with a = -0.5, its support widened by the
    reduction factor, its coefficients in 22-bit fixed point, a horizontal
    pass then a vertical pass with rounding to uint8 in between.
Crops are ``(image, (top, left))`` with the offsets drawn from the dataset's
``np.random.Generator`` in the JAX package's order.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from . import png

_PRECISION_BITS = 22  # Pillow's Resample.c: 32 - 8 - 2


def pil_ensure_rgb(image: np.ndarray, transparency=None) -> np.ndarray:
    """L, LA, RGB or RGBA pixels → RGB, as the JAX package's pil_ensure_rgb
    does with Pillow: L is replicated, LA drops its alpha (Pillow's LA→RGB
    conversion), an L image's tRNS key makes its pixels transparent (an RGB
    image's is not applied, as Pillow leaves an RGB image alone), and RGBA
    goes over white by Pillow's ``alpha_composite`` integer blend."""
    if image.ndim == 2:
        image = image[..., None]
    ch = image.shape[2]
    if ch in (1, 2):
        grey = image[..., :1]
        rgb = np.repeat(grey, 3, axis=2)
        if transparency is None:
            return rgb
        alpha = np.where(grey[..., 0] == transparency, 0, 255).astype(np.uint8)
        image = np.concatenate([rgb, alpha[..., None]], axis=2)
    elif ch == 3:
        return image  # Pillow keeps an RGB image as it is, its tRNS key unapplied
    return _over_white(image)


def _over_white(rgba: np.ndarray) -> np.ndarray:
    """Pillow's AlphaComposite.c with an opaque white destination (7 bits of
    extra precision, divisions by 255 by shifts)."""
    src = rgba.astype(np.int64)
    a = src[..., 3:4]
    outa255 = a * 255 + 255 * (255 - a)
    coef1 = a * 255 * 255 * (1 << 7) // np.maximum(outa255, 1)
    coef2 = 255 * (1 << 7) - coef1
    tmp = src[..., :3] * coef1 + 255 * coef2 + (0x80 << 7)
    out = (((tmp >> 8) + tmp) >> 8) >> 7
    out = np.where(a == 0, 255, out)
    return out.astype(np.uint8)


def decode_image(path) -> np.ndarray:
    """An image file → RGB uint8 HWC."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        pixels, _mode, transparency = png.read_png(path)
        return pil_ensure_rgb(pixels, transparency)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: only .png decodes without Pillow, which is not installed") from e
    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA"):
            im = im.convert("RGBA") if "transparency" in im.info else im.convert("RGB")
        if im.mode == "RGBA":
            canvas = Image.new("RGBA", im.size, (255, 255, 255))
            canvas.alpha_composite(im)
            im = canvas.convert("RGB")
        return np.asarray(im)


def image_size(path) -> tuple[int, int]:
    """(width, height) of an image file: from the PNG header, else Pillow."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return png.read_size(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: only .png is sized without Pillow, which is not installed") from e
    with Image.open(path) as im:
        return im.size


# -- Pillow's BICUBIC resize ---------------------------------------------------


def _bicubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int):
    """(first source index, taps, fixed-point coefficients [out, taps]) of
    Pillow's precompute_coeffs + normalize_coeffs_8bpc."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):  # in order, as the C loop sums
        total += w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * (1 << _PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int32)
    return xmin, ksize, fixed


def _resample(image: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    in_size = image.shape[axis]
    xmin, ksize, k = _coefficients(in_size, out_size)
    shape = [1] * image.ndim
    shape[axis] = out_size
    acc = np.full(image.shape[:axis] + (out_size,) + image.shape[axis + 1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(ksize):
        src = np.take(image, np.minimum(xmin + t, in_size - 1), axis=axis)
        acc += src * k[:, t].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``Image.resize(size, BICUBIC)`` of RGB uint8 HWC pixels; ``size`` is
    (width, height)."""
    width, height = size
    if image.shape[1] != width:
        image = _resample(image, 1, width)
    if image.shape[0] != height:
        image = _resample(image, 0, height)
    return image


def cover_resize(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``ImageOps.cover(image, size, BICUBIC)``: the smallest resize, aspect
    kept, that covers ``size`` (width, height)."""
    h, w = image.shape[:2]
    im_ratio = w / h
    dest_ratio = size[0] / size[1]
    if im_ratio != dest_ratio:
        if im_ratio < dest_ratio:
            new_height = round(h / w * size[0])
            if new_height != size[1]:
                size = (size[0], new_height)
        else:
            new_width = round(w / h * size[1])
            if new_width != size[0]:
                size = (new_width, size[1])
    return resize_bicubic(image, size)


def _crop(image: np.ndarray, left: int, top: int, width: int, height: int) -> np.ndarray:
    """``Image.crop((left, top, left + width, top + height))``: zeros outside."""
    out = np.zeros((height, width) + image.shape[2:], image.dtype)
    h, w = image.shape[:2]
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + height, h), min(left + width, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = image[y0:y1, x0:x1]
    return out


def pil_crop_square(image: np.ndarray, size, rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    if isinstance(size, int):
        size = (size, size)
    image = cover_resize(image, size)
    h, w = image.shape[:2]
    min_edge = min(w, h)
    delta_w, delta_h = w - min_edge, h - min_edge
    if all((delta_w, delta_h)):
        raise ValueError(f"Failed to crop short edge to match {size}!")
    top = int(rng.integers(delta_h + 1))
    left = int(rng.integers(delta_w + 1))
    return _crop(image, left, top, size[0], size[1]), (top, left)


def pil_crop_bucket(image: np.ndarray, bucket, rng: Optional[np.random.Generator] = None):
    """Cover-resize to the bucket then random-crop the long edge; returns
    (image, (top, left)) for SDXL's crop conditioning."""
    rng = rng or np.random.default_rng()
    image = cover_resize(image, bucket.size)
    height, width = image.shape[:2]
    delta_w = width - bucket.width
    delta_h = height - bucket.height
    if delta_w != 0 and delta_h != 0:
        raise ValueError(f"Failed to crop short edge to match {bucket}!")
    if delta_w == 0 and delta_h == 0:
        return image, (0, 0)
    top = int(rng.integers(delta_h + 1))
    left = int(rng.integers(delta_w + 1))
    return _crop(image, left, top, bucket.width, bucket.height), (top, left)


def load_bucket_image_file(path, bucket, rng=None):
    if isinstance(path, bytes):
        path = path.decode("utf-8")
    return pil_crop_bucket(decode_image(path), bucket, rng)


def load_crop_image_file(path, resolution, rng=None):
    if isinstance(path, bytes):
        path = path.decode("utf-8")
    return pil_crop_square(decode_image(path), resolution, rng)


def image_to_array(image: np.ndarray, dtype: str = "float32") -> np.ndarray:
    """RGB uint8 HWC → float32 in [-1, 1] as x·(2/255) − 1; ``dtype="uint8"``
    keeps the raw bytes (the engines dequantize on the device)."""
    arr = np.asarray(image)
    if dtype == "uint8":
        return arr if arr.dtype == np.uint8 else np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)
    return np.asarray(arr, dtype=np.float32) / 255.0 * 2.0 - 1.0


def clean_word(word_sep: str, word: Union[str, bytes]) -> str:
    if isinstance(word, (bytes, np.bytes_)):
        word = word.decode("utf-8")
    return word.replace("_", word_sep).replace(" ", word_sep).strip()


def clean_caption(
    caption: str,
    process_tags: bool = True,
    shuffle_tags: bool = False,
    shuffle_keep: int = 0,
    tag_sep: str = ", ",
    word_sep: str = " ",
    rng: Optional[np.random.Generator] = None,
) -> str:
    """Tag clean/shuffle (imagefolder/aspect.py:129-144)."""
    if not process_tags:
        return caption.strip()
    rng = rng or np.random.default_rng()
    tags = [clean_word(word_sep, x) for x in caption.split(", ")]
    if shuffle_tags:
        if shuffle_keep > 0:
            tags = tags[:shuffle_keep] + [tags[shuffle_keep:][i] for i in rng.permutation(len(tags) - shuffle_keep)]
        else:
            tags = [tags[i] for i in rng.permutation(len(tags))]
    return tag_sep.join(tags).strip()


def collate_dict_stack(samples: Sequence[dict]) -> dict:
    """list-of-dicts → dict of stacked numpy arrays / string lists (numeric
    tuples such as the SDXL sizes become float32 [B, n])."""
    out: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        v0 = vals[0]
        if isinstance(v0, np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(v0, (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        elif isinstance(v0, (tuple, list)) and v0 and isinstance(v0[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals, dtype=np.float32)
        else:
            out[key] = list(vals)
    return out
