"""Image utilities (port of neurosis_tpu/utils/image.py; parity:
utils/image/{convert,grid,label}.py, utils/vae.py).

numpy only, for the card's machine has no Pillow: model outputs ([-1, 1]
NHWC) become uint8 arrays, sample grids get word-wrapped captions and a step
label drawn from the port's glyph atlas (``utils/font.py``, the JAX
package's font at its sizes), and PNGs are written by ``data/png.py``. An
"image" here is a uint8 HxWx3 (or HxW) array where the JAX package has a
Pillow image.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..data.png import write_png
from . import font

CAPTION_SIZE = 12  # the JAX package's default font size


def denormalize(x: np.ndarray) -> np.ndarray:
    """[-1,1] → [0,1] (utils/image/vae.py parity)."""
    return np.clip((np.asarray(x, np.float32) + 1.0) / 2.0, 0.0, 1.0)


def make_grid_nhwc(batch: np.ndarray, ncols: int = 4, pad: int = 0) -> np.ndarray:
    """Tile a (b, h, w, c) batch into one (H, W, c) image, row-major with
    ``ncols`` columns (torchvision make_grid role, NHWC layout)."""
    batch = np.asarray(batch)
    b, h, w, c = batch.shape
    ncols = max(1, min(ncols, b))
    nrows = (b + ncols - 1) // ncols
    out = np.zeros((nrows * (h + pad), ncols * (w + pad), c), batch.dtype)
    for i in range(b):
        r, col = divmod(i, ncols)
        out[r * (h + pad): r * (h + pad) + h, col * (w + pad): col * (w + pad) + w] = batch[i]
    return out


def diverging_colormap(x: np.ndarray) -> np.ndarray:
    """Values in [0,1] → a blue→white→red diverging RGB ramp (float [0,1]);
    0.5 is white, the ends saturated (the reference's ``cet_gwv_r`` role,
    vae_lpips_discr.py:223)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    t = (np.abs(x - 0.5) * 2.0).reshape(-1, 1)
    white = np.ones((1, 3), np.float32)
    cold = white + (np.array([[0.18, 0.33, 0.80]], np.float32) - white) * t
    warm = white + (np.array([[0.80, 0.20, 0.15]], np.float32) - white) * t
    return np.where((x >= 0.5).reshape(-1, 1), warm, cold).reshape(x.shape + (3,))


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1,1] or [0,1] HWC float → uint8 (array_to_pil's conversion): an
    image whose minimum is under -0.01 is taken as [-1, 1]; one channel
    becomes HxW."""
    x = np.asarray(x, np.float32)
    if x.min() < -0.01:
        x = denormalize(x)
    arr = (np.clip(x, 0, 1) * 255).round().astype(np.uint8)
    return arr[..., 0] if arr.shape[-1] == 1 else arr


def _rgb(image: np.ndarray) -> np.ndarray:
    image = image if image.dtype == np.uint8 else to_uint8(image)
    return np.repeat(image[..., None], 3, axis=-1) if image.ndim == 2 else image[..., :3]


def wrap_caption(text: str, max_width: int) -> list:
    """Greedy word wrap to a pixel width (utils/image/grid.py:71-90), at most
    4 lines; the last kept line ends in an ellipsis when lines were cut."""
    lines: list = []
    cur = ""
    for word in str(text).split():
        cand = f"{cur} {word}".strip()
        if font.text_length(cand, CAPTION_SIZE) <= max_width or not cur:
            cur = cand
        else:
            lines.append(cur)
            cur = word
    if cur:
        lines.append(cur)
    if len(lines) > 4:
        lines = lines[:4]
        lines[-1] += "…"
    return lines


def caption_grid(images: Sequence, captions: Optional[Sequence[str]] = None, cols: int = 2,
                 pad: int = 4) -> np.ndarray:
    """Captioned grid (utils/image/grid.py CaptionGrid parity) as a uint8
    array: cells of the largest image's size on a dark ground, captions
    word-wrapped to the cell width under each, the caption band as tall as
    the longest caption."""
    images = [_rgb(im) for im in images]
    n = len(images)
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    w = max(im.shape[1] for im in images)
    h = max(im.shape[0] for im in images)

    line_h = font.text_bbox("Ag", CAPTION_SIZE)[3] + 2
    wrapped = [wrap_caption(c, w - 4) for c in captions] if captions else []
    cap_h = (max((len(ls) for ls in wrapped), default=0) * line_h + 4) if captions else 0

    grid = np.empty((rows * (h + cap_h + pad) + pad, cols * (w + pad) + pad, 3), np.uint8)
    grid[:] = (24, 24, 24)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        x0 = pad + c * (w + pad)
        y0 = pad + r * (h + cap_h + pad)
        grid[y0:y0 + im.shape[0], x0:x0 + im.shape[1]] = im
        if captions and i < len(wrapped):
            for j, line in enumerate(wrapped[i][: max(1, cap_h // line_h)]):
                font.draw_text(grid, (x0 + 2, y0 + h + 2 + j * line_h), line, (230, 230, 230), CAPTION_SIZE)
    return grid


def stamp_label(image: np.ndarray, text: str) -> np.ndarray:
    """White text on a black box at the top left (utils/image/label.py:8-44), in place."""
    x0, y0, x1, y1 = font.text_bbox(text, CAPTION_SIZE)
    tw, th = x1 - x0, y1 - y0
    image[2:4 + th + 3, 2:4 + tw + 3] = 0  # Pillow's rectangle (2, 2)-(6 + tw, 6 + th) takes both corners
    font.draw_text(image, (4, 4), text, (255, 255, 255), CAPTION_SIZE)
    return image


def save_image_grid(images, path, captions=None, cols: int = 2, label: Optional[str] = None) -> Path:
    grid = caption_grid(images, captions, cols=cols)
    if label:
        grid = stamp_label(grid, label)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(path, grid)
    return path
