"""Text drawing without Pillow, from a glyph atlas of the port's monospace
font (``assets/fonts/noto_sans_mono_atlas.npz``, rendered from
``assets/fonts/NotoSansMono.ttf`` by ``tools/render_glyph_atlas.py``).

Draws as Pillow's ``ImageDraw.text`` does with that font at the atlas's
sizes (12 and 10 px): the pen starts at the anchor's left ascender point and
advances by the font's advance in 1/64 px; each glyph's bitmap lands at the
pen rounded to a whole pixel, overlapping bitmaps combine as a + b − ab/255,
and the mask blends the fill into the image with Pillow's rounding. Lines of
a text with newlines are ``bbox('A').bottom + 4`` apart. Characters
outside printable ASCII and the ellipsis draw the font's missing-glyph box.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np

ATLAS = Path(__file__).resolve().parents[1] / "assets" / "fonts" / "noto_sans_mono_atlas.npz"


@functools.lru_cache(maxsize=None)
def load_atlas() -> dict:
    with np.load(ATLAS) as f:
        atlas = {k: f[k] for k in f.files}
    chars = str(atlas.pop("chars"))
    atlas["index"] = {ch: i for i, ch in enumerate(chars)}
    atlas["missing"] = len(chars)
    return atlas


def _glyphs(text: str, size: int) -> list:
    atlas = load_atlas()
    if f"cells_{size}" not in atlas:
        raise ValueError(f"the glyph atlas has no {size} px font (sizes: "
                         f"{sorted(int(k[6:]) for k in atlas if k.startswith('cells_'))})")
    return [atlas["index"].get(ch, atlas["missing"]) for ch in text]


def advance(size: int) -> float:
    """The width every glyph advances the pen by, in pixels."""
    return int(load_atlas()[f"advance_{size}"]) / 64.0


def text_length(text: str, size: int) -> float:
    """``ImageDraw.textlength`` of one line: glyphs × advance."""
    return len(text) * advance(size)


def _pixel(pen_64: int) -> int:
    return (pen_64 + 32) >> 6


def text_bbox(text: str, size: int) -> tuple:
    """``ImageFont.getbbox`` of one line drawn at (0, 0): the union of its
    glyphs' ink boxes, at least as wide as the pen's travel."""
    atlas = load_atlas()
    adv, boxes = int(atlas[f"advance_{size}"]), atlas[f"bbox_{size}"]
    left, top, right, bottom = 0, math.inf, _pixel(len(text) * adv), -math.inf
    for i, g in enumerate(_glyphs(text, size)):
        x0, y0, x1, y1 = (int(v) for v in boxes[g])
        if x1 <= x0 or y1 <= y0:  # no ink (a space)
            continue
        px = _pixel(i * adv)
        left, right = min(left, px + x0), max(right, px + x1)
        top, bottom = min(top, y0), max(bottom, y1)
    if top is math.inf:
        top = bottom = 0
    return (left, top, right, bottom)


def line_spacing(size: int) -> int:
    """Rows between the lines of a text: Pillow's bbox('A').bottom + its default spacing, 4."""
    return text_bbox("A", size)[3] + 4


def text_mask(text: str, size: int, start: float = 0.0) -> np.ndarray:
    """uint8 coverage of one line, its origin at (pad, pad) of the returned
    array; ``start`` is the pen's fractional offset."""
    atlas = load_atlas()
    cells, pad = atlas[f"cells_{size}"], int(atlas["pad"])
    adv, s64 = int(atlas[f"advance_{size}"]), round(start * 64)
    glyphs = _glyphs(text, size)
    h, w = cells.shape[1:]
    mask = np.zeros((h, _pixel(s64 + len(glyphs) * adv) + w), np.int32)
    for i, g in enumerate(glyphs):
        px = _pixel(s64 + i * adv)
        under, cell = mask[:, px:px + w], cells[g].astype(np.int32)
        mask[:, px:px + w] = under + cell - (under * cell + 127) // 255
    return mask.astype(np.uint8)


def blend(image: np.ndarray, mask: np.ndarray, xy: tuple, fill) -> None:
    """Paste ``fill`` through ``mask`` at ``xy`` (top-left, may hang over
    the edges) into the uint8 HxWx3 ``image`` in place, rounding as Pillow's
    paste with a mask does: (in·(255 − m) + fill·m) / 255."""
    x, y = xy
    h, w = mask.shape
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + h, image.shape[0]), min(x + w, image.shape[1])
    if y1 <= y0 or x1 <= x0:
        return
    m = mask[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.int32)[..., None]
    region = image[y0:y1, x0:x1].astype(np.int32)
    a = region * (255 - m) + np.asarray(fill, np.int32) * m + 128
    image[y0:y1, x0:x1] = ((a >> 8) + a) >> 8


def draw_text(image: np.ndarray, xy: tuple, text: str, fill, size: int) -> None:
    """``ImageDraw.text(xy, text, fill, font)`` into a uint8 HxWx3 array in place."""
    pad = int(load_atlas()["pad"])
    x, y = xy
    xi, yi = math.floor(x), math.floor(y)
    for j, line in enumerate(text.split("\n")):
        mask = text_mask(line, size, start=x - xi)
        blend(image, mask, (xi - pad, yi - pad + j * line_spacing(size)), fill)
