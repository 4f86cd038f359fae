"""Render the glyph atlas the port draws text with (``utils/font.py``).

    python -m neurosis_tpu_torch.tools.render_glyph_atlas

Needs Pillow (the one place in the port that does); the card's machine has
none, so the atlas is rendered once and committed. Pillow's FreeType
renderer draws each glyph of a line at a whole pixel, ``round(pen)``, with
the pen advancing by the font's unhinted advance in 1/64 px; so a line is
its glyphs' bitmaps placed side by side, and the atlas keeps one bitmap a
glyph of ``neurosis_tpu_torch/assets/fonts/NotoSansMono.ttf`` at each size
the image utilities use (12 for captions and labels, 10 for
``log_txt_as_img``): printable ASCII, the ellipsis that ends a cut caption,
and the font's missing-glyph box for every other character. It checks the
atlas against Pillow on sample lines before writing it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ASSETS = Path(__file__).resolve().parents[1] / "assets" / "fonts"
FONT = ASSETS / "NotoSansMono.ttf"
OUT = ASSETS / "noto_sans_mono_atlas.npz"
SIZES = (10, 12)
CHARS = "".join(chr(c) for c in range(32, 127)) + "…"
MISSING = "一"  # a character the font lacks: Pillow draws its missing-glyph box
PAD = 4  # the glyph's origin inside its cell, room for negative bearings


def render(size: int) -> dict:
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(str(FONT), size)
    advance = round(font.getlength("M") * 64)
    if any(round(font.getlength(ch) * 64) != advance for ch in CHARS + MISSING):
        raise ValueError(f"{FONT.name} at {size} px is not monospace")
    cell = (2 * size + 2 * PAD, (advance + 63) // 64 + 2 * PAD)
    cells, boxes = [], []
    for ch in CHARS + MISSING:
        im = Image.new("L", cell[::-1], 0)
        ImageDraw.Draw(im).text((PAD, PAD), ch, fill=255, font=font)
        cells.append(np.asarray(im))
        boxes.append(font.getbbox(ch))
    return {f"cells_{size}": np.stack(cells), f"bbox_{size}": np.asarray(boxes, np.int32),
            f"advance_{size}": np.int32(advance)}


def check() -> None:
    """The port's drawing equals Pillow's on sample lines and grids."""
    from PIL import Image, ImageDraw, ImageFont

    from ..utils import font as port_font

    port_font.load_atlas.cache_clear()
    samples = ["step 12", "a photograph of an astronaut riding a horse", "-0.53  1.25", "tag0, x_y {j}|~",
               "caption with 一 and …"]
    for size in SIZES:
        font = ImageFont.truetype(str(FONT), size)
        for text in samples + ["two\nlines of\ntext"]:
            want = Image.new("RGB", (400, 60), (24, 24, 24))
            ImageDraw.Draw(want).text((3, 5), text, fill=(230, 230, 230), font=font)
            got = np.full((60, 400, 3), 24, np.uint8)
            port_font.draw_text(got, (3, 5), text, (230, 230, 230), size)
            diff = int(np.abs(got.astype(int) - np.asarray(want).astype(int)).max())
            bbox_ok = "\n" in text or port_font.text_bbox(text, size) == font.getbbox(text)
            if diff or not bbox_ok:
                raise AssertionError(f"size {size} {text!r}: max pixel difference {diff}, bbox "
                                     f"{port_font.text_bbox(text, size)} against {font.getbbox(text)}")


def main() -> int:
    atlas = {"chars": np.array(CHARS), "pad": np.int32(PAD)}
    for size in SIZES:
        atlas.update(render(size))
    np.savez_compressed(OUT, **atlas)
    check()
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes), checked against Pillow")
    return 0


if __name__ == "__main__":
    sys.exit(main())
