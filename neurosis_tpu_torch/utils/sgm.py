"""sgm-heritage utilities (port of neurosis_tpu/utils/sgm.py, log_txt_as_img)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import font


def log_txt_as_img(wh: tuple, xc: Sequence[str], size: int = 10) -> np.ndarray:
    """Captions drawn in black on white images of ``wh`` = (W, H), cut into
    lines of 40 characters per 256 px of width (utils/sgm.py:14-33), in the
    port's font at ``size``. Returns [B, H, W, 3] float32 in [-1, 1]."""
    out = []
    nc = max(int(40 * (wh[0] / 256)), 1)
    for text in xc:
        text = str(text)
        img = np.full((wh[1], wh[0], 3), 255, np.uint8)
        font.draw_text(img, (0, 0), "\n".join(text[i:i + nc] for i in range(0, len(text), nc)), (0, 0, 0), size)
        out.append(img.astype(np.float32) / 127.5 - 1.0)
    return np.stack(out)
