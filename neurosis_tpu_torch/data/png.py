"""8-bit PNG reading and writing with zlib and struct, the port's stand-in
for Pillow's PNG codec (the card's machine has no Pillow).

Read: non-interlaced 8-bit greyscale (L), greyscale + alpha (LA), RGB and
RGBA, every filter type (0-4), and the tRNS transparency key of L and RGB.
Palette, 16-bit and low-bit-depth images and interlaced images raise.
Write: the same four modes, one filter type for every row.

Arrays are uint8, HxW for L and HxWxC otherwise, as ``np.asarray`` of a
Pillow image gives them.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
_MODES = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind.decode('latin-1')} chunk")
        yield kind, body
        pos += 12 + length
    raise ValueError(f"{path}: the PNG ends without an IEND chunk")


def _header(body: bytes, path) -> tuple[int, int, int]:
    width, height, depth, colour, _compression, _filter, interlace = struct.unpack(">IIBBBBB", body)
    if colour == 3:
        raise ValueError(f"{path}: palette PNGs are not read here")
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour} is not valid")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not read here (8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read here")
    return width, height, colour


def read_size(path) -> tuple[int, int]:
    """(width, height) from the IHDR chunk, without decoding."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    return struct.unpack(">II", head[16:24])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filters: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Reconstruct [H, W, C] samples from their filtered bytes. Rows of types
    0-2 go row by row; with Avg or Paeth rows, whose left neighbour is
    reconstructed in the same row, the pixels go by anti-diagonals (each
    needs its left, upper and upper-left neighbours only)."""
    h, w, _ = data.shape
    out = np.zeros((h + 1, w + 1, data.shape[2]), np.int32)  # a zero row above, a zero column left
    x = data.astype(np.int32)
    if np.all(filters <= 2):
        for r, t in enumerate(filters):
            if t == 0:
                out[r + 1, 1:] = x[r]
            elif t == 1:
                out[r + 1, 1:] = np.cumsum(x[r], axis=0) & 255
            else:
                out[r + 1, 1:] = (x[r] + out[r, 1:]) & 255
        return out[1:, 1:].astype(np.uint8)
    f = filters.astype(np.int32)
    for d in range(h + w - 1):
        rows = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        cols = d - rows
        a, b, c = out[rows + 1, cols], out[rows, cols + 1], out[rows, cols]
        t = f[rows][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[rows + 1, cols + 1] = (x[rows, cols] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> tuple[np.ndarray, str, Optional[Union[int, tuple]]]:
    """(pixels, mode, transparency) of an 8-bit PNG: mode 'L', 'LA', 'RGB' or
    'RGBA'; transparency is the tRNS key (an int for L, an (r, g, b) tuple
    for RGB) or None."""
    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    header = None
    idat = []
    transparency = None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = _header(body, path)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS" and header is not None:
            if header[2] == 0:
                (transparency,) = struct.unpack(">H", body[:2])
            elif header[2] == 2:
                transparency = struct.unpack(">HHH", body[:6])
            else:
                raise ValueError(f"{path}: a tRNS chunk in an image with alpha")
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, colour = header
    ch = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 1 + width * ch
    if raw.size != height * stride:
        raise ValueError(f"{path}: {raw.size} bytes of image data, not {height * stride}")
    raw = raw.reshape(height, stride)
    filters = raw[:, 0]
    if np.any(filters > 4):
        raise ValueError(f"{path}: PNG filter type {int(filters.max())} is not valid")
    pixels = _unfilter(filters, raw[:, 1:].reshape(height, width, ch))
    return (pixels[..., 0] if ch == 1 else pixels), _MODES[colour], transparency


def _filter_rows(x: np.ndarray, filter_type: int) -> np.ndarray:
    """The filtered bytes of every row of [H, W, C] samples under one filter type."""
    x = x.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)][filter_type]
    return ((x - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, pixels: np.ndarray, filter_type: int = 1, level: int = 6) -> None:
    """Write uint8 pixels (HxW, or HxWxC with C = 1, 2, 3, 4) as an 8-bit
    PNG, every row under ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth)."""
    x = np.asarray(pixels)
    if x.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {x.dtype}")
    if x.ndim == 2:
        x = x[..., None]
    if x.ndim != 3 or x.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"PNG pixels must be HxW or HxWxC with C in 1-4, got {x.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type must be 0-4, got {filter_type}")
    h, w, ch = x.shape
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), _filter_rows(x, filter_type).reshape(h, -1)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    Path(path).write_bytes(SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
