"""Bicubic resizes as separable matmuls (port of neurosis_tpu/ops/resize.py).

Two filters, each a pair of (out, in) weight matrices built on the host with
numpy from the static (in size, out size, options) tuple and cached; the
resize itself is two ``torch.matmul``s over NHWC images, rows then columns:

- ``bicubic_resize``: ATen's ``interpolate(mode='bicubic')`` (the CLIP image
  embedder's kornia resize, the ViTs' position-embedding interpolation):
  a = -0.75 on the plain path, the antialiased path's a = -0.5 filter widened
  by the scale on downscale, ``align_corners`` and the ``scales=`` override
  of ``F.interpolate(scale_factor=...)``. It computes in fp32 and returns the
  input's dtype.
- ``jax_image_resize``: ``jax.image.resize(..., "bicubic", antialias=...)``
  (what DreamSim resizes its pairs with): Keys' cubic at a = -0.5 on
  half-pixel centres, the kernel widened by max(in/out, 1) when it
  downsamples, each output's weights divided by their sum (0 where the sum
  is tiny), zero where the sample falls outside the input. Like JAX it casts
  the weights to the image's dtype and computes in it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_A = -0.75  # ATen's bicubic coefficient


def _cubic(x: np.ndarray, a: float = _A) -> np.ndarray:
    """Keys cubic convolution kernel."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _pixel_scale(in_size: int, out_size: int, align_corners: bool) -> float:
    """ATen area_pixel_compute_scale."""
    if align_corners:
        return (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    return in_size / out_size


@lru_cache(maxsize=64)
def aten_weight_matrix(in_size: int, out_size: int, align_corners: bool, antialias: bool,
                       scale_override: float = 0.0) -> np.ndarray:
    """(out_size, in_size) fp32 interpolation matrix of ATen's UpSampleKernel:
    the antialiased path (kernel support widened by the scale on downscale,
    weights renormalised) or the plain 4-tap cubic at the source coordinate,
    edge-clamped. ``scale_override`` > 0 maps coordinates with it, as
    ``F.interpolate(scale_factor=s)`` maps them with 1/s."""
    scale = scale_override if scale_override > 0 else _pixel_scale(in_size, out_size, align_corners)
    w = np.zeros((out_size, in_size), np.float64)
    if antialias:
        support = 2.0 * scale if scale > 1.0 else 2.0
        invscale = 1.0 / scale if scale > 1.0 else 1.0
        for i in range(out_size):
            center = scale * (i + 0.5)
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            js = np.arange(xmin, xmax)
            row = _cubic((js + 0.5 - center) * invscale, a=-0.5)
            s = row.sum()
            w[i, xmin:xmax] = row / s if s != 0 else row
        return w.astype(np.float32)
    for i in range(out_size):
        real = scale * i if align_corners else scale * (i + 0.5) - 0.5
        in_i = int(np.floor(real))
        t = real - in_i
        idx = np.clip(np.arange(in_i - 1, in_i + 3), 0, in_size - 1)
        for j, wj in zip(idx, _cubic(np.array([1.0 + t, t, 1.0 - t, 2.0 - t]))):
            w[i, j] += wj
    return w.astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """jax.image's ``_fill_keys_cubic_kernel`` (a = -0.5) on |x|, in x's dtype."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


@lru_cache(maxsize=64)
def jax_weight_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """(out_size, in_size) matrix of jax.image's ``compute_weight_mat`` for
    the cubic kernel at scale out/in and no translation, in fp32 as JAX
    forms it."""
    f32 = np.float32
    scale = f32(out_size / in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _keys_cubic(x.astype(f32))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0))
    return np.ascontiguousarray(weights.T.astype(f32))


_DEVICE_CACHE: dict = {}


def _on(mat: np.ndarray, key: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The host matrix as a tensor on ``device`` in ``dtype``, made once."""
    full = key + (str(device), dtype)
    if full not in _DEVICE_CACHE:
        _DEVICE_CACHE[full] = torch.from_numpy(mat).to(device=device, dtype=dtype)
    return _DEVICE_CACHE[full]


def _separable(x: torch.Tensor, wh, ww) -> torch.Tensor:
    """NHWC x through ``wh`` [out_h, H] (rows) then ``ww`` [out_w, W]
    (columns), one matmul each; None skips an axis."""
    if wh is not None:
        b, _, w, c = x.shape
        x = torch.matmul(wh, x.reshape(b, x.shape[1], w * c)).reshape(b, wh.shape[0], w, c)
    if ww is not None:
        x = torch.matmul(ww, x)  # [out_w, W] @ [B, H, W, C] -> [B, H, out_w, C]
    return x


def bicubic_resize(x: torch.Tensor, size: tuple, align_corners: bool = False, antialias: bool = True,
                   scales: tuple = (0.0, 0.0)) -> torch.Tensor:
    """Resize NHWC (or HWC) images to ``size=(H, W)`` with ATen's
    ``interpolate(mode='bicubic')`` semantics, in fp32; returns x's dtype.
    ``scales=(1/sf_h, 1/sf_w)`` overrides the coordinate-mapping scale
    (0 = from the sizes)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    out_h, out_w = int(size[0]), int(size[1])
    f32 = torch.float32

    def mat(n_in, n_out, scale):
        key = ("aten", n_in, n_out, align_corners, antialias, float(scale))
        return _on(aten_weight_matrix(n_in, n_out, align_corners, antialias, float(scale)), key, x.device, f32)

    out = _separable(x.to(f32), mat(h, out_h, scales[0]) if h != out_h else None,
                     mat(w, out_w, scales[1]) if w != out_w else None).to(x.dtype)
    return out[0] if squeeze else out


def jax_image_resize(x: torch.Tensor, size: tuple, antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, (B, H, W, C), "bicubic", antialias)`` of NHWC x
    to ``size=(H, W)``: the weights in x's dtype, each axis's product
    rounded to it."""
    _, h, w, _ = x.shape
    out_h, out_w = int(size[0]), int(size[1])

    def mat(n_in, n_out):
        return _on(jax_weight_matrix(n_in, n_out, antialias), ("jax", n_in, n_out, antialias), x.device, x.dtype)

    return _separable(x, mat(h, out_h) if h != out_h else None, mat(w, out_w) if w != out_w else None)
