"""Image dequantization (port of neurosis_tpu/ops/dequant.py).

Batches may stay uint8 up to the device (1 byte per pixel and channel on the
copy) and are mapped to [-1, 1] there, as x·(2/255) − 1.
"""

from __future__ import annotations

import torch


def dequant_image(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 images → [-1, 1] in ``dtype``; float inputs pass through."""
    if x.dtype == torch.uint8:
        return x.to(dtype) * torch.tensor(2.0 / 255.0, dtype=dtype) - torch.tensor(1.0, dtype=dtype)
    return x
