"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point builds on: CUDA unless the caller asks for
    another one. Raises instead of quietly running on the CPU when CUDA is
    absent, so a run on the card never degrades to a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels' wave size)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
