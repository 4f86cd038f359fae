"""A small reader and writer of the safetensors format (the card's machine
has no ``safetensors`` package): an 8-byte little-endian header length, a
JSON header of {name: {dtype, shape, data_offsets}}, then the raw buffers."""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64, "I64": np.int64, "I32": np.int32,
           "U8": np.uint8}


def load_file(path) -> dict[str, torch.Tensor]:
    """{name: CPU tensor} of a .safetensors file."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    body = memoryview(raw)[8 + n:]  # slices of it are views: each tensor is copied once, below
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, which this reader does not take")
        start, end = meta["data_offsets"]
        arr = np.frombuffer(body[start:end], dtype=np.dtype(_DTYPES[meta["dtype"]]).newbyteorder("<"))
        out[name] = torch.from_numpy(arr.reshape(meta["shape"]).astype(arr.dtype.newbyteorder("="), copy=True))
    return out


_NAMES = {np.dtype(v).newbyteorder("<"): k for k, v in _DTYPES.items()}


def save_file(tensors: dict, path, metadata: dict = None) -> None:
    """Write {name: tensor or array} as a .safetensors file (little-endian
    buffers in name order, the header padded to 8 bytes)."""
    header, arrays, offset = {}, [], 0
    for name in sorted(tensors):
        value = tensors[name]
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        arr = np.asarray(arr, dtype=arr.dtype.newbyteorder("<"), order="C")
        if arr.dtype not in _NAMES:
            raise ValueError(f"{name} has dtype {arr.dtype}, which this writer does not take")
        header[name] = {"dtype": _NAMES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:  # each buffer written as it is, not joined into one copy
        f.write(struct.pack("<Q", len(head)) + head)
        for arr in arrays:
            f.write(arr.reshape(-1).view(np.uint8).data)
