"""The DataTransform ABC (port of neurosis_tpu/data/processing/transform.py;
parity: dataset/processing/transform.py:10-36): the type of a Mongo
dataset's ``data_transforms``."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Sequence


class DataTransform(ABC):
    """A named transform from a sample's input keys to its output keys; it
    sees the sample and the raw metadata row it came from."""

    def __init__(self, name: str, input_keys: Sequence[str], output_keys: Optional[Sequence[str]] = None):
        self.name = name
        self.input_keys = list(input_keys)
        self.output_keys = list(output_keys) if output_keys is not None else list(input_keys)

    @abstractmethod
    def __call__(self, sample: dict, raw: Optional[dict] = None) -> dict:
        ...

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(name={self.name!r}, in={self.input_keys}, out={self.output_keys})"
