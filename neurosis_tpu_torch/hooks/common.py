"""LossHook base (port of neurosis_tpu/hooks/common.py; parity:
modules/hooks/common.py:11-51).

Hooks run on the host around the train step: ``pre_hook`` may add numeric
entries to the host batch (a per-sample ``loss_scale`` the loss multiplies
in), ``batch_hook`` rewrites the logged loss and metrics after the step.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional


class LossHook(ABC):
    def __init__(self, name: Optional[str] = None, **kwargs):
        self.name = name or self.__class__.__name__

    def pre_hook(self, trainer, engine, batch: dict, batch_idx: int) -> dict:
        """Before the step: may return an amended copy of the host batch."""
        return batch

    @abstractmethod
    def batch_hook(self, engine, batch: dict, loss, loss_dict: dict) -> tuple:
        """After the step: the (loss, loss_dict) to log."""
        raise NotImplementedError

    def __call__(self, engine, batch, loss, loss_dict=None, **kwargs):
        return self.batch_hook(engine, batch, loss, loss_dict or {}, **kwargs)
