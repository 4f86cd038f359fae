"""Sample processing of the PyTorch port (port of neurosis_tpu/data/processing;
its caption helpers have no caller in the port and are not ported)."""

from .transform import DataTransform

__all__ = ["DataTransform"]
