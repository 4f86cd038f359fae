"""Loss-selection enums (port of neurosis_tpu/losses/types.py; reference:
modules/losses/types.py:4-31)."""

from enum import Enum


class StrEnum(str, Enum):
    def __str__(self) -> str:  # so YAML round-trips cleanly
        return self.value


class PerceptualLoss(StrEnum):
    LPIPS = "lpips"
    DREAMSIM = "dreamsim"


class DreamsimVariant(StrEnum):
    ENSEMBLE = "ensemble"
    SINGLE = "single"


class GenericLoss(StrEnum):
    L1 = "l1"
    L2 = "l2"
    MSE = "mse"


class DiscriminatorLoss(StrEnum):
    HINGE = "hinge"
    VANILLA = "vanilla"


class DiffusionObjective(StrEnum):
    EDM = "edm"
    RF = "rf"
