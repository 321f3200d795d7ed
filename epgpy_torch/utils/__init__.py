"""Host-side helpers of epgpy_torch (counterpart of ``epgpy_tpu/utils``):
the physical constants and the magnetization-transfer rates."""

from . import constants, magnettransfer
from .magnettransfer import absorption_rate, saturation_rate

__all__ = ["constants", "magnettransfer", "absorption_rate",
           "saturation_rate"]
