"""Host-side helpers of epgpy_torch (counterpart of ``epgpy_tpu/utils``):
the physical constants, the conversion helpers and the
magnetization-transfer rates.  ``imaging``, ``ilt1d``, ``pulseio``,
``plotting`` and ``profiling`` are not ported yet (ROADMAP queue 1, item
5)."""

from . import constants, helpers, magnettransfer
from .constants import gamma_1H, gamma_23Na
from .helpers import (Axes, get_norm, get_wavenumber, spatial_range,
                      space_to_freq, freq_to_space, cexp, progressbar)
from .magnettransfer import absorption_rate, saturation_rate

__all__ = ["constants", "helpers", "magnettransfer", "gamma_1H",
           "gamma_23Na", "Axes", "get_norm", "get_wavenumber",
           "spatial_range", "space_to_freq", "freq_to_space", "cexp",
           "progressbar", "absorption_rate", "saturation_rate"]
