"""Helpers of epgpy_torch (counterpart of ``epgpy_tpu/utils``): the
physical constants, the conversion helpers, the magnetization-transfer
rates, the imaging readouts (``imaging.imaging``, ``dft``) and the pulse
files (``pulseio``: ``.pta`` waveforms as ``ops.rfpulse.RFPulse``).
``ilt1d``, ``plotting`` and ``profiling`` are not ported yet (ROADMAP
queue 1).  As in JAX, the ``imaging`` function is not re-exported here:
it would shadow its module."""

from . import constants, helpers, imaging, magnettransfer, pulseio
from .constants import gamma_1H, gamma_23Na
from .helpers import (Axes, get_norm, get_wavenumber, spatial_range,
                      space_to_freq, freq_to_space, cexp, progressbar)
from .imaging import dft
from .magnettransfer import absorption_rate, saturation_rate
from .pulseio import load_pulse, read_pulse, resample_pulse

__all__ = ["constants", "helpers", "imaging", "magnettransfer", "pulseio",
           "dft", "gamma_1H",
           "gamma_23Na", "Axes", "get_norm", "get_wavenumber",
           "spatial_range", "space_to_freq", "freq_to_space", "cexp",
           "progressbar", "absorption_rate", "saturation_rate",
           "load_pulse", "read_pulse", "resample_pulse"]
