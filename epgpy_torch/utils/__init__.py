"""Helpers of epgpy_torch (counterpart of ``epgpy_tpu/utils``): the
physical constants, the conversion helpers, the magnetization-transfer
rates, the imaging readouts (``imaging.imaging``, ``dft``), the pulse
files (``pulseio``: ``.pta`` waveforms as ``ops.rfpulse.RFPulse``), the
1-D inverse Laplace transform (``ilt1d``), traces (``profiling``) and EPG
diagrams (``plotting``, matplotlib imported on use).  As in JAX, the
``imaging`` and ``ilt1d`` functions are not re-exported here: they would
shadow their modules (the package's top level has both)."""

from . import (constants, helpers, ilt1d, imaging, magnettransfer, plotting,
               profiling, pulseio)
from .constants import gamma_1H, gamma_23Na
from .helpers import (Axes, get_norm, get_wavenumber, spatial_range,
                      space_to_freq, freq_to_space, cexp, progressbar)
from .imaging import dft
from .magnettransfer import absorption_rate, saturation_rate
from .pulseio import load_pulse, read_pulse, resample_pulse
from .ilt1d import ilt1d_ls, flt1d, ilt1d_crb, quasi_continuous

__all__ = ["constants", "helpers", "imaging", "magnettransfer", "pulseio",
           "dft", "gamma_1H",
           "gamma_23Na", "Axes", "get_norm", "get_wavenumber",
           "spatial_range", "space_to_freq", "freq_to_space", "cexp",
           "progressbar", "absorption_rate", "saturation_rate",
           "load_pulse", "read_pulse", "resample_pulse", "ilt1d", "plotting",
           "profiling", "flt1d", "ilt1d_ls", "ilt1d_crb",
           "quasi_continuous"]
