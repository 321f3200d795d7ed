"""Flat namespace alias: ``from epgpy_torch import epg`` (counterpart of
``epgpy_tpu/epg.py``, the reference's ``from epgpy import epg``).

Everything needed for scripting, over the names the port has.  Still to
come with their modules: ``Sequence``, ``Variable``, ``Constant``,
``Expression``, ``repeat`` (``sequence.py``, ROADMAP queue 1, item 2),
``rfpulse``/``RFPulse`` and ``load_pulse`` (item 3), ``ilt1d`` (item 10).
"""

from .statematrix import StateMatrix  # noqa: F401
from .ops import *  # noqa: F401,F403
from .engine import (  # noqa: F401
    simulate, simulate_simple, modify, flatten_sequence, squeeze_sequence,
    getshape, getnshift, getkdim, get_adc_times,
)
from .diff import Jacobian, Hessian, Pair, PartialsPruner  # noqa: F401
from .stats import crlb, crlb_split, confint  # noqa: F401
from . import (  # noqa: F401
    NAX, DiffOperator, check_states, cexp, progressbar,
)
from .utils import (  # noqa: F401
    gamma_1H, gamma_23Na, Axes, get_norm, get_wavenumber, spatial_range,
    space_to_freq, freq_to_space, saturation_rate, absorption_rate, dft,
)
from .utils.imaging import imaging  # noqa: F401
from . import config, stats  # noqa: F401
