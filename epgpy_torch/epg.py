"""Flat namespace alias: ``from epgpy_torch import epg`` (counterpart of
``epgpy_tpu/epg.py``, the reference's ``from epgpy import epg``; the
package also exposes it as ``core``).

Everything needed for scripting, over the names the port has.
"""

from .statematrix import StateMatrix  # noqa: F401
from .ops import *  # noqa: F401,F403
from .engine import (  # noqa: F401
    simulate, simulate_simple, modify, flatten_sequence, squeeze_sequence,
    getshape, getnshift, getkdim, get_adc_times,
)
from .diff import Jacobian, Hessian, Pair, PartialsPruner  # noqa: F401
from .sequence import (  # noqa: F401
    Sequence, Variable, Constant, Expression, repeat, operators, functions,
)
from .stats import crlb, crlb_split, confint  # noqa: F401
from . import (  # noqa: F401  (reference submodule aliases)
    operator, opscalar, opmatrix, transition, evolution, shift,
    diffusion, exchange, probe, rfpulse, statematrix, common, functions,
)
from . import (  # noqa: F401
    NAX, DiffOperator, check_states, set_array_module, get_array_module,
    cexp, progressbar,
)
from .utils import (  # noqa: F401
    gamma_1H, gamma_23Na, Axes, get_norm, get_wavenumber, spatial_range,
    space_to_freq, freq_to_space, saturation_rate, absorption_rate, dft,
    load_pulse,
)
from .utils.imaging import imaging  # noqa: F401
from .utils.ilt1d import ilt1d  # noqa: F401
from . import config, stats  # noqa: F401
