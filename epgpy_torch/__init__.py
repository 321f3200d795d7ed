"""epgpy_torch -- Extended Phase Graph simulation in PyTorch and CUDA.

The PyTorch/CUDA port of ``epgpy_tpu`` (which stays the reference), under
the same names:

>>> import epgpy_torch as epg
>>> epg.config.set_device("cpu")          # default: cuda
>>> seq = [epg.T(90, 90)] + [epg.S(1), epg.T(150, 0), epg.S(1), epg.ADC] * 20
>>> signal = epg.simulate(epg.modify(seq, T2=[30, 40, 50]))

This port covers the operator core -- T/Tx/Ty/Phi/E/P/R/S/G/C/D/X, the
user classes ScalarOp and MatrixOp, CombinedOp (``combine``, ``@``), the
utility operators SPOILER, RESET, PD, System, Offset, NULL, callable and
expression probes (``"F0"``, ``"Z0"``), Adc (weights, reduce, phase) and
the imaging readouts DFT and Imaging -- with order1/order2 derivative
specs; the StateMatrix with its options and its coordinate table (float
and n-D shifts, Gao 2021's spatially resolved phase graph:
``ops/shiftnd.py``, ``ops/shiftdense.py``, ``simulate(kgrid=)``); the
general engine
(``simulate``: ``squeeze_sequence``, the scan planner of periodic blocks
with precomputed relaxation, run on the card as one memoized CUDA graph;
``callback``, ``init``, ``nstate``, ``equilibrium``, ``system``, ...);
Jacobian and Hessian probes (``diff.py``: forward-mode autodiff through
the operator loop); and the nineteen hand-written Hopper kernels
(``models/cuda_*.py``, ``csrc/*.cu``) that ``simulate()`` dispatches to on
CUDA in float32: the FISP dictionary (folded and full ladder), its
Jacobian and per-pulse Hessian, CPMG (DW-TSE included) and its Jacobian
and design tangents, bSSFP, DESS, multi-echo GRE, DW-FISP, composite
stage trains (MPRAGE, cardiac MRF) and the EPG-X GRE and composite
trains, each with its Jacobian.  Beside them: the FISP MR-fingerprinting
models, the steady-state sequences (``bssfp_sequence``, ``dess_sequence``,
``spgr_sequence``), CRLB statistics (``stats``), MRF serving and sequence
design (``parallel``: dictionary match, reconstruction, Gauss-Newton
refinement, CRLB designs of the MRF and TSE trains); the sequence DSL
(``sequence``: ``Sequence``, ``Variable``, ``repeat``, derivatives by
``torch.func.jvp``), shaped RF pulses and pulse files (``RFPulse``,
``load_pulse``) and slice-profile-corrected MRF dictionaries
(``models.slice_profile``); EPG-NNLS T2 spectra and myelin-water maps
(``parallel.t2spectrum``), streamed dictionary compression for
dictionary-free serving, the 1-D inverse Laplace transform (``ilt1d``),
traces (``utils.profiling``) and EPG diagrams (``utils.plotting``).
``epgpy_torch.epg`` (alias ``core``) is the
flat scripting namespace; the reference's submodule aliases
(``transition``, ``opscalar``, ``functions``, ...) are kept.
"""

import torch

from . import config, stats
from .statematrix import StateMatrix
from .ops import (
    Operator, EmptyOperator, MultiOperator, DiffOperator, CombinableOperator,
    Wait, Offset, Spoiler, Reset, PD, System, NULL, SPOILER, RESET,
    ScalarOp, MatrixOp, PrecomputedDiagonal, CombinedOp, combine,
    T, Tx, Ty, Phi, E, P, R, S, G, C, D, Probe, Adc, ADC, DFT, Imaging,
    X, exchange_matrix, RFPulse,
)
from .diff import Jacobian, Hessian, Pair, PartialsPruner
from .engine import (
    simulate, simulate_simple, modify, flatten_sequence, squeeze_sequence,
    getshape, getnshift, getkdim, get_adc_times,
)
from .sequence import Sequence, Variable, Constant, Expression, repeat
from . import sequence
from .models.ssfp import bssfp_sequence, dess_sequence, spgr_sequence
from .utils import (
    gamma_1H, gamma_23Na, Axes, get_norm, get_wavenumber, spatial_range,
    space_to_freq, freq_to_space, saturation_rate, absorption_rate, dft,
    load_pulse,
)
from .utils.helpers import cexp, progressbar
from .utils.imaging import imaging
from .utils.ilt1d import ilt1d

# the reference's flat submodule aliases (``from epgpy import transition``),
# mapped onto the ops package as in epgpy_tpu/__init__.py
from .ops import (
    base as operator, scalarop as opscalar, matrixop as opmatrix,
    transition, evolution, shift, diffusion, exchange, probe, rfpulse,
)
from . import statematrix, common, engine as functions
# ``from epgpy import operators``: the ops package is the combined
# operator namespace
from . import ops as operators

#: reference epgpy/utils.py:5 -- np.newaxis alias used in probe expressions
NAX = None


def check_states(states):
    """Ladder conjugate-symmetry check (reference epgpy/utils.py:118-121)."""
    import numpy as _np
    if hasattr(states, "detach"):
        states = states.detach().cpu().numpy()
    states = _np.asarray(states)
    return bool(_np.allclose(states,
                             states[..., ::-1, :][..., (1, 0, 2)].conj()))


def set_array_module(xp=None):
    """API-compatibility shim: the port has one array module, torch.

    The reference switches numpy/cupy globally (epgpy/common.py:21-50);
    here the request is accepted and ignored -- the device is set with
    ``config.set_device``."""
    return torch


def get_array_module(*objs):
    """API-compatibility shim: always torch (see set_array_module)."""
    return torch


__all__ = [
    "config", "stats", "StateMatrix", "Operator", "EmptyOperator",
    "MultiOperator", "DiffOperator", "CombinableOperator", "Wait", "Offset",
    "Spoiler", "Reset", "PD", "System", "NULL", "SPOILER", "RESET",
    "ScalarOp", "MatrixOp", "PrecomputedDiagonal", "CombinedOp", "combine",
    "T", "Tx", "Ty", "Phi", "E", "P", "R", "S", "G", "C", "D", "Probe",
    "Adc", "ADC", "DFT", "Imaging", "X", "exchange_matrix", "Jacobian",
    "Hessian", "Pair", "PartialsPruner", "simulate", "simulate_simple",
    "modify", "flatten_sequence", "squeeze_sequence", "getshape",
    "getnshift", "getkdim", "get_adc_times", "bssfp_sequence",
    "dess_sequence", "spgr_sequence", "gamma_1H", "gamma_23Na", "Axes",
    "get_norm", "get_wavenumber", "spatial_range", "space_to_freq",
    "freq_to_space", "saturation_rate", "absorption_rate", "dft", "imaging",
    "ilt1d", "cexp",
    "progressbar", "NAX", "check_states", "epg", "RFPulse", "Sequence",
    "Variable", "Constant", "Expression", "repeat", "sequence",
    "load_pulse", "operator", "opscalar", "opmatrix", "transition",
    "evolution", "shift", "diffusion", "exchange", "probe", "rfpulse",
    "statematrix", "common", "functions", "operators", "core",
    "set_array_module", "get_array_module",
]

from . import epg  # noqa: E402  (after the names it re-exports)
from . import epg as core  # noqa: E402  (reference epgpy/core.py)

__version__ = "0.1.0"
