"""epgpy_torch -- Extended Phase Graph simulation in PyTorch and CUDA.

The PyTorch/CUDA port of ``epgpy_tpu`` (which stays the reference), under
the same names:

>>> import epgpy_torch as epg
>>> epg.config.set_device("cpu")          # default: cuda
>>> seq = [epg.T(90, 90)] + [epg.S(1), epg.T(150, 0), epg.S(1), epg.ADC] * 20
>>> signal = epg.simulate(epg.modify(seq, T2=[30, 40, 50]))

This port covers the operators T/E/P/R/S(int)/ADC with order1/order2
derivative specs, the StateMatrix, the eager general engine, Jacobian and
Hessian probes (``diff.py``: forward-mode autodiff through the operator
loop), the FISP MR-fingerprinting models, the fused FISP dictionary
(folded and full ladder), Jacobian and per-pulse Hessian kernels, the
CPMG, balanced-SSFP, DESS and multi-echo GRE dictionary and Jacobian
kernels for the H100 (``models/cuda_*.py``, ``csrc/*.cu``), which
``simulate()`` dispatches to on CUDA in float32 (DW-FISP trains through
the FISP kernels' diffusion attenuation),
the steady-state sequences (``bssfp_sequence``, ``dess_sequence``,
``spgr_sequence``), CRLB statistics (``stats``), MRF serving and sequence
design (``parallel``: dictionary match, reconstruction, Gauss-Newton
refinement, CRLB design of the MRF train).
"""

from . import config, stats
from .statematrix import StateMatrix
from .ops import (
    Operator, EmptyOperator, MultiOperator, DiffOperator, Wait,
    T, Tx, Ty, Phi, E, P, R, S, G, C, D, Probe, Adc, ADC, DFT, Imaging,
    X, exchange_matrix,
)
from .diff import Jacobian, Hessian, PartialsPruner
from .engine import (
    simulate, simulate_simple, modify, flatten_sequence, getshape,
    getnshift, get_adc_times,
)
from .models.ssfp import bssfp_sequence, dess_sequence, spgr_sequence

__all__ = [
    "config", "StateMatrix", "Operator", "EmptyOperator", "MultiOperator",
    "DiffOperator", "Wait", "T", "Tx", "Ty", "Phi", "E", "P", "R", "S", "G",
    "C", "D", "Probe", "Adc", "ADC", "DFT", "Imaging", "X", "exchange_matrix",
    "Jacobian", "Hessian",
    "PartialsPruner", "simulate", "simulate_simple",
    "modify", "flatten_sequence", "getshape", "getnshift", "get_adc_times",
    "bssfp_sequence", "dess_sequence", "spgr_sequence",
]

__version__ = "0.1.0"
