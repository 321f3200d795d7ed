"""epgpy_torch -- Extended Phase Graph simulation in PyTorch and CUDA.

The PyTorch/CUDA port of ``epgpy_tpu`` (which stays the reference), under
the same names:

>>> import epgpy_torch as epg
>>> epg.config.set_device("cpu")          # default: cuda
>>> seq = [epg.T(90, 90)] + [epg.S(1), epg.T(150, 0), epg.S(1), epg.ADC] * 20
>>> signal = epg.simulate(epg.modify(seq, T2=[30, 40, 50]))

This slice covers the operators T/E/P/S(int)/ADC, the StateMatrix, the
eager general engine, the FISP MR-fingerprinting models and the fused FISP
dictionary kernel for the H100 (``models/cuda_fisp.py``,
``csrc/fisp_half.cu``), which ``simulate()`` dispatches to for exact FISP
trains on CUDA in float32.
"""

from . import config
from .statematrix import StateMatrix
from .ops import (
    Operator, EmptyOperator, MultiOperator, DiffOperator, Wait,
    T, Tx, Ty, Phi, E, P, S, G, C, Probe, Adc, ADC, DFT, Imaging,
)
from .engine import (
    simulate, simulate_simple, modify, flatten_sequence, getshape,
    getnshift, get_adc_times,
)

__all__ = [
    "config", "StateMatrix", "Operator", "EmptyOperator", "MultiOperator",
    "DiffOperator", "Wait", "T", "Tx", "Ty", "Phi", "E", "P", "S", "G", "C",
    "Probe", "Adc", "ADC", "DFT", "Imaging", "simulate", "simulate_simple",
    "modify", "flatten_sequence", "getshape", "getnshift", "get_adc_times",
]

__version__ = "0.1.0"
