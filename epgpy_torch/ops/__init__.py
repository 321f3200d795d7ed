"""EPG operators (counterpart of ``epgpy_tpu/ops``)."""

from .base import (Operator, EmptyOperator, MultiOperator, DiffOperator,
                   CombinableOperator, Wait, Offset, Spoiler, Reset, PD,
                   System, NULL, SPOILER, RESET)
from .scalarop import ScalarOp, PrecomputedDiagonal
from .matrixop import MatrixOp
from .transition import T, Tx, Ty, Phi, rotation_operator
from .evolution import E, P, R
from .shift import S, G, C
from .diffusion import D
from .probe import Probe, Adc, ADC, DFT, Imaging
from .exchange import X, exchange_matrix
from .combined import CombinedOp, combine
from .rfpulse import RFPulse
from ..diff import Jacobian, Hessian

__all__ = ["Operator", "EmptyOperator", "MultiOperator", "DiffOperator",
           "CombinableOperator", "Wait", "Offset", "Spoiler", "Reset", "PD",
           "System", "NULL", "SPOILER", "RESET", "ScalarOp",
           "PrecomputedDiagonal", "MatrixOp", "T", "Tx", "Ty", "Phi",
           "rotation_operator", "E", "P", "R", "S", "G", "C", "D", "Probe",
           "Adc", "ADC", "DFT", "Imaging", "X", "exchange_matrix",
           "CombinedOp", "combine", "RFPulse", "Jacobian", "Hessian"]
