"""Relaxation / precession operators.

Counterpart of ``epgpy_tpu/ops/evolution.py`` (reference
epgpy/evolution.py:220-256):

* ``E(tau, T1, T2, g)`` -- relaxation + precession, complex rates
  ``rT = tau (1/T2 + 2 i pi g)``, ``rL = r0 = tau / T1``: coefficients
  ``(conj(e^{-rT}), e^{-rT}, e^{-rL})`` plus recovery ``(0, 0, 1-e^{-r0})``;
* ``P(tau, g)`` -- pure precession, ``rT = 2 i pi g tau``;
* ``R(rT, rL, r0)`` -- generic evolution from complex rates.

Times are in ms, off-resonance ``g`` in kHz.  All three are ScalarOps
(scalarop.py): they combine with ``@`` and the scan planner precomputes
their coefficients (``precompute_diagonal``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import common, config
from . import base
from .scalarop import ScalarOp, stack_elements
from .base import _repr

__all__ = ["E", "P", "R", "evolution_elements", "evolution_operator",
           "relaxation_operator", "precession_operator"]


def _tensor(x, dtype):
    return torch.as_tensor(x, dtype=dtype, device=config.device())


def evolution_operator(rT, rL, r0=None):
    """Diagonal evolution coefficients (arr, arr0) from complex rates: arr
    (..., 3) holds ``(conj(e^{-rT}), e^{-rT}, e^{-rL})`` and arr0 (..., 3)
    the recovery ``(0, 0, 1 - e^{-r0})`` (None without r0), broadcast to
    one shape with at least one batch axis."""
    cdtype = config.complex_dtype()
    rT, rL, r0 = common.expand_arrays(rT, rL, r0)
    eT = torch.exp(-_tensor(rT, cdtype))
    eL = torch.exp(-_tensor(rL, cdtype))
    arr = torch.stack(torch.broadcast_tensors(eT.conj(), eT, eL), dim=-1)
    if arr.ndim == 1:
        arr = arr[None]
    if r0 is None:
        return arr, None
    rec = 1 - torch.exp(-_tensor(r0, cdtype))
    z = torch.zeros_like(rec)
    arr0 = torch.stack(torch.broadcast_tensors(z, z, rec), dim=-1)
    if arr0.ndim == 1:
        arr0 = arr0[None]
    return torch.broadcast_tensors(arr, arr0)


def relaxation_operator(tau, T1, T2, g):
    """E coefficients: transverse decay and precession, longitudinal
    recovery (``rT = tau (1/T2 + 2 i pi g)``, ``rL = r0 = tau / T1``)."""
    rdtype = config.real_dtype()
    tau, T1, T2, g = (_tensor(x, rdtype) for x in common.expand_arrays(
        tau, T1, T2, g))
    rT = tau * (1.0 / T2 + 2j * math.pi * g)
    rL = tau / T1
    return evolution_operator(rT, rL, rL)


def precession_operator(tau, g):
    """P coefficients: precession only (``rT = 2 i pi g tau``)."""
    rdtype = config.real_dtype()
    tau, g = (_tensor(x, rdtype) for x in common.expand_arrays(tau, g))
    return evolution_operator(2j * math.pi * g * tau, 0.0, None)


def evolution_elements(rT, rL=None, r0=None):
    """Element-form evolution coefficients from complex rates (tensors):
    ``((conj(e^{-rT}), e^{-rT}, e^{-rL}), (None, None, 1 - e^{-r0}))``."""
    eT = torch.exp(-rT)
    eL = (torch.ones((), dtype=config.complex_dtype(), device=eT.device)
          if rL is None else torch.exp(-rL))
    elems = (torch.conj(eT), eT, eL)
    if r0 is None:
        return elems, None
    return elems, (None, None, 1 - torch.exp(-r0))


class R(ScalarOp):
    """Generic evolution from complex rates: coefficients
    ``(conj(e^{-rT}), e^{-rT}, e^{-rL})`` plus recovery ``1 - e^{-r0}``
    (none when ``r0`` is None)."""

    PARAMS = ("rT", "rL", "r0")
    PARAMETERS_ORDER1 = frozenset({"rT", "rL", "r0"})

    def __init__(self, rT=0, rL=0, *, r0=None, axes=None, name=None,
                 duration=None, order1=False, order2=False):
        self.rT, self.rL, self.r0 = (None if x is None else _as_complex(x)
                                     for x in (rT, rL, r0))
        self.axes = axes
        if r0 is None:
            # order1=True must not try to differentiate an absent
            # recovery term (diff.substitute would shift a None)
            self.PARAMETERS_ORDER1 = frozenset({"rT", "rL"})
        base.Operator.__init__(self, name=name or "R", duration=duration,
                               order1=order1, order2=order2)

    @property
    def shape(self):
        return common.shape_with_axes(common.broadcast_shapes(
            common.get_shape(self.rT), common.get_shape(self.rL),
            common.get_shape(self.r0), (1,)), self.axes)

    def coefficient_elements(self):
        cdtype = config.complex_dtype()
        rT, rL, r0 = (None if x is None else torch.as_tensor(
            x, dtype=cdtype, device=config.device())
            for x in common.expand_arrays(self.rT, self.rL, self.r0))
        return self._pin_elements(*evolution_elements(rT, rL, r0))

    def coefficients(self):
        return stack_elements(*self.coefficient_elements())


def _as_complex(value):
    """Rate coercion of R: tensors stay, host values become complex."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value, dtype=complex)
    return complex(arr) if arr.ndim == 0 else arr


class E(ScalarOp):
    """Relaxation + precession: tau (ms), T1/T2 (ms), g (kHz)."""

    PARAMS = ("tau", "T1", "T2", "g")
    PARAMETERS_ORDER1 = frozenset({"tau", "T1", "T2", "g"})

    def __init__(self, tau, T1, T2, g=0, *, axes=None, name=None,
                 duration=None, order1=False, order2=False):
        self.tau = common.as_real(tau)
        self.T1 = common.as_real(T1)
        self.T2 = common.as_real(T2)
        self.g = common.as_real(0 if g is None else g)
        self.axes = axes
        if duration is True:
            duration = tau
        base.Operator.__init__(
            self, name=name or _repr("E", tau, T1, T2, self.g),
            duration=duration, order1=order1, order2=order2)

    @property
    def shape(self):
        return common.shape_with_axes(common.broadcast_shapes(
            common.get_shape(self.tau), common.get_shape(self.T1),
            common.get_shape(self.T2), common.get_shape(self.g), (1,)),
            self.axes)

    def coefficient_elements(self):
        tau, T1, T2, g = (common.to_real(x) for x in common.expand_arrays(
            self.tau, self.T1, self.T2, self.g))
        rT = tau * (1.0 / T2 + 2j * math.pi * g)
        rL = (tau / T1).to(config.complex_dtype())
        return self._pin_elements(*evolution_elements(rT, rL, rL))

    def coefficients(self):
        return stack_elements(*self.coefficient_elements())


class P(ScalarOp):
    """Pure precession: tau (ms), g (kHz)."""

    PARAMS = ("tau", "g")
    PARAMETERS_ORDER1 = frozenset({"tau", "g"})

    def __init__(self, tau, g, *, axes=None, name=None, duration=None,
                 order1=False, order2=False):
        self.tau = common.as_real(tau)
        self.g = common.as_real(g)
        self.axes = axes
        if duration is True:
            duration = tau
        base.Operator.__init__(self, name=name or _repr("P", tau, g),
                               duration=duration, order1=order1,
                               order2=order2)

    @property
    def shape(self):
        return common.shape_with_axes(common.broadcast_shapes(
            common.get_shape(self.tau), common.get_shape(self.g), (1,)),
            self.axes)

    def coefficient_elements(self):
        tau, g = (common.to_real(x)
                  for x in common.expand_arrays(self.tau, self.g))
        return self._pin_elements(*evolution_elements(2j * math.pi * g * tau))

    def coefficients(self):
        return stack_elements(*self.coefficient_elements())
