"""Diffusion operator (Weigel 2010 EPG diffusion).

Counterpart of ``epgpy_tpu/ops/diffusion.py:29-164`` (reference
epgpy/diffusion.py).  Each k-state is attenuated by ``exp(-Tr(b D))``,
where the b-matrix integrates the k-space trajectory over the diffusion
interval:

  * longitudinal states: ``bL = tau k k^T`` (k constant during tau);
  * transverse states during a gradient ramp from ``k1 = k - dk`` to
    ``k2 = k``: ``bT = tau (k1 k1^T + (k1 dk^T + dk k1^T)/2 + dk dk^T / 3)``
    (the Stejskal-Tanner 1/3 term).

Units: tau in ms, k in rad/m, D in mm^2/s -> b in s/mm^2.  The
wavenumbers are the StateMatrix's ``k``: the ladder index times its
``kvalue`` on a 1-D ladder, the coordinate table's first three axes times
``kvalue`` after float or n-D shifts (``ops/shiftnd.py``).  A square
tensor D broadcasts against lower-dimensional wavenumbers as in the
reference (1-D: the attenuation uses ``b00 * sum(D)``).  A batched tensor
``(*batch, d, d)`` takes the operator's batch axes under the append rule.

``D(tau, D, k)`` with ``k`` set models attenuation *during* the gradient
and must be placed right after the corresponding ``S(k)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import common, config
from . import base

__all__ = ["D", "compute_bmatrix", "diffusion_operator",
           "diffusion_exponents"]


def _real(x):
    """A host value or tensor as a real tensor of the working precision on
    the working device (tensors keep their autodiff state)."""
    return torch.as_tensor(x, dtype=config.real_dtype(),
                           device=config.device())


def compute_bmatrix(tau, k1, k2=None):
    """b-matrix (s/mm^2) for constant k (k2 None) or a linear ramp k1 -> k2.

    tau: ms (scalar, or batched: its axes lead); k1, k2: (..., n, d<=3)
    rad/m.  Returns (..., n, d, d)."""
    tau = _real(tau) * 1e-3                 # ms -> s
    k1 = _real(k1) * 1e-3                   # rad/m -> rad/mm
    if k1.ndim == 1:
        k1 = k1[None]
    if k1.shape[-1] > 3:
        raise ValueError("Only 1d, 2d and 3d wavenumbers are allowed")

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    if tau.ndim:
        # a batched tau's axes align with the wavenumbers' leading batch
        # axes (the append rule), broadcasting over (n, d, d)
        tau = tau.reshape(tau.shape + (1,) * (k1.ndim + 1 - tau.ndim))
    bmat = outer(k1, k1) * tau
    if k2 is None:
        return bmat
    kd = _real(k2) * 1e-3 - k1
    return bmat + tau * (0.5 * outer(k1, kd) + 0.5 * outer(kd, k1)
                         + (1.0 / 3.0) * outer(kd, kd))


def diffusion_exponents(bL, bT, Dcoef):
    """The attenuation exponents (sL, sT) = Tr(b D) for L and T states,
    linear in D: ``Tr(b) D`` for a scalar D, ``sum(b * D)`` for a
    tensor."""
    Dval = _real(Dcoef)
    if Dval.ndim == 0:
        trL = torch.diagonal(bL, dim1=-2, dim2=-1).sum(-1)
        trT = torch.diagonal(bT, dim1=-2, dim2=-1).sum(-1)
        return trL * Dval, trT * Dval
    if Dval.ndim > 2:
        # (*batch, d, d): the batch axes lead (append rule), then the
        # state axis
        nb = Dval.ndim - 2
        pad = max(bL.ndim - 3 - nb, 0)
        Dval = Dval.reshape(Dval.shape[:nb] + (1,) * (pad + 1)
                            + Dval.shape[-2:])
    return (torch.sum(bL * Dval, dim=(-2, -1)),
            torch.sum(bT * Dval, dim=(-2, -1)))


def diffusion_operator(bL, bT, Dcoef):
    """Attenuation factors (DL, DT) = exp(-Tr(b D)) for L and T states:
    ``exp(-Tr(b) D)`` for a scalar D, ``exp(-sum(b * D))`` for a tensor."""
    sL, sT = diffusion_exponents(bL, bT, Dcoef)
    return torch.exp(-sL), torch.exp(-sT)


class D(base.DiffOperator):
    """Diffusion attenuation: tau (ms), D (mm^2/s, a scalar or a square
    tensor).  With `k` (state units, scaled by the StateMatrix's kvalue)
    set, models attenuation during the gradient that produced the k-shift
    (place it right after the matching S(k)).  The diffusivity is
    differentiable: ``order1=["Dcoef"]`` (or an alias ``{"D": "Dcoef"}``)."""

    PARAMS = ("tau", "Dcoef", "kshift")
    PARAMETERS_ORDER1 = frozenset({"Dcoef"})

    def __init__(self, tau, D, k=None, *, name=None, duration=None,
                 order1=False, order2=False):
        self.tau = float(tau) if np.isscalar(tau) else common.as_real(tau)
        self.Dcoef = (D if isinstance(D, torch.Tensor)
                      else np.asarray(D, dtype=float))
        if self.Dcoef.ndim == 1:
            raise ValueError("D can only be a scalar or a 2d matrix")
        if self.Dcoef.ndim >= 2 and (self.Dcoef.shape[-1]
                                     != self.Dcoef.shape[-2]):
            raise ValueError("D must be a square 2d matrix")
        self.kshift = (None if k is None
                       else np.atleast_2d(np.asarray(k, dtype=float)))
        if (k is not None and np.ndim(k) > 0 and self.Dcoef.ndim >= 2
                and np.shape(k)[-1] != self.Dcoef.shape[-1]):
            # a scalar k is exempt (1-D attenuation by b00 broadcast), an
            # array k must match the tensor's dimensionality
            raise ValueError("Incompatible D and k dimensions")
        if name is None:
            name = f"D({tau}, {np.asarray(D).tolist()}, {k})"
        if duration is True:
            duration = tau
        super().__init__(name=name, duration=duration, order1=order1,
                         order2=order2)

    @property
    def shape(self):
        kshape = (() if self.kshift is None
                  else common.get_shape(self.kshift)[:-1])
        return common.broadcast_shapes(common.get_shape(self.tau),
                                       common.get_shape(self.Dcoef)[:-2],
                                       kshape, (1,))

    @property
    def kdim(self) -> int:
        return 1 if self.kshift is None else self.kshift.shape[-1]

    def _bmatrices(self, sm):
        """The b-matrices (bL, bT) of the state's wavenumbers."""
        if not common.broadcastable(self.shape, sm.shape):
            raise ValueError("Incompatible StateMatrix and operator "
                             f"shapes: {sm.shape}, {self.shape}")
        k = sm.k                                   # (*b, K, <=3) rad/m
        bL = compute_bmatrix(self.tau, k)
        if self.kshift is None:
            bT = bL
        else:
            # kshift is in the units of S(k): scaled by kvalue
            kd = k.shape[-1]
            shift = _real(self.kshift)
            kvalue = sm.kvalue
            if isinstance(kvalue, np.ndarray):
                kvalue = common.const_tensor(
                    kvalue.reshape(-1)[:shift.shape[-1]], shift.dtype,
                    shift.device)
            elif isinstance(kvalue, torch.Tensor) and kvalue.ndim:
                kvalue = kvalue.reshape(-1)[:shift.shape[-1]]
            shift = shift * kvalue
            if shift.shape[-1] < kd:
                shift = torch.nn.functional.pad(
                    shift, (0, kd - shift.shape[-1]))
            if shift.shape[:-1] == (1,):
                shift = shift[0]          # one vector: over every state
            else:
                shift = shift[..., None, :]  # batched: add the state axis
            bT = compute_bmatrix(self.tau, k - shift, k)
        return bL, bT

    def apply(self, sm):
        return self._attenuate(sm, *self._bmatrices(sm))

    def _attenuate(self, sm, bL, bT):
        """The state attenuated by the b-matrices' factors."""
        DL, DT = diffusion_operator(bL, bT, self.Dcoef)  # (..., K)
        states = sm.states
        cdt = states.dtype
        Fp = states[..., 0] * DT.to(cdt)
        Z = states[..., 2] * DL.to(cdt)
        # F-(k) = conj(F+(-k)): the tables are reversal-symmetric, so the
        # mirrored attenuation keeps the ladder consistent
        Fm = torch.conj(torch.flip(Fp, dims=(-1,)))
        return sm.update(states=torch.stack([Fp, Fm, Z], dim=-1))
