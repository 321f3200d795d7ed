"""RF-pulse (transition) operators.

Counterpart of ``epgpy_tpu/ops/transition.py``.  An instantaneous RF pulse
of flip angle ``alpha`` and phase ``phi`` (degrees) mixes each k-state's
``(F+, F-, Z)`` components by the Weigel rotation ``Rz(phi) Rx(alpha)
Rz(-phi)`` in the configuration basis (reference epgpy/transition.py).
``T`` and ``Phi`` are MatrixOps (matrixop.py): they combine with ``@``.
"""

from __future__ import annotations

import torch

from .. import common, config
from . import base
from .base import _repr
from .matrixop import MatrixOp
from .scalarop import align_batch, apply_coefficients

__all__ = ["T", "Tx", "Ty", "Phi", "rotation_operator", "rotation_elements",
           "rotation_alpha", "rotation_phi"]


def _rad(x):
    return torch.deg2rad(common.to_real(x))


def rotation_alpha(alpha):
    """EPG rotation about x by `alpha` degrees, configuration basis."""
    a = _rad(alpha)
    cdtype = config.complex_dtype()
    cos2 = (torch.cos(a / 2) ** 2).to(cdtype)
    sin2 = (torch.sin(a / 2) ** 2).to(cdtype)
    # the off-diagonal sin terms carry a factor of i
    isin = 1j * torch.sin(a).to(cdtype)
    cos = torch.cos(a).to(cdtype)
    return torch.stack([
        torch.stack([cos2, sin2, -isin], dim=-1),
        torch.stack([sin2, cos2, isin], dim=-1),
        torch.stack([-0.5 * isin, 0.5 * isin, cos], dim=-1),
    ], dim=-2)


def rotation_phi(phi):
    """z-rotation by `phi` degrees: diag(e^{i phi}, e^{-i phi}, 1)."""
    e = torch.exp(1j * _rad(phi))
    zero, one = torch.zeros_like(e), torch.ones_like(e)
    return torch.stack([
        torch.stack([e, zero, zero], dim=-1),
        torch.stack([zero, torch.conj_physical(e), zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def rotation_elements(alpha, phi):
    """The nine Weigel rotation coefficients (row-major), each a complex
    tensor of the broadcast (append-rule) batch shape of alpha and phi."""
    alpha, phi = common.expand_arrays(alpha, phi)
    a, p = torch.broadcast_tensors(_rad(alpha), _rad(phi))
    cdtype = config.complex_dtype()
    cos2 = ((1 + torch.cos(a)) / 2).to(cdtype)
    sin2 = ((1 - torch.cos(a)) / 2).to(cdtype)
    sin = torch.sin(a)
    ep = torch.exp(1j * p)
    m01 = ep * ep * sin2
    m02 = -1j * ep * sin
    m12 = 1j * torch.conj(ep) * sin
    m20 = -0.5j * torch.conj(ep) * sin
    m21 = 0.5j * ep * sin
    m22 = torch.cos(a).to(cdtype)
    return (cos2, m01, m02, torch.conj_physical(m01), cos2, m12, m20, m21,
            m22)


def rotation_operator(alpha, phi):
    """Full RF rotation ``Rz(phi) Rx(alpha) Rz(-phi)`` (degrees) as a
    (*batch, 3, 3) complex tensor."""
    alpha, phi = common.expand_arrays(alpha, phi)
    ra, rp = rotation_alpha(alpha), rotation_phi(phi)
    rm = rotation_phi(-common.to_real(phi))
    nb = max(ra.ndim, rp.ndim) - 2
    ra, rp, rm = (align_batch(m, nb, 2) for m in (ra, rp, rm))
    mat = torch.einsum("...ij,...jk,...kl->...il", rp, ra, rm)
    return mat[None] if mat.ndim == 2 else mat


class T(MatrixOp):
    """Instantaneous RF pulse: flip `alpha`, phase `phi` (degrees)."""

    PARAMS = ("alpha", "phi")
    PARAMETERS_ORDER1 = frozenset({"alpha", "phi"})

    def __init__(self, alpha, phi, *, axes=None, name=None, duration=None,
                 order1=False, order2=False):
        self.alpha = common.as_real(alpha)
        self.phi = common.as_real(phi)
        self.axes = axes
        base.Operator.__init__(self, name=name or _repr("T", alpha, phi),
                               duration=duration, order1=order1,
                               order2=order2)

    @property
    def shape(self):
        return common.shape_with_axes(common.broadcast_shapes(
            common.get_shape(self.alpha), common.get_shape(self.phi), (1,)),
            self.axes)

    def matrices(self):
        mat = rotation_operator(self.alpha, self.phi)
        if self.axes is not None:
            mat = common.set_axes(2, mat, self.axes)
        return mat, None

    def apply(self, sm):
        # column j of the rotation as a (*batch, 1, 3) triplet: three
        # whole-ladder multiply-adds, no (batch, 3, 3) matrix materialized
        elems = rotation_elements(self.alpha, self.phi)
        if self.axes is not None:
            elems = [common.set_axes(0, torch.atleast_1d(e), self.axes)
                     for e in elems]
        m = [align_batch(torch.atleast_1d(e), sm.ndim, 0)[..., None]
             for e in elems]
        cols = [torch.stack(torch.broadcast_tensors(m[j], m[3 + j],
                                                    m[6 + j]), dim=-1)
                for j in range(3)]
        s = sm.states
        out = s[..., 0:1] * cols[0]
        out = torch.addcmul(out, s[..., 1:2], cols[1])
        return sm.update(states=torch.addcmul(out, s[..., 2:3], cols[2]))


def Tx(alpha, **kwargs):
    """RF pulse about x (phi = 0)."""
    return T(alpha, 0, **kwargs)


def Ty(alpha, **kwargs):
    """RF pulse about y (phi = 90)."""
    return T(alpha, 90, **kwargs)


class Phi(MatrixOp):
    """Pure phase offset (z-rotation by `phi` degrees)."""

    PARAMS = ("phi",)
    PARAMETERS_ORDER1 = frozenset({"phi"})
    diagonal = True

    def __init__(self, phi, *, axes=None, name=None, duration=0,
                 order1=False, order2=False):
        self.phi = common.as_real(phi)
        self.axes = axes
        base.Operator.__init__(self, name=name or _repr("Phi", phi),
                               duration=duration, order1=order1,
                               order2=order2)

    @property
    def shape(self):
        return common.shape_with_axes(common.get_shape(self.phi) or (1,),
                                      self.axes)

    def coefficients(self):
        e = torch.exp(1j * _rad(self.phi))
        arr = torch.stack([e, torch.conj(e), torch.ones_like(e)], dim=-1)
        arr = arr[None] if arr.ndim == 1 else arr
        if self.axes is not None:
            arr = common.set_axes(1, arr, self.axes)
        return arr, None

    def matrices(self):
        arr, _ = self.coefficients()
        return arr[..., None] * torch.eye(3, dtype=arr.dtype,
                                          device=arr.device), None

    def apply(self, sm):
        return apply_coefficients(sm, *self.coefficients())
