"""Per-state 3x3 matrix operators.

Counterpart of ``epgpy_tpu/ops/matrixop.py``: one 3x3 complex matrix per
batch element applied to every k-state's ``(F+, F-, Z)`` vector,
``states[k] = mat @ states[k] [+ mat0 @ equilibrium[k]]`` (reference
epgpy/opmatrix.py:199-221).  The matrix must satisfy ``mat ==
conj(mat[(1, 0, 2), :][:, (1, 0, 2)])`` to preserve the ladder symmetry.
:class:`MatrixOp` is the user class; the RF pulse ``T`` and the phase
``Phi`` (transition.py) subclass it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import common
from . import base
from .scalarop import (align_batch, apply_diff_arrays_to, complex_tensor,
                       extend_operators, pack_diff_arrays)

__all__ = ["MatrixOp", "matrix_combine", "matrix_combine_multi",
           "apply_matrices"]


def _format_matrix(mat, check=True):
    mat = np.asarray(mat)
    if mat.ndim == 2:
        mat = mat[None]
    if mat.ndim < 3 or mat.shape[-2:] != (3, 3):
        raise ValueError(f"Expected (..., 3, 3) matrix, got {mat.shape}")
    if check:
        sym = np.conj(mat[..., (1, 0, 2), :][..., :, (1, 0, 2)])
        if not np.allclose(mat, sym):
            raise ValueError("Matrix breaks ladder conjugate symmetry")
    return mat


def _matvec_states(mat, states):
    """new[..., k, i] = sum_j mat[..., i, j] states[..., k, j]."""
    m = mat[..., None, :, :]          # broadcast over the ladder axis
    comps = [m[..., i, 0] * states[..., 0] + m[..., i, 1] * states[..., 1]
             + m[..., i, 2] * states[..., 2] for i in range(3)]
    return torch.stack(comps, dim=-1)


def apply_matrices(sm, mat, mat0=None):
    """states[k] = mat @ states[k] [+ mat0 @ equilibrium[k]]; mat/mat0
    are (*batch, 3, 3) complex."""
    states = _matvec_states(align_batch(mat, sm.ndim, 2), sm.states)
    if mat0 is not None:
        states = states + _matvec_states(align_batch(mat0, sm.ndim, 2),
                                         sm.equilibrium)
    return sm.update(states=states)


class MatrixOp(base.DiffOperator, base.CombinableOperator):
    """3x3 per-state operator: ``states = mat @ states [+ mat0 @
    equilibrium]``.  `dmats`/`d2mats` supply custom first/second
    derivative matrices keyed by parameter name (reference
    epgpy/opmatrix.py API)."""

    PARAMS = ("mat", "mat0")
    diagonal = False
    diff_arrays = None
    #: ``axes=`` pinning of the parameter batch axes (common.set_axes)
    axes = None

    def __init__(self, mat, mat0=None, *, dmats=None, d2mats=None,
                 axes=None, name=None, duration=None, check=True, **kwargs):
        if isinstance(mat, torch.Tensor):
            mat = mat[None] if mat.ndim == 2 else mat
            self.preserves_ladder_symmetry = False
        else:
            mat = _format_matrix(mat, check=check)
            if mat0 is not None:
                mat0 = _format_matrix(mat0, check=check)
                mat, mat0 = np.broadcast_arrays(mat, mat0)
            if not check:
                perm = (1, 0, 2)
                sym = all(np.allclose(m, np.conj(m[..., perm, :][..., perm]))
                          for m in (mat, mat0) if m is not None)
                self.preserves_ladder_symmetry = bool(sym)
        self.mat, self.mat0 = mat, mat0
        self.axes = axes
        self.diff_arrays = pack_diff_arrays(dmats, d2mats)
        if dmats or d2mats:
            self.PARAMETERS_ORDER1 = frozenset(dmats or ()) | {
                p for pair in (d2mats or ()) for p in pair}
        super().__init__(name=name or "MatrixOp", duration=duration,
                         **kwargs)

    def apply_diff_arrays(self, lin, quad):
        return apply_diff_arrays_to(self, lin, quad, ("mat", "mat0"))

    @property
    def shape(self):
        return common.shape_with_axes(tuple(self.mat.shape[:-2]), self.axes)

    def matrices(self):
        """(mat, mat0) complex (*batch, 3, 3) matrices on the device."""
        mat, mat0 = complex_tensor(self.mat), complex_tensor(self.mat0)
        if self.axes is not None:
            mat = common.set_axes(2, mat, self.axes)
            mat0 = None if mat0 is None else common.set_axes(2, mat0,
                                                             self.axes)
        return mat, mat0

    def apply(self, sm):
        return apply_matrices(sm, *self.matrices())

    # -- combination (reference epgpy/opmatrix.py:173-187) --

    def combine(self, other, *, name=None, duration=None, **kwargs):
        from .combined import CombinedOp
        return CombinedOp.of(self, other, name=name, duration=duration)


def matrix_combine(mat1, mat2, mat01=None, mat02=None):
    """Compose two matrix ops: first mat1, then mat2 -> (mat2 @ mat1,
    mat2 @ mat01 + mat02)."""
    mat1, mat2, mat01, mat02 = extend_operators(2, mat1, mat2, mat01, mat02)
    mat = mat2 @ mat1
    if mat01 is None and mat02 is None:
        mat0 = None
    elif mat01 is None:
        mat0 = mat02
    else:
        mat0 = mat2 @ mat01
        if mat02 is not None:
            mat0 = mat0 + mat02
    return mat, mat0


def matrix_combine_multi(mats):
    """Compose a chain of matrices applied left to right."""
    mat = mats[0]
    for m in mats[1:]:
        mat = m @ mat
    return mat
