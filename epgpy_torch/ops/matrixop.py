"""Per-state 3x3 matrix operator application.

Counterpart of ``epgpy_tpu/ops/matrixop.py:41-69``: one 3x3 complex
matrix per batch element applied to every k-state's ``(F+, F-, Z)``
vector, ``states[k] = mat @ states[k] [+ mat0 @ equilibrium[k]]``
(reference epgpy/opmatrix.py:199-221).
"""

from __future__ import annotations

import torch

from .scalarop import align_batch

__all__ = ["apply_matrices"]


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
