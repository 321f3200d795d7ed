"""Diagonal (per-component) operator application.

Counterpart of ``epgpy_tpu/ops/scalarop.py:33-145``.  A diagonal op
multiplies each k-state's ``(F+, F-, Z)`` vector elementwise by a
coefficient triplet and adds a recovery term times the equilibrium
(reference epgpy/opscalar.py:213-232).
"""

from __future__ import annotations

import torch

__all__ = ["align_batch", "apply_coefficients", "apply_coefficient_elements"]


def align_batch(arr, sm_batch_ndim: int, core_ndim: int):
    """Left-align operator batch dims with state batch dims: insert
    singleton axes between the operator's batch and core axes, so that
    ordinary broadcasting implements the append rule."""
    nbatch = arr.ndim - core_ndim
    missing = sm_batch_ndim - nbatch
    if missing <= 0:
        return arr
    return arr.reshape(arr.shape[:nbatch] + (1,) * missing
                       + arr.shape[nbatch:])


def apply_coefficients(sm, arr, arr0=None):
    """states = arr * states [+ arr0 * equilibrium]; arr/arr0 are
    (*batch, 3) complex triplets."""
    arr = align_batch(arr, sm.ndim, 1)[..., None, :]
    states = sm.states * arr
    if arr0 is not None:
        arr0 = align_batch(arr0, sm.ndim, 1)[..., None, :]
        states = states + arr0 * sm.equilibrium
    return sm.update(states=states)


def apply_coefficient_elements(sm, elems, elems0=None):
    """Element form of :func:`apply_coefficients`: ``elems`` holds the
    three (batch-shaped) coefficients (aFp, aFm, aZ); ``elems0`` the
    recovery coefficients, any of which may be None."""

    def al(e):
        return align_batch(torch.atleast_1d(e), sm.ndim, 0)[..., None]

    s = sm.states
    comps = [s[..., i] * al(elems[i]) for i in range(3)]
    if elems0 is not None:
        for i in range(3):
            if elems0[i] is not None:
                comps[i] = comps[i] + al(elems0[i]) * sm.equilibrium[..., i]
    return sm.update(states=torch.stack(torch.broadcast_tensors(*comps),
                                        dim=-1))
