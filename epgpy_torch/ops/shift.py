"""Gradient shift operators.

Counterpart of ``epgpy_tpu/ops/shift.py``.  A shift moves transverse
states along the k-ladder, ``F(k) -> F(k + n)``: in the ``(..., K, 3)``
layout column 0 (F+) slides up by n rows, column 1 (F-) down, Z stays
(reference epgpy/shift.py:271-294).  The ladder has a static capacity;
states pushed past its edge are dropped (the reference's ``nmax``
truncation).

A float or vector shift (and ``G``, ``C``, built on it) works on the
StateMatrix's explicit coordinate table instead: ``ops/shiftnd.py``
merges the moved rows into grid cells and keeps the most energetic ones
(Gao 2021), ``ops/shiftdense.py`` does the same on a dense grid when the
engine finds the train eligible.  Its shift vector is a parameter
(``kleaf``), so a train of table shifts with varying values still groups
into one block of the planner.
"""

from __future__ import annotations

import numpy as np
import torch

from . import base

__all__ = ["S", "G", "C", "shift1d"]

#: (K, n, device, dtype) -> the gather map of a shift; filled only outside
#: a CUDA graph capture (a tensor made during a capture holds its values
#: only once the graph is replayed)
_SHIFT_MAPS: dict = {}


def _shift_map(K: int, n: int, device, dtype):
    """Source index into the flattened (K * 3) ladder and a 0/1 mask of
    the rows a shift by n fills: F+ from row k - n, F- from k + n, Z
    from k."""
    key = (K, n, str(device), dtype)
    hit = _SHIFT_MAPS.get(key)
    if hit is not None:
        return hit
    k = torch.arange(K, device=device)
    src = torch.stack([k - n, k + n, k], dim=-1)
    ok = (src >= 0) & (src < K)
    idx = (src.clamp(0, K - 1) * 3
           + torch.arange(3, device=device)).reshape(-1)
    out = (idx, ok.reshape(-1).to(dtype))
    if not (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        _SHIFT_MAPS[key] = out
    return out


def shift1d(states, n: int):
    """Shift a (..., K, 3) ladder by integer n: F+ up, F- down, zero-fill
    (one gather over the flattened ladder times the fill mask)."""
    if n == 0:
        return states
    K = states.shape[-2]
    idx, mask = _shift_map(K, int(n), states.device, states.real.dtype)
    flat = states.reshape(states.shape[:-2] + (3 * K,))
    return (flat.index_select(-1, idx) * mask).reshape(states.shape)


class S(base.DiffOperator):
    """Gradient shift by `k`: an int moves the 1-D integer ladder by k
    states; a float or a vector (up to 4 axes, the fourth the accumulated
    time of ``C``; leading axes batch-varying) shifts the coordinate
    table, merging rows on a grid of `kgrid` (the ``simulate(kgrid=)``
    option wins).  `nmax` and `prune` are accepted for the reference's
    API: the capacity is the engine's."""

    PARAMS = ("kleaf",)
    #: shift values stay float64 on the device: the table merges quantize
    #: their sums into grid cells (``statematrix.COORD_DTYPE``)
    LEAF_DTYPES = {"kleaf": torch.float64}

    def __init__(self, k, *, nmax=None, kgrid=None, prune=1e-8, name=None,
                 duration=None):
        if isinstance(k, (int, np.integer)) and not isinstance(k, bool):
            if k == 0:
                raise TypeError("Cannot have k == 0")
            self._kint = int(k)
            self.kleaf = None
            self._int_table = True
        else:
            karr = np.atleast_2d(np.asarray(k))
            if karr.shape[-1] not in (1, 2, 3, 4):
                raise ValueError("k.shape[-1] must belong to [1, 2, 3, 4]")
            if np.allclose(karr, 0):
                raise TypeError("Cannot have k == 0")
            self._kint = None
            self._int_table = bool(np.issubdtype(karr.dtype, np.integer))
            self.kleaf = karr
        self.nmax = nmax
        self.kgrid = kgrid
        self.prune = prune
        if not name:
            name = (f"S({self._kint})" if self._kint is not None
                    else f"S({np.round(self.kleaf, 2).tolist()})")
        super().__init__(name=name, duration=duration)

    @property
    def k(self):
        """The shift: an int (1-D ladder) or the host array (table)."""
        return self._kint if self._kint is not None else self.kleaf

    @property
    def nshift(self) -> int:
        if self._kint is not None:
            return abs(self._kint)
        return int(np.round(np.max(np.abs(np.asarray(self.kleaf)))))

    @property
    def shape(self):
        if self._kint is not None:
            return (1,)
        return tuple(self.kleaf.shape[:-1])

    @property
    def kdim(self) -> int:
        return 1 if self._kint is not None else self.kleaf.shape[-1]

    def apply(self, sm):
        if self._kint is not None and sm.coords is None:
            return sm.update(states=shift1d(sm.states, self._kint))
        from . import shiftnd
        return shiftnd.apply_shift(self, sm)


class G(S):
    """Shift from a gradient area: tau (ms) x gradient (mT/m, up to 3
    axes) -> k = 2 pi gamma g tau (rad/m)."""

    PARAMS = ("kleaf", "tau", "gradient")

    def __init__(self, tau, gradient, *, duration=None, **kwargs):
        from ..utils import constants
        tau_a = np.asarray(tau, dtype=float)
        grad = np.asarray(gradient, dtype=float)
        if np.any(tau_a < 0):
            raise ValueError("Cannot have negative time")
        if grad.ndim > 0 and grad.shape[-1] > 3:
            raise ValueError("Only 3d gradients are allowed")
        k = 2 * np.pi * constants.gamma_1H * grad * 1e-3 * tau_a
        if duration is True:
            duration = tau
        self.tau = tau_a
        self.gradient = grad
        super().__init__(k, duration=duration, **kwargs)


class C(S):
    """Accumulate dephasing time tau * R2 on the fourth coordinate (T2'
    and B0 through the imaging probes)."""

    PARAMS = ("kleaf", "tau", "R2")

    def __init__(self, tau, R2=1, *, duration=None, **kwargs):
        tau_a = np.asarray(tau, dtype=float)
        R2_a = np.asarray(R2, dtype=float)
        if np.any(tau_a < 0):
            raise ValueError("Cannot have negative time")
        evol = tau_a * R2_a
        k = np.stack([0 * evol] * 3 + [evol], axis=-1)
        if duration is True:
            duration = tau
        self.tau = tau_a
        self.R2 = R2_a
        super().__init__(k, duration=duration, **kwargs)
