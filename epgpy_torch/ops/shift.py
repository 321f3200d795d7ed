"""Gradient shift operators (integer 1-D shifts).

Counterpart of ``epgpy_tpu/ops/shift.py``.  A shift moves transverse
states along the k-ladder, ``F(k) -> F(k + n)``: in the ``(..., K, 3)``
layout column 0 (F+) slides up by n rows, column 1 (F-) down, Z stays
(reference epgpy/shift.py:271-294).  The ladder has a static capacity;
states pushed past its edge are dropped (the reference's ``nmax``
truncation).

Float and n-D shifts (coordinate tables, ``shiftnd.py`` in the JAX
package) and the ``G``/``C`` operators built on them are not ported yet:
they raise NotImplementedError naming ROADMAP queue 1, item 9.
"""

from __future__ import annotations

import numpy as np
import torch

from . import base

__all__ = ["S", "G", "C", "shift1d"]

_TABLE_SHIFTS = ("float and n-D shifts (coordinate tables) are not ported "
                 "to epgpy_torch yet: ROADMAP queue 1, item 9 "
                 "(ops/shiftnd.py, ops/shiftdense.py)")


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
    """Integer 1-D gradient shift by `k` states."""

    def __init__(self, k, *, name=None, duration=None):
        if not isinstance(k, (int, np.integer)) or isinstance(k, bool):
            raise NotImplementedError(_TABLE_SHIFTS)
        if k == 0:
            raise TypeError("Cannot have k == 0")
        self.k = int(k)
        super().__init__(name=name or f"S({self.k})", duration=duration)

    @property
    def nshift(self) -> int:
        return abs(self.k)

    def apply(self, sm):
        return sm.update(states=shift1d(sm.states, self.k))


def G(*args, **kwargs):
    """Shift from a gradient area: not ported yet (float shifts)."""
    raise NotImplementedError(_TABLE_SHIFTS)


def C(*args, **kwargs):
    """Dephasing-time accumulation: not ported yet (4-D coordinates)."""
    raise NotImplementedError(_TABLE_SHIFTS)
