"""Probe (readout) operators.

Counterpart of ``epgpy_tpu/ops/probe.py``.  Probes are no-op operators that
record data from the state matrix at their position in the sequence
(reference epgpy/probe.py): a callable ``obj(sm, *args, **kwargs)``, an
expression string evaluated against the StateMatrix's attributes
(``SM_LOCALS``) with torch's functions as the math namespace (``"F0"``,
``"Z0"``, ``"(real(F0), imag(F0))"``), or the ``Adc`` readout of an
attribute with optional weights, reduction and receiver phase, or the
spatially resolved readouts ``DFT`` and ``Imaging``, which Fourier-sum the
F ladder over its wavenumbers at given positions (``utils/imaging.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import base

__all__ = ["Probe", "Adc", "ADC", "DFT", "Imaging", "SM_LOCALS"]

#: StateMatrix attributes accessible in expression probes
SM_LOCALS = [
    "nstate", "ndim", "kdim", "states", "coords",
    "F", "F0", "F0t", "Z", "Z0", "k", "t", "t0",
]

#: the math namespace of expression probes: torch's functions, plus the
#: numpy spellings an expression written for the JAX package may use
_MATH = {**vars(torch), "asarray": torch.as_tensor, "array": torch.tensor,
         "newaxis": None}


class _SMNamespace(dict):
    """Lazy attribute access on the state matrix for expression probes."""

    def __init__(self, sm, extra):
        super().__init__(extra)
        self._sm = sm

    def __missing__(self, key):
        if key in SM_LOCALS:
            return getattr(self._sm, key)
        raise KeyError(key)


class Probe(base.EmptyOperator):
    """No-op operator holding a callback ``obj(sm, *args, **kwargs)`` or an
    expression string (evaluated with ``kwargs`` as extra names)."""

    def __init__(self, obj, *args, post=None, name=None, **kwargs):
        if isinstance(obj, str):
            self._expr, self._callable = obj, None
        elif callable(obj):
            self._expr, self._callable = None, obj
        else:
            raise TypeError(f"Invalid probe object: {obj}")
        self._args = args
        self._kwargs = kwargs
        self._post = post
        super().__init__(name=name or f"Probe({obj!r})")

    def _acquire(self, sm):
        if self._expr is not None:
            return eval(self._expr, _MATH, _SMNamespace(sm, self._kwargs))
        return self._callable(sm, *self._args, **self._kwargs)

    def post(self, obj):
        return obj if self._post is None else self._post(obj)

    def acquire(self, sm, post=None):
        return (post or self.post)(self._acquire(sm))


class Adc(Probe):
    """Readout of a StateMatrix attribute (``F0`` by default): optional
    ``weights`` multiply it (appended axes, as the append rule) and
    ``reduce`` sums it over the given axes (all of the weights' axes when
    weights are given, everything with True); `phase` (degrees) is
    multiplied in as ``e^{i phase}`` (receiver demodulation).  `phase` and
    `weights` are parameters: ADCs that differ only in them still group
    into one block of the planner."""

    PARAMS = ("phase", "weights")

    def __init__(self, attr="F0", *, phase=None, reduce=None, weights=None,
                 name="ADC"):
        if attr not in SM_LOCALS:
            raise ValueError(f"Invalid StateMatrix attribute: {attr}")
        self.attr = attr
        self.phase = (phase if phase is None or isinstance(phase, torch.Tensor)
                      else np.asarray(phase))
        if reduce is not None and reduce is not True and reduce is not False:
            reduce = (reduce,) if isinstance(reduce, int) else tuple(reduce)
            if not all(isinstance(ax, int) for ax in reduce):
                raise ValueError(f"Expected (tuple of) int axes, got: "
                                 f"{reduce}")
        self.reduce = reduce
        if weights is not None:
            if not isinstance(weights, torch.Tensor):
                weights = np.asarray(weights)
            ndim = max(weights.ndim, 1)
            if reduce is None:
                self.reduce = tuple(range(ndim))
            elif reduce not in (True, False) and not set(reduce) <= set(
                    range(ndim)):
                raise ValueError(f"Invalid reduce dimension(s): {reduce}")
        self.weights = weights
        base.Operator.__init__(self, name=name)

    @property
    def plain(self) -> bool:
        """True when the readout is the attribute itself (no weights, no
        reduction): what the kernel families' matchers accept."""
        return self.weights is None and self.reduce in (None, False)

    def _acquire(self, sm):
        arr = getattr(sm, self.attr)
        if self.weights is not None:
            w = torch.as_tensor(self.weights, device=arr.device)
            w = w.to(arr.dtype if w.is_complex() else arr.real.dtype)
            if w.numel() > 1 and w.ndim < arr.ndim:
                w = w.reshape(tuple(w.shape) + (1,) * (arr.ndim - w.ndim))
            arr = arr * w
        if self.reduce is None or self.reduce is False:
            return arr
        if self.reduce is True:
            return torch.sum(arr)
        return torch.sum(arr, dim=self.reduce)

    def post(self, obj):
        if self.phase is None:
            return obj
        phase = torch.as_tensor(self.phase, device=obj.device)
        phasor = torch.exp(1j * phase.to(obj.real.dtype) * (math.pi / 180))
        if phasor.ndim and phasor.ndim < obj.ndim:
            phasor = phasor.reshape(phasor.shape
                                    + (1,) * (obj.ndim - phasor.ndim))
        return obj * phasor


class DFT(Probe):
    """Point-voxel discrete Fourier transform of the F states at `coords`
    (positions in m, (..., npos, d); default: the ``coords`` system
    property)."""

    PARAMS = ("coords",)

    def __init__(self, coords=None, *, name=None):
        self.coords = (None if coords is None or isinstance(
            coords, torch.Tensor) else np.asarray(coords, dtype=float))
        base.Operator.__init__(self, name=name or "DFT")

    def _acquire(self, sm):
        from ..utils.imaging import dft
        coords = self.coords if self.coords is not None \
            else sm.system["coords"]
        return dft(coords, sm.F, sm.k[..., :3])

    def post(self, obj):
        return obj


class Imaging(Probe):
    """Spatially resolved imaging readout (DFT, voxel shape, T2'/B0 from
    the accumulated time) at `coords` (default: the ``coords`` system
    property); ``modulation`` and ``weights`` default to the system
    properties of those names; other options go to
    :func:`utils.imaging.imaging`."""

    PARAMS = ("coords",)

    def __init__(self, coords=None, *, name=None, **opts):
        self.coords = (None if coords is None or isinstance(
            coords, torch.Tensor) else np.asarray(coords, dtype=float))
        self.opts = dict(opts)
        base.Operator.__init__(self, name=name or "Imaging")

    def _acquire(self, sm):
        from ..utils.imaging import imaging
        opts = dict(self.opts)
        coords = self.coords
        if coords is None:
            coords = sm.system.get("coords")
        modulation = opts.pop("modulation", None)
        if modulation is None:
            modulation = sm.system.get("modulation")
        weights = opts.pop("weights", None)
        if weights is None:
            weights = sm.system.get("weights")
        return imaging(coords, sm.F, sm.k[..., :3],
                       acctime=sm.t if sm.kdim == 4 else None,
                       modulation=modulation, weights=weights, **opts)

    def post(self, obj):
        return obj


#: default ADC instance (records F0)
ADC = Adc(attr="F0", name="ADC")
