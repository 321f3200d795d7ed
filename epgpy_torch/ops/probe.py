"""Probe (readout) operators.

Counterpart of ``epgpy_tpu/ops/probe.py``.  Probes are no-op operators that
record data from the state matrix at their position in the sequence
(reference epgpy/probe.py): a callable ``obj(sm, *args, **kwargs)``, an
expression string evaluated against the StateMatrix's attributes
(``SM_LOCALS``) with torch's functions as the math namespace (``"F0"``,
``"Z0"``, ``"(real(F0), imag(F0))"``), or the ``Adc`` readout of an
attribute with optional weights, reduction and receiver phase.  ``DFT`` and
``Imaging`` need coordinate tables and raise NotImplementedError (ROADMAP
queue 1, item 5).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import base

__all__ = ["Probe", "Adc", "ADC", "DFT", "Imaging", "SM_LOCALS"]

_NOT_PORTED = ("{} is not ported to epgpy_torch yet: ROADMAP queue 1, "
               "item 5 (coordinate tables: ops/shiftnd.py, utils/imaging.py)")

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
        if key == "k":
            # the JAX package's k carries the batch axes: (1.., K, 1)
            k = self._sm.k
            return k.reshape((1,) * self._sm.ndim + tuple(k.shape))
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
    """Readout of a StateMatrix attribute (``F0`` by default), with an
    optional `phase` (degrees) multiplied in as ``e^{i phase}`` (receiver
    demodulation).  ``weights``/``reduce`` are not ported yet (ROADMAP
    queue 1, item 3)."""

    PARAMS = ("phase",)

    def __init__(self, attr="F0", *, phase=None, reduce=None, weights=None,
                 name="ADC"):
        if attr not in SM_LOCALS:
            raise ValueError(f"Invalid StateMatrix attribute: {attr}")
        if reduce is not None or weights is not None:
            raise NotImplementedError(
                "Adc weights/reduce is not ported to epgpy_torch yet: "
                "ROADMAP queue 1, item 3")
        self.attr = attr
        self.phase = (phase if phase is None or isinstance(phase, torch.Tensor)
                      else np.asarray(phase))
        base.Operator.__init__(self, name=name)

    def _acquire(self, sm):
        return getattr(sm, self.attr)

    def post(self, obj):
        if self.phase is None:
            return obj
        phase = torch.as_tensor(self.phase, device=obj.device)
        phasor = torch.exp(1j * phase.to(obj.real.dtype) * (math.pi / 180))
        if phasor.ndim and phasor.ndim < obj.ndim:
            phasor = phasor.reshape(phasor.shape
                                    + (1,) * (obj.ndim - phasor.ndim))
        return obj * phasor


def DFT(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED.format("DFT"))


def Imaging(*args, **kwargs):
    raise NotImplementedError(_NOT_PORTED.format("Imaging"))


#: default ADC instance (records F0)
ADC = Adc(attr="F0", name="ADC")
