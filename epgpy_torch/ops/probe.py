"""Probe (readout) operators.

Counterpart of ``epgpy_tpu/ops/probe.py``.  Probes are no-op operators that
record data from the state matrix at their position in the sequence
(reference epgpy/probe.py).  This slice ports callable probes and the
``Adc`` readout of ``F0`` or ``Z0`` with receiver phase compensation.
Expression-string probes, ``weights``/``reduce``, ``DFT`` and ``Imaging``
raise NotImplementedError (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import base

__all__ = ["Probe", "Adc", "ADC", "DFT", "Imaging"]

_NOT_PORTED = ("{} is not ported to epgpy_torch yet: ROADMAP queue 1, "
               "item 9 (ops/probe.py)")


class Probe(base.EmptyOperator):
    """No-op operator holding a callback ``obj(sm, *args, **kwargs)``."""

    def __init__(self, obj, *args, post=None, name=None, **kwargs):
        if isinstance(obj, str):
            raise NotImplementedError(_NOT_PORTED.format(
                "expression-string Probe"))
        if not callable(obj):
            raise TypeError(f"Invalid probe object: {obj}")
        self._callable = obj
        self._args = args
        self._kwargs = kwargs
        self._post = post
        super().__init__(name=name or f"Probe({obj!r})")

    def _acquire(self, sm):
        return self._callable(sm, *self._args, **self._kwargs)

    def post(self, obj):
        return obj if self._post is None else self._post(obj)

    def acquire(self, sm, post=None):
        return (post or self.post)(self._acquire(sm))


class Adc(Probe):
    """Readout of ``F0`` or ``Z0``, with an optional phase (degrees)
    multiplied in as ``e^{i phase}`` (receiver demodulation)."""

    def __init__(self, attr="F0", *, phase=None, reduce=None, weights=None,
                 name="ADC"):
        if attr not in ("F0", "Z0"):
            raise NotImplementedError(_NOT_PORTED.format(f"Adc(attr={attr!r})"))
        if reduce is not None or weights is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                "Adc weights/reduce"))
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
