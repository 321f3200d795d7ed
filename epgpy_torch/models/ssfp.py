"""Steady-state sequences: SPGR (RF-spoiled GRE), bSSFP (TrueFISP) and
DESS (counterpart of ``epgpy_tpu/models/ssfp.py``; reference
examples/basics: spgr.py, dess.py)."""

from __future__ import annotations

import numpy as np

from ..ops import ADC, Adc, E, S, T

__all__ = ["spgr_sequence", "bssfp_sequence", "dess_sequence"]


def spgr_sequence(npulse: int, *, alpha=15.0, TR=10.0, TE=3.0,
                  T1=1000.0, T2=80.0, phase_inc=117.0):
    """RF-spoiled gradient-echo with quadratic phase cycling."""
    phases = np.cumsum(np.arange(npulse) * phase_inc) % 360.0
    seq = []
    for i in range(npulse):
        seq += [
            T(alpha, phases[i]),
            E(TE, T1, T2), Adc(phase=-phases[i]),
            E(TR - TE, T1, T2), S(1),
        ]
    return seq


def bssfp_sequence(FA, TR, TE=None, *, T1=1000.0, T2=80.0, df=None,
                   phase_cycle=180.0, demodulate=True, inversion=None,
                   order1=None):
    """Balanced SSFP (TrueFISP) train: no spoiler, k=0-only EPG ladder.

    The original MR fingerprinting family (Ma 2013): per-pulse flip
    angles ``FA`` (degrees, (N,)), TR scalar or per-pulse (ms), TE
    defaults to TR/2, ``phase_cycle`` the per-pulse RF phase increment
    (180 = alternating bSSFP), ``df`` off-resonance in kHz (``E.g``),
    ``inversion`` an optional TI (ms) for a 180deg prep.
    ``demodulate=True`` adds ``Adc(phase=-phi_i)`` receiver demodulation
    (the fused kernel's convention).  ``order1`` (e.g. ``["T1", "T2"]``)
    tags every E op for Jacobian probes.  Returns the operator list;
    ``simulate()`` routes it to the fused bSSFP kernel on CUDA (see
    fisp_dispatch.match_bssfp).
    """
    FA = np.atleast_1d(np.asarray(FA, dtype=float))
    if FA.ndim != 1:
        raise ValueError("FA must be a per-pulse (N,) array")
    npulse = FA.shape[0]
    TRs = np.broadcast_to(np.asarray(TR, dtype=float), (npulse,))
    TEs = (TRs / 2 if TE is None
           else np.broadcast_to(np.asarray(TE, dtype=float), (npulse,)))
    phases = np.cumsum(np.full(npulse, float(phase_cycle))) % 360.0
    ekw = {} if df is None else {"g": df}
    if order1 is not None:
        ekw["order1"] = list(order1)
    seq = []
    if inversion is not None:
        seq += [T(180, 0), E(float(inversion), T1, T2, **ekw)]
    for i in range(npulse):
        seq += [
            T(FA[i], phases[i]),
            E(TEs[i], T1, T2, **ekw),
            Adc(phase=-phases[i]) if demodulate else ADC,
            E(TRs[i] - TEs[i], T1, T2, **ekw),
        ]
    return seq


def dess_sequence(npulse: int, *, alpha=25.0, TR=20.0, TE=5.0,
                  T1=1000.0, T2=80.0):
    """Double-echo steady state: FISP + PSIF echoes per TR."""
    seq = []
    for _ in range(npulse):
        seq += [
            T(alpha, 0),
            E(TE, T1, T2), ADC,                 # FISP echo (pre-gradient)
            E(TR - 2 * TE, T1, T2), S(1),
            E(TE, T1, T2), ADC,                 # PSIF echo (post-gradient)
        ]
    return seq
