"""Magnetization-transfer helpers: bound-pool saturation and lineshapes.

This package's own copy of ``epgpy_tpu/utils/magnettransfer.py`` (pure
numpy; Graham 1997 pulsed MT saturation, Morrison 1995 / Gloor 2008
lineshapes).  Usage sketch:

    W = saturation_rate(tau, rf_uT, absorption_rate(T2b, "super-lorentzian",
                                                    offres))
    sat = R(0, rL=[0, W * tau])      # saturate the bound pool
    ... interleave with X(tau, khi, T1=..., T2=...) exchange steps.
"""

from __future__ import annotations

import numpy as np

from .constants import gamma_1H

__all__ = ["saturation_rate", "absorption_rate"]

#: numpy 2 renamed trapz to trapezoid
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def saturation_rate(duration, rf, G, *, gamma=gamma_1H):
    """Bound-pool saturation rate of an RF pulse (1/ms).

    duration: ms; rf: amplitude or waveform (uT); G: absorption line value
    at the pulse's off-resonance frequency (ms).
    Valid when the pulse bandwidth << bound-pool bandwidth (Graham 1997).
    """
    rf = np.asarray(rf, dtype=float)
    if rf.ndim == 0:
        integral = duration * float(rf) ** 2
    else:
        integral = _trapezoid(rf ** 2, dx=duration / (len(rf) - 1))
    W = np.pi * (1e-3 * 2 * np.pi * gamma) ** 2 * (1e-3 * G) * integral \
        / duration
    return W * 1e-3


def absorption_rate(T2, lineshape, offres=0):
    """Bound-pool absorption line value G (1/s) at off-resonance (kHz).

    lineshape: 'gaussian', 'lorentzian' or 'super-lorentzian' (with cubic
    extrapolation across |offres| < 1 kHz where the integrand diverges).
    """
    offres = np.asarray(offres, dtype=float)
    x = 2 * np.pi * T2 * offres

    if lineshape == "gaussian":
        G = T2 / np.sqrt(2 * np.pi) * np.exp(-x ** 2 / 2)

    elif lineshape == "lorentzian":
        G = T2 / np.pi / (1 + x ** 2)

    elif lineshape == "super-lorentzian":
        G = np.zeros(offres.shape)
        valid = np.abs(offres) >= 1

        def _sl(xv):
            # integral over fiber orientations u in [0, 1]
            u = np.linspace(0, 1, 1000)
            den = np.abs(3 * u ** 2 - 1)
            g = np.exp(-2 * (np.asarray(xv)[..., None]
                             / (3 * u ** 2 - 1)) ** 2) / den
            return T2 * np.sqrt(2 / np.pi) * _trapezoid(g, u, axis=-1)

        G[valid] = _sl(x[valid])
        if np.any(~valid):
            # cubic natural-spline extrapolation from anchor points outside
            # the divergent region
            bounds = 2 * np.pi * T2 * np.array([1, 3, 5, 7, 9, 11],
                                               dtype=float)
            Gref = _sl(bounds)
            xs = np.r_[-bounds[::-1], bounds]
            ys = np.r_[Gref[::-1], Gref]
            try:
                from scipy.interpolate import CubicSpline
                spline = CubicSpline(xs, ys, bc_type="natural")
                G[~valid] = spline(x[~valid])
            except ImportError:  # pragma: no cover
                G[~valid] = np.interp(x[~valid], xs, ys)
    else:
        raise ValueError(f"Unknown lineshape: {lineshape}")

    return G * 1e-3
