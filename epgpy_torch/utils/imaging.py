"""Spatially resolved readout: the discrete Fourier sum of the F ladder.

This package's own copy of ``epgpy_tpu/utils/imaging.py`` (reference
epgpy/utils.py:12-115): the signal at position ``r`` is the sum of the
transverse configuration states times ``exp(i k . r)``, optionally
weighted by the voxel shape (a sinc for a box voxel) and attenuated or
modulated by the accumulated dephasing time (T2' / B0).  The reference
drops near-zero columns with boolean masks; here the mask multiplies
(identical sums, no data-dependent shapes).
"""

from __future__ import annotations

import cmath
import math

import torch

from .. import config

__all__ = ["imaging", "dft"]


def _real(x, ref=None):
    dev = config.device() if ref is None else ref.device
    return torch.as_tensor(x, dtype=config.real_dtype(), device=dev)


def _dft(f, k, pos):
    """sum_n f[..., n] exp(i k[..., n, :] . pos[..., :])."""
    kp = torch.sum(k * pos[..., None, :], dim=-1)     # (..., nstate)
    return torch.sum(f * torch.polar(torch.ones_like(kp), kp), dim=-1)


def imaging(positions, states, wavenumbers, acctime=None, *, phase=None,
            weights=None, modulation=None, voxel_shape="box", voxel_size=1,
            expand=True, reduce=True, tol=1e-8):
    """Imaging readout: the DFT of F states at spatial positions.

    positions: (..., npos, d) positions (m), their axes inserted before
    the state axis when `expand`; states: (..., nstate) F ladder;
    wavenumbers: (..., nstate, d) rad/m; acctime: optional (..., nstate)
    accumulated times (ms); modulation: T2'/B0 rate (1/ms [+ i kHz]);
    voxel_shape: "box" (sinc weights) or "point"; reduce: True sums every
    axis, an int or tuple those axes, False/None none.  `tol` is accepted
    for the reference's API only (it prunes columns there)."""
    del tol
    F = (states if isinstance(states, torch.Tensor)
         else torch.as_tensor(states, device=config.device()))
    k = _real(wavenumbers, F)
    t = None if acctime is None else _real(acctime, F)
    pos = _real(positions, F)
    if pos.ndim == 1:
        pos = pos[..., None]
    dims = pos.ndim - 1
    if expand:
        # the positions' batch axes go before the state axis
        F = F.reshape(F.shape[:-1] + (1,) * dims + F.shape[-1:])
        k = k.reshape(k.shape[:-2] + (1,) * dims + k.shape[-2:])
        if t is not None:
            t = t.reshape(t.shape[:-1] + (1,) * dims + t.shape[-1:])

    if voxel_shape == "point":
        voxel = 1.0
    elif voxel_shape == "box":
        voxel = torch.prod(torch.sinc(k * voxel_size / 2 / math.pi), dim=-1)
    else:
        raise ValueError(f"Unknown voxel shape: {voxel_shape}")

    if t is not None:
        # the modulation rates align with the batch axes: padded by the
        # inserted position axes and the state axis
        modv = 1.0 if modulation is None else modulation
        if isinstance(modv, (int, float, complex)):
            mod = torch.exp(-t.abs() * float(modv.real))
            if isinstance(modv, complex):
                freq = t * (2 * math.pi * modv.imag)
                mod = mod * torch.polar(torch.ones_like(freq), freq)
        else:
            modv = torch.as_tensor(modv, device=F.device)
            modv = modv.reshape(tuple(modv.shape)
                                + (1,) * ((dims if expand else 0) + 1))
            mod = torch.exp(-t.abs() * modv.real.to(k.dtype))
            if modv.is_complex():
                freq = t * 2 * math.pi * modv.imag.to(k.dtype)
                mod = mod * torch.polar(torch.ones_like(freq), freq)
    else:
        mod = 1.0
    if phase is not None:
        if isinstance(phase, (int, float)):
            mod = mod * cmath.exp(1j * math.radians(phase))
        else:
            ph = _real(phase, F) * (math.pi / 180)
            mod = mod * torch.polar(torch.ones_like(ph), ph)

    kdim = pos.shape[-1]
    im = _dft(voxel * mod * F, k[..., :kdim], pos)
    if weights is not None:
        w = torch.as_tensor(weights, device=im.device)
        im = im * w.to(im.dtype if w.is_complex() else im.real.dtype)
    if reduce is True:
        return torch.sum(im)
    if reduce is not False and reduce is not None:
        return torch.sum(im, dim=reduce)
    return im


def dft(coords, states, wavenumbers, *, reduce=False):
    """Point-voxel DFT (reference epgpy/utils.py:113-115)."""
    return imaging(coords, states, wavenumbers, reduce=reduce,
                   voxel_shape="point")
