"""Plane math of the folded half-ladder kernels, in plain PyTorch.

Counterpart of ``epgpy_tpu/models/pallas_common.py:19-120`` and the torch
twin of ``epgpy_torch/csrc/epg_planes.cuh``: the same functions with the
same operation order, so a CUDA kernel and its plain version differ only
by rounding.  A plane set is the 6-tuple ``(AR, AI, BR, BI, ZR, ZI)`` of
``(nstate + 1, B)`` real tensors with A(k) = F+(k), B(k) = F+(-k) and Z(k),
k = 0..N; F-(k) = conj(F+(-k)) is implied.  Coefficients are (B,) tensors
(per atom) or 0-d tensors (per pulse) and broadcast along the rows.
"""

from __future__ import annotations

import torch

__all__ = ["cmul", "phase_terms", "rot_coeffs", "rot_A", "rot_B", "rot_Z",
           "apply_rot", "shift_fold"]


def cmul(cr, ci, xr, xi):
    return cr * xr - ci * xi, cr * xi + ci * xr


def phase_terms(ph):
    """(cos phi, sin phi, cos 2phi, sin 2phi) of a phase in radians."""
    return torch.cos(ph), torch.sin(ph), torch.cos(2 * ph), torch.sin(2 * ph)


def rot_coeffs(a, cp, sp, c2p, s2p):
    """Weigel rotation closed forms for flip `a` (radians) and the phase
    terms of :func:`phase_terms`: the 10-tuple
    (c2, m01r, m01i, m02r, m02i, ca, m20r, m20i, m21r, m21i)."""
    ca, sa = torch.cos(a), torch.sin(a)
    cos2, sin2 = (1 + ca) * 0.5, (1 - ca) * 0.5
    return (cos2, c2p * sin2, s2p * sin2, sp * sa, -cp * sa,
            ca, -0.5 * sp * sa, -0.5 * cp * sa,
            -0.5 * sp * sa, 0.5 * cp * sa)


def rot_A(c2, a1r, a1i, a2r, a2i, s):
    """c2*A + (a1)*conj(B) + (a2)*Z."""
    AR, AI, BR, BI, ZR, ZI = s
    re = c2 * AR + a1r * BR + a1i * BI + a2r * ZR - a2i * ZI
    im = c2 * AI + a1i * BR - a1r * BI + a2r * ZI + a2i * ZR
    return re, im


def rot_B(c2, a1r, a1i, a2r, a2i, s):
    """c2*B + (a1)*conj(A) + (a2)*conj(Z)."""
    AR, AI, BR, BI, ZR, ZI = s
    re = c2 * BR + a1r * AR + a1i * AI + a2r * ZR + a2i * ZI
    im = c2 * BI + a1i * AR - a1r * AI + a2i * ZR - a2r * ZI
    return re, im


def rot_Z(caa, b0r, b0i, b1r, b1i, s):
    """(b0)*A + (b1)*conj(B) + caa*Z."""
    AR, AI, BR, BI, ZR, ZI = s
    re = b0r * AR - b0i * AI + b1r * BR + b1i * BI + caa * ZR
    im = b0r * AI + b0i * AR + b1i * BR - b1r * BI + caa * ZI
    return re, im


def apply_rot(rc, s):
    """Apply a :func:`rot_coeffs` rotation to one plane set."""
    c2, a1r, a1i, a2r, a2i, caa, b0r, b0i, b1r, b1i = rc
    ar, ai = rot_A(c2, a1r, a1i, a2r, a2i, s)
    br, bi = rot_B(c2, a1r, a1i, a2r, a2i, s)
    zr, zi = rot_Z(caa, b0r, b0i, b1r, b1i, s)
    return ar, ai, br, bi, zr, zi


def shift_fold(s):
    """Unit ladder shift folded through k = 0: A(k) <- A(k-1),
    A(0) <- B(1), B(k) <- B(k+1), B(N) <- 0, Z unshifted."""
    AR, AI, BR, BI, ZR, ZI = s
    zrow = torch.zeros_like(AR[:1])
    return (torch.cat([BR[1:2], AR[:-1]]), torch.cat([BI[1:2], AI[:-1]]),
            torch.cat([BR[1:], zrow]), torch.cat([BI[1:], zrow]), ZR, ZI)
