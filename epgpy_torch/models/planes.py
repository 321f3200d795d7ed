"""Plane math of the folded half-ladder kernels, in plain PyTorch.

Counterpart of ``epgpy_tpu/models/pallas_common.py:19-120`` and the torch
twin of ``epgpy_torch/csrc/epg_planes.cuh``: the same functions with the
same operation order, so a CUDA kernel and its plain version differ only
by rounding.  The tangent pieces of the FISP Jacobian kernel
(``epgpy_tpu/models/pallas_fisp.py:500-535, 606-627, 674-677, 711-731``)
are here too: the B1 derivative of the rotation coefficients, the T1/T2
derivatives of the folded relaxation, the inversion prep's closed-form
tangents and the DW-FISP attenuation rows with their D-derivatives.

A plane set is the 6-tuple ``(AR, AI, BR, BI, ZR, ZI)`` of ``(nstate + 1,
B)`` real tensors with A(k) = F+(k), B(k) = F+(-k) and Z(k), k = 0..N;
F-(k) = conj(F+(-k)) is implied.  Coefficients are (B,) tensors
(per atom) or 0-d tensors (per pulse) and broadcast along the rows.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cmul", "phase_terms", "rot_coeffs", "rot_coeffs_db1", "rot_A",
           "rot_B", "rot_Z", "apply_rot", "shift_fold", "relax_tangents",
           "relax_tau_terms", "inversion_prep", "diff_attenuation"]


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


def rot_coeffs_db1(a, da, cp, sp, c2p, s2p):
    """d/dB1 of :func:`rot_coeffs` for a flip ``a = FA * B1`` (radians),
    ``da = d(a)/dB1``: the 10-tuple (dcos2, dm01r, dm01i, dm02r, dm02i,
    dca, dm20r, dm20i, dm21r, dm21i).  With ``a = alpha * pi/180`` and
    ``da = pi/180`` it is d/dalpha (alpha in degrees), the per-pulse
    Hessian kernel's coefficient pass (pallas_hessian.py:140-146)."""
    ca, sa = torch.cos(a), torch.sin(a)
    dsa = ca * da
    dsin2 = 0.5 * sa * da
    return (-0.5 * sa * da, c2p * dsin2, s2p * dsin2, sp * dsa, -cp * dsa,
            -sa * da, -0.5 * sp * dsa, -0.5 * cp * dsa,
            -0.5 * sp * dsa, 0.5 * cp * dsa)


def relax_tangents(cZ, cF, TR, T1, T2):
    """(dcZ/dT1, dcF/dT2) of the folded relaxation coefficients
    cZ = e^{-TR/T1}, cF = e^{-TR/T2} (the k = 0 recovery 1 - cZ has
    tangent -dcZ)."""
    return cZ * TR / (T1 * T1), cF * TR / (T2 * T2)


def relax_tau_terms(cZ, cF, TR, T1, T2):
    """The per-pulse Hessian kernel's TR-derivatives of the folded
    relaxation (``epgpy_tpu/models/pallas_hessian.py:159-162``): (dcF/dTR,
    dcZ/dTR, d2cF/dTR dT2, d2cZ/dTR dT1); the k = 0 recovery 1 - cZ has
    TR-derivative -dcZ/dTR."""
    return (-cF / T2, -cZ / T1, cF * (1.0 - TR / T2) / (T2 * T2),
            cZ * (1.0 - TR / T1) / (T1 * T1))


def inversion_prep(B1, T1, T2, TI):
    """A 180*B1 pulse about phi = 0, then TI relaxation, in closed form:
    (fpi, z0) -- the residual F+(0) imaginary part and Z(0) -- and their
    tangents (dz0/dT1, dfpi/dT2, dfpi/dB1, dz0/dB1)."""
    ai = math.pi * B1
    sai, cai = torch.sin(ai), torch.cos(ai)
    E1i = torch.exp(-TI / T1)
    E2i = torch.exp(-TI / T2)
    dE1i = E1i * TI / (T1 * T1)
    dE2i = E2i * TI / (T2 * T2)
    return ((-sai * E2i, cai * E1i + 1.0 - E1i),
            ((cai - 1.0) * dE1i, -sai * dE2i, -cai * math.pi * E2i,
             -sai * math.pi * E1i))


def diff_attenuation(bT, bL, Dc, H, ramp):
    """DW-FISP post-shift attenuation rows ``(aA, aB, aZ)``, each (H, B),
    and their D-derivatives ``(-fA aA, -fB aB, -fZ aZ)``: A(k) was ramped
    k-1 -> k, B(k) -k-1 -> -k (the 1/3 term is the gradient ramp's), Z(k)
    sits at k."""
    rows = torch.arange(H, dtype=Dc.dtype, device=Dc.device)[:, None]
    k2 = rows * rows
    if ramp:
        fA = bT * (k2 - rows + 1.0 / 3.0)
        fB = bT * (k2 + rows + 1.0 / 3.0)
    else:
        fA = bT * k2
        fB = fA
    fZ = bL * k2
    att = tuple(torch.exp(-f * Dc) for f in (fA, fB, fZ))
    return att, tuple(-f * a for f, a in zip((fA, fB, fZ), att))


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
