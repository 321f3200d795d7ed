"""Plane math of the folded half-ladder kernels, in plain PyTorch.

Counterpart of ``epgpy_tpu/models/pallas_common.py:19-120`` and the torch
twin of ``epgpy_torch/csrc/epg_planes.cuh``: the same functions with the
same operation order, so a CUDA kernel and its plain version differ only
by rounding.  The tangent pieces of the FISP Jacobian kernel
(``epgpy_tpu/models/pallas_fisp.py:500-535, 606-627, 674-677, 711-731``)
are here too: the B1 derivative of the rotation coefficients, the T1/T2
derivatives of the folded relaxation, the inversion prep's closed-form
tangents and the DW-FISP attenuation rows with their D-derivatives.  The
CPMG kernels (``epgpy_tpu/models/pallas_mse.py:86-111, 153-168`` and
``pallas_msedesign.py:142-244``) add the excitation from equilibrium, the
half-stage relaxation ``E(tau)`` with its k = 0 recovery and its (T1, T2)
tangents, and the post-shift attenuation of every plane of a set.  The
balanced-SSFP kernels (``epgpy_tpu/models/pallas_bssfp.py:113-122,
261-267``) add the rotation restricted to k = 0 (three floats per atom,
no ladder; its B1 derivative is :func:`rot_coeffs_db1` through the same
function).  The multi-echo GRE kernels (``epgpy_tpu/models/
pallas_megre.py:129-143, 304-343``) add the echo copy of the rotated k = 0
row and the off-resonance tangent of a phasor.  The composite-GRE kernels
(``epgpy_tpu/models/pallas_composite.py:41-66, 184-194``) add the down
shift S(-1) and the per-stage diffusion attenuation with a ramp in either
direction.  The EPG-X kernels (``epgpy_tpu/models/pallas_common.py:
74-99``, ``pallas_xgre.py:324-350``) add the C x C complex mix of the
compartments' plane sets around the k = 0 equilibrium and its tangent.

A plane set is the 6-tuple ``(AR, AI, BR, BI, ZR, ZI)`` of ``(nstate + 1,
B)`` real tensors with A(k) = F+(k), B(k) = F+(-k) and Z(k), k = 0..N;
F-(k) = conj(F+(-k)) is implied.  Coefficients are (B,) tensors
(per atom) or 0-d tensors (per pulse) and broadcast along the rows.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cmul", "phase_terms", "sincospi", "phase_terms_pi", "rot_coeffs",
           "rot_coeffs_sc", "rot_coeffs_db1", "rot_A",
           "rot_B", "rot_Z", "apply_rot", "rot_k0", "shift_fold",
           "shift_down", "stage_attenuation", "te_terms", "echo_copy",
           "df_tangent", "relax_tangents", "relax_tau_terms",
           "inversion_prep", "diff_attenuation",
           "excitation", "excitation_terms", "half_relax",
           "half_relax_tangents", "attenuate", "mix_planes", "mix_tangent"]


def cmul(cr, ci, xr, xi):
    return cr * xr - ci * xi, cr * xi + ci * xr


def phase_terms(ph):
    """(cos phi, sin phi, cos 2phi, sin 2phi) of a phase in radians."""
    return torch.cos(ph), torch.sin(ph), torch.cos(2 * ph), torch.sin(2 * ph)


def sincospi(x):
    """(cos pi x, sin pi x) of an angle x in half turns, as CUDA's
    sincospif takes it: x is first reduced to [-1, 1] by an exact
    subtraction of an even integer, so the result keeps its accuracy at
    any x (2 df t of a large df t; in float32 too)."""
    r = x - 2.0 * torch.round(x * 0.5)
    a = math.pi * r
    return torch.cos(a), torch.sin(a)


def phase_terms_pi(ph):
    """(cos phi, sin phi, cos 2phi, sin 2phi) of a phase in half turns
    (degrees / 180), by :func:`sincospi`: the tables of the kernels that
    take the phase's sincospif."""
    cp, sp = sincospi(ph)
    c2p, s2p = sincospi(2.0 * ph)
    return cp, sp, c2p, s2p


def rot_coeffs(a, cp, sp, c2p, s2p):
    """Weigel rotation closed forms for flip `a` (radians) and the phase
    terms of :func:`phase_terms`: the 10-tuple
    (c2, m01r, m01i, m02r, m02i, ca, m20r, m20i, m21r, m21i)."""
    return rot_coeffs_sc(torch.sin(a), torch.cos(a), cp, sp, c2p, s2p)


def rot_coeffs_sc(sa, ca, cp, sp, c2p, s2p):
    """:func:`rot_coeffs` from the flip's sine `sa` and cosine `ca`
    (``epg::rot_coeffs_sc``)."""
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


def te_terms(te, T2, DF):
    """The echo's TE factors of the balanced-SSFP and DESS kernels:
    (e^{-te/T2}, its T2 derivative, the df phasor (cos, sin) of
    2 pi df te, or None without df)."""
    e2te = torch.exp(-te / T2)
    pte = None
    if DF is not None:
        ang = 2 * math.pi * DF * te
        pte = (torch.cos(ang), torch.sin(ang))
    return e2te, e2te * te / (T2 * T2), pte


def echo_copy(e2te, pte, re, im):
    """One echo of the multi-echo GRE kernels: the rotated k = 0 row
    (re, im) decayed by e2te and, with off-resonance, phased by pte (the
    (cos, sin) pair of :func:`te_terms`; None without df)."""
    eR, eI = e2te * re, e2te * im
    if pte is not None:
        eR, eI = cmul(pte[0], pte[1], eR, eI)
    return eR, eI


def df_tangent(t, re, im):
    """d/ddf of e^{i 2 pi df t} (re + i im): i 2 pi t (re + i im), the
    off-resonance tangent of a phasor over a time t (ms; df in kHz)."""
    w = 2 * math.pi * t
    return -w * im, w * re


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


def rot_k0(rc, FR, FI, Z):
    """A rotation restricted to k = 0 of a balanced (unshifted) train,
    whose F-(0) = conj(F+(0)) and Z(0) is real
    (``epgpy_tpu/models/pallas_bssfp.py:113-122``): nF+ = c2 F+ +
    a1 conj(F+) + a2 Z, nZ = 2 Re(b0 F+) + caa Z, for the 10-tuple of
    :func:`rot_coeffs` (or its B1 derivative, :func:`rot_coeffs_db1`).
    Returns (Re nF+, Im nF+, nZ)."""
    c2, a1r, a1i, a2r, a2i, caa, b0r, b0i = rc[:8]
    return (c2 * FR + a1r * FR + a1i * FI + a2r * Z,
            c2 * FI + a1i * FR - a1r * FI + a2i * Z,
            2.0 * (b0r * FR - b0i * FI) + caa * Z)


def shift_fold(s):
    """Unit ladder shift folded through k = 0: A(k) <- A(k-1),
    A(0) <- B(1), B(k) <- B(k+1), B(N) <- 0, Z unshifted."""
    AR, AI, BR, BI, ZR, ZI = s
    zrow = torch.zeros_like(AR[:1])
    return (torch.cat([BR[1:2], AR[:-1]]), torch.cat([BI[1:2], AI[:-1]]),
            torch.cat([BR[1:], zrow]), torch.cat([BI[1:], zrow]), ZR, ZI)


def shift_down(s):
    """The unit ladder shift S(-1) folded through k = 0 (the composite
    kernels, ``epgpy_tpu/models/pallas_composite.py:184-194``): A(k) <-
    A(k+1), A(N) <- 0, B(k) <- B(k-1), B(0) <- A(1), Z unshifted."""
    AR, AI, BR, BI, ZR, ZI = s
    zrow = torch.zeros_like(AR[:1])
    return (torch.cat([AR[1:], zrow]), torch.cat([AI[1:], zrow]),
            torch.cat([AR[1:2], BR[:-1]]), torch.cat([AI[1:2], BI[:-1]]), ZR,
            ZI)


def stage_attenuation(bt, rd, Dc, H):
    """The composite kernels' stage-closing diffusion attenuation rows
    ``(aA, aB, aZ)``, each (H, B) (``_datten``, ``pallas_composite.py:
    41-66``), for a b-value base ``bt`` per squared state index and a ramp
    direction ``rd`` in {-1, 0, +1} (host numbers): A(k) was ramped
    (k - rd) -> k and B(k) = F+(-k) was ramped -(k + rd) -> -k, so the
    signs of the rd k term swap between them; Z does not ramp."""
    rows = torch.arange(H, dtype=Dc.dtype, device=Dc.device)[:, None]
    k2 = rows * rows
    third = (rd * rd) * (1.0 / 3.0)
    return (torch.exp(-(bt * (k2 - rd * rows + third)) * Dc),
            torch.exp(-(bt * (k2 + rd * rows + third)) * Dc),
            torch.exp(-(bt * k2) * Dc))


def excitation(exc, H, B, dtype, device):
    """The plane set after the excitation ``exc = (alpha, phi)`` (degrees)
    from equilibrium, in closed form: F+(0) = -i e^{i phi} sin(alpha)
    (B(0) = A(0)), Z(0) = cos(alpha), the same for every atom; the values
    are taken in float64 and rounded once, as the kernels receive them."""
    ar, ai, z0 = excitation_terms(exc)
    s = [torch.zeros((H, B), dtype=dtype, device=device) for _ in range(6)]
    s[0][0], s[1][0], s[2][0], s[3][0], s[4][0] = ar, ai, ar, ai, z0
    return s


def excitation_terms(exc):
    """(F+(0) re, F+(0) im, Z(0)) after the excitation, python floats."""
    ea, ep = (float(x) * math.pi / 180.0 for x in exc)
    return (math.sin(ep) * math.sin(ea), -math.cos(ep) * math.sin(ea),
            math.cos(ea))


def half_relax(s, E1, E2):
    """``E(tau)`` on a plane set: F planes times E2 = e^{-tau/T2}, Z times
    E1 = e^{-tau/T1}, plus the recovery 1 - E1 at k = 0."""
    ZR = s[4] * E1
    ZR[0] = ZR[0] + (1.0 - E1)
    return (s[0] * E2, s[1] * E2, s[2] * E2, s[3] * E2, ZR, s[5] * E1)


def half_relax_tangents(P, G1, G2, E1, E2, dE1, dE2):
    """The (T1, T2) tangent sets through ``E(tau)``: dE1 = dE1/dT1 hits Z
    and the recovery (d rec = -dE1), dE2 = dE2/dT2 the F planes, each
    times the incoming primal set P."""
    t1Z = G1[4] * E1 + P[4] * dE1
    t1Z[0] = t1Z[0] - dE1
    return ((G1[0] * E2, G1[1] * E2, G1[2] * E2, G1[3] * E2, t1Z,
             G1[5] * E1 + P[5] * dE1),
            tuple(G2[j] * E2 + P[j] * dE2 for j in range(4))
            + (G2[4] * E1, G2[5] * E1))


def attenuate(s, att):
    """Post-shift attenuation ``(aA, aB, aZ)`` rows of
    :func:`diff_attenuation` on every plane of a set (None: no-op)."""
    if att is None:
        return s
    aA, aB, aZ = att
    return (s[0] * aA, s[1] * aA, s[2] * aB, s[3] * aB, s[4] * aZ,
            s[5] * aZ)


def mix_planes(sets, m, dens):
    """The C x C exchange mix of C plane sets (``_mix_planes``): the F
    planes with the complex transverse matrix, Z with the real longitudinal
    one around the equilibrium, which sits on the k = 0 Z row: dev = Z -
    dens at k = 0, Z' = mL dev + dens at k = 0.  ``m(part, i, j)`` is the
    coefficient (part 0/1/2 = mT re / mT im / mL) and ``dens(j)`` the
    compartment's density, each a (B,) tensor or a number."""
    C = len(sets)
    devs = [_dev0(sets[j][4], dens(j)) for j in range(C)]
    out = []
    for i in range(C):
        for j in range(C):
            mr, mi, ml = m(0, i, j), m(1, i, j), m(2, i, j)
            AR, AI, BR, BI = sets[j][:4]
            ar, ai = cmul(mr, mi, AR, AI)
            br, bi = cmul(mr, mi, BR, BI)
            zr, zi = ml * devs[j], ml * sets[j][5]
            if j == 0:
                nAR, nAI, nBR, nBI, nZR, nZI = ar, ai, br, bi, zr, zi
            else:
                nAR, nAI = nAR + ar, nAI + ai
                nBR, nBI = nBR + br, nBI + bi
                nZR, nZI = nZR + zr, nZI + zi
        nZR = nZR.clone()
        nZR[0] = nZR[0] + dens(i)
        out.append((nAR, nAI, nBR, nBI, nZR, nZI))
    return out


def mix_tangent(tsets, xsets, m, dm, dens, ddens):
    """The tangent of :func:`mix_planes` (``pallas_xgre.py:324-350``):
    t'_i = sum_j [M_ij (t_j - de_j) + dM_ij (x_j - e_j)] + de_i, for the
    tangent sets `tsets` and the primal sets `xsets` from BEFORE the mix;
    ``dm`` and ``ddens`` are the tangents of ``m`` and ``dens``."""
    C = len(tsets)
    xdevs = [_dev0(xsets[j][4], dens(j)) for j in range(C)]
    tdevs = [_dev0(tsets[j][4], ddens(j)) for j in range(C)]
    out = []
    for i in range(C):
        for j in range(C):
            mr, mi, ml = m(0, i, j), m(1, i, j), m(2, i, j)
            dmr, dmi, dml = dm(0, i, j), dm(1, i, j), dm(2, i, j)
            tAR, tAI, tBR, tBI = tsets[j][:4]
            xAR, xAI, xBR, xBI = xsets[j][:4]
            ar, ai = cmul(mr, mi, tAR, tAI)
            dar, dai = cmul(dmr, dmi, xAR, xAI)
            br, bi = cmul(mr, mi, tBR, tBI)
            dbr, dbi = cmul(dmr, dmi, xBR, xBI)
            zr = ml * tdevs[j] + dml * xdevs[j]
            zi = ml * tsets[j][5] + dml * xsets[j][5]
            ar, ai = ar + dar, ai + dai
            br, bi = br + dbr, bi + dbi
            if j == 0:
                nAR, nAI, nBR, nBI, nZR, nZI = ar, ai, br, bi, zr, zi
            else:
                nAR, nAI = nAR + ar, nAI + ai
                nBR, nBI = nBR + br, nBI + bi
                nZR, nZI = nZR + zr, nZI + zi
        nZR = nZR.clone()
        nZR[0] = nZR[0] + ddens(i)
        out.append((nAR, nAI, nBR, nBI, nZR, nZI))
    return out


def _dev0(Z, d):
    """Z - d on the k = 0 row only (the equilibrium's support)."""
    dev = Z.clone()
    dev[0] = dev[0] - d
    return dev
