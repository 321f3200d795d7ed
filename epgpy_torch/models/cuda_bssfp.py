"""Balanced SSFP (TrueFISP) trains and their Jacobian: CUDA kernels, twins.

Counterpart of ``epgpy_tpu/models/pallas_bssfp.py``:
``bssfp_dictionary_pallas`` (:381) with its kernel ``_kernel`` (:57) and
``bssfp_jacobian_pallas`` (:439) with ``_kernel_jac`` (:153).  A balanced
train has no spoiler, so the EPG ladder never leaves k = 0 and, from the
equilibrium (or an inversion), F-(0) = conj(F+(0)) and a real Z(0) hold
through every pulse: an atom's state is three floats (Re F+(0), Im F+(0),
Z(0)).  Per pulse i the state is rotated by (FA_i * B1, phi_i), the echo is
read at TE_i (T2 decay, the df phase, optional demodulation by
e^{-i phi_i}), and the state relaxes over the full TR_i with the df
precession; an optional 180*B1 inversion with TI relaxation (and TI
precession) comes first.

The kernels are ``epgpy_torch/csrc/bssfp.cu`` and ``bssfp_jac.cu`` (see
their headers for the design); ``bssfp_echoes_plain`` /
``bssfp_jacobian_echoes_plain`` are the same recurrences with the same
operation order, vectorised over atoms in a Python loop over pulses, in
any precision (float64 makes them oracles).  The Jacobian carries dS/dT1,
dS/dT2, dS/dB1 and, with ``track_df``, dS/ddf (df in kHz, exact at any df:
the phase is linear in df).

The primal kernel takes the atom-independent terms of each chunk of
BSSFP_PULSES pulses from a shared table, its angles in half turns
(``sincospif``; the twin's :func:`planes.sincospi`) and its decays as exp2
of the time times the atom's -log2(e) / T; its twin computes the same.

``*_cuda`` takes the kernel for CUDA tensors (and raises on what it does
not take: no fallback) and the plain twin for CPU tensors; the echo-layout
``bssfp_echoes`` / ``bssfp_jacobian_echoes`` are what the dispatch uses.
``LAUNCHES`` / ``JAC_LAUNCHES`` count kernel launches.  The TPU-only knobs
(``btile``, ``pchunk``, ``interpret``) and the padding have no counterpart:
the kernels mask the ragged atom edge.  There is no shared-memory gate: the
state lives in registers.
"""

from __future__ import annotations

import math

import torch

from . import planes
from .cuda_fisp import _finish, _jac_finish, _jac_views, _prepare, _takes_twin

__all__ = ["bssfp_dictionary_cuda", "bssfp_dictionary_plain", "bssfp_echoes",
           "bssfp_echoes_plain", "bssfp_jacobian_cuda", "bssfp_jacobian_plain",
           "bssfp_jacobian_echoes", "bssfp_jacobian_echoes_plain",
           "LAUNCHES", "JAC_LAUNCHES", "BLOCK", "BSSFP_PULSES"]

#: primal kernel launches so far (diagnostics: proves a run went through it)
LAUNCHES = 0
#: Jacobian kernel launches so far
JAC_LAUNCHES = 0
#: threads per block of both kernels (one atom each, state in registers)
BLOCK = 128
#: pulses per chunk of the primal kernel's table (bssfp.cu's kMaxPulses)
BSSFP_PULSES = 32
_LOG2E = math.log2(math.e)

_TWO_PI = 2 * math.pi
_DEG = math.pi / 180.0


def _start(x, G):
    """The initial (Re F+, Im F+, Z) of the primal and of G tangent groups
    (dT1, dT2, dB1[, ddf]): equilibrium, or the closed-form inversion prep
    and its tangents, the F+ seeds rotated by the TI precession."""
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    z = torch.zeros_like(T1)
    st = [[z, z, z] for _ in range(G + 1)]
    if x["TI"] is None:
        st[0][2] = torch.ones_like(T1)
        return st
    TI = x["TI"]
    (fpi, z0), (d1z0, d2fpi, bfpi, bz0) = planes.inversion_prep(B1, T1, T2,
                                                                TI)
    if DF is not None:
        th = _TWO_PI * DF * TI
        ci, si = torch.cos(th), torch.sin(th)

        def seed(g, v):
            st[g][0], st[g][1] = -v * si, v * ci
    else:
        ci = si = None

        def seed(g, v):
            st[g][1] = v

    seed(0, fpi)
    st[0][2] = z0
    if G:
        st[1][2] = d1z0
        seed(2, d2fpi)
        seed(3, bfpi)
        st[3][2] = bz0
    if G == 4:
        # ddf of the seed i v e^{i th}: i 2pi TI times it
        tTI = _TWO_PI * TI
        if ci is None:
            st[4][0] = -tTI * fpi
        else:
            st[4][0], st[4][1] = -tTI * fpi * ci, -tTI * fpi * si
    return st


def bssfp_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                       demodulate=False, inversion=None):
    """Echo train (re, im), each (P, B), by the plain PyTorch recurrence
    (the kernel's twin), on T1s's device in T1s's dtype."""
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, None,
                 strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    P, B = x["P"], x["B"]
    # angles in half turns, as the kernel's sincospif takes them; the
    # decays by exp2 of the atom's factors
    cp, sp, c2p, s2p = planes.phase_terms_pi(x["phi"] * (1.0 / 180.0))
    DF2 = None if DF is None else 2.0 * DF
    # -log2(e) / T as torch divides a number by a tensor: the reciprocal,
    # then the product
    k1 = torch.reciprocal(T1) * -_LOG2E
    k2 = torch.reciprocal(T2) * -_LOG2E

    def te_terms(te):
        return torch.exp2(k2 * te), (None if DF2 is None
                                     else planes.sincospi(DF2 * te))

    FR, FI, Z = torch.zeros_like(T1), torch.zeros_like(T1), torch.ones_like(T1)
    if x["TI"] is not None:
        # the 180*B1 inversion (B1 half turns), TI relaxation and precession
        TI = x["TI"]
        cai, sai = planes.sincospi(B1)
        fpi = -sai * torch.exp2(k2 * TI)
        E1i = torch.exp2(k1 * TI)
        Z = cai * E1i + 1.0 - E1i
        if DF2 is None:
            FI = fpi
        else:
            ci, si = planes.sincospi(DF2 * TI)
            FR, FI = -fpi * si, fpi * ci

    var_te = isinstance(x["TE"], torch.Tensor)
    if not var_te:
        e2te, pte = te_terms(x["TE"])
    out = torch.empty((2, P, B), dtype=T1.dtype, device=T1.device)
    FA, TR = x["FA"], x["TR"]
    for i in range(P):
        if var_te:
            e2te, pte = te_terms(x["TE"][i])
        ca, sa = planes.sincospi(FA[i] * B1 * (1.0 / 180.0))
        rc = planes.rot_coeffs_sc(sa, ca, cp[i], sp[i], c2p[i], s2p[i])
        nFR, nFI, nZ = planes.rot_k0(rc, FR, FI, Z)
        eR, eI = nFR * e2te, nFI * e2te
        if pte is not None:
            eR, eI = planes.cmul(pte[0], pte[1], eR, eI)
        if demodulate:
            eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
        out[0, i] = eR
        out[1, i] = eI
        # full-TR relaxation and precession (no shift: the state stays
        # at k = 0)
        cF = torch.exp2(k2 * TR[i])
        cZ = torch.exp2(k1 * TR[i])
        if DF2 is not None:
            pR, pI = planes.sincospi(DF2 * TR[i])
            FR, FI = cF * (nFR * pR - nFI * pI), cF * (nFI * pR + nFR * pI)
        else:
            FR, FI = cF * nFR, cF * nFI
        Z = cZ * nZ + (1.0 - cZ)
    return out[0], out[1]


def bssfp_jacobian_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                                demodulate=False, inversion=None,
                                track_df=False):
    """Echoes (re, im), each (P, B), and tangents (dre, dim), each
    (P, B, 3[+1]) ordered (T1, T2, B1[, df]), by the plain PyTorch
    recurrence (the Jacobian kernel's twin), on T1s's device and dtype."""
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, None,
                 strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    P, B = x["P"], x["B"]
    G = 4 if track_df else 3
    st = _start(x, G)
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * _DEG)
    var_te = isinstance(x["TE"], torch.Tensor)
    if not var_te:
        te = x["TE"]
        e2te, de2te, pte = planes.te_terms(te, T2, DF)
    out = torch.empty((2 + 2 * G, P, B), dtype=T1.dtype, device=T1.device)
    FA, TR = x["FA"], x["TR"]
    for i in range(P):
        if var_te:
            te = x["TE"][i]
            e2te, de2te, pte = planes.te_terms(te, T2, DF)
        a = FA[i] * B1 * _DEG
        rc = planes.rot_coeffs(a, cp[i], sp[i], c2p[i], s2p[i])
        drc = planes.rot_coeffs_db1(a, FA[i] * _DEG, cp[i], sp[i], c2p[i],
                                    s2p[i])
        R = [planes.rot_k0(rc, *g) for g in st]     # rotated groups
        C = planes.rot_k0(drc, *st[0])              # B1 coefficient pass

        def write(o, eR, eI):
            if pte is not None:
                eR, eI = planes.cmul(pte[0], pte[1], eR, eI)
            if demodulate:
                eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
            out[2 * o, i] = eR
            out[2 * o + 1, i] = eI

        p0, r1, r2, r3 = R[:4]
        write(0, e2te * p0[0], e2te * p0[1])
        write(1, e2te * r1[0], e2te * r1[1])
        write(2, e2te * r2[0] + de2te * p0[0], e2te * r2[1] + de2te * p0[1])
        write(3, e2te * (r3[0] + C[0]), e2te * (r3[1] + C[1]))
        if G == 4:
            # ddf echo: e^{i ang_te} e2te (tangent + i 2pi te primal)
            wte = _TWO_PI * te
            write(4, e2te * (R[4][0] - wte * p0[1]),
                  e2te * (R[4][1] + wte * p0[0]))

        TRi = TR[i]
        cF = torch.exp(-TRi / T2)
        cZ = torch.exp(-TRi / T1)
        dcZ, dcF = planes.relax_tangents(cZ, cF, TRi, T1, T2)
        if DF is not None:
            ang = _TWO_PI * DF * TRi
            pR, pI = torch.cos(ang), torch.sin(ang)

            def fmul(c, re, im):
                return c * (re * pR - im * pI), c * (im * pR + re * pI)
        else:
            def fmul(c, re, im):
                return c * re, c * im

        bF, xF = fmul(cF, r2[0], r2[1]), fmul(dcF, p0[0], p0[1])
        new = [
            [*fmul(cF, p0[0], p0[1]), cZ * p0[2] + (1.0 - cZ)],
            [*fmul(cF, r1[0], r1[1]), cZ * r1[2] + dcZ * p0[2] - dcZ],
            [bF[0] + xF[0], bF[1] + xF[1], cZ * r2[2]],
            [*fmul(cF, r3[0] + C[0], r3[1] + C[1]), cZ * (r3[2] + C[2])],
        ]
        if G == 4:
            wtr = _TWO_PI * TRi
            new.append([*fmul(cF, R[4][0] - wtr * p0[1],
                              R[4][1] + wtr * p0[0]), cZ * R[4][2]])
        st = new
    return _jac_views(out)


def bssfp_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                 demodulate=False, inversion=None):
    """Echo train (re, im), each (P, B) float32: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    kw = dict(demodulate=demodulate, inversion=inversion)
    if _takes_twin(T1s, "bSSFP"):
        return bssfp_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs, **kw)
    return _launch(FA, phi, TR, TE, T1s, T2s, B1s, dfs, jac=False,
                   track_df=False, **kw)


def bssfp_jacobian_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                          demodulate=False, inversion=None, track_df=False):
    """Echoes (P, B) and tangents (P, B, 3[+1]) in float32: the CUDA
    Jacobian kernel for CUDA tensors, the plain twin for CPU tensors."""
    kw = dict(demodulate=demodulate, inversion=inversion, track_df=track_df)
    if _takes_twin(T1s, "bSSFP Jacobian"):
        return bssfp_jacobian_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s,
                                           dfs, **kw)
    return _launch(FA, phi, TR, TE, T1s, T2s, B1s, dfs, jac=True, **kw)


def _launch(FA, phi, TR, TE, T1s, T2s, B1s, dfs, *, demodulate, inversion,
            jac, track_df):
    global LAUNCHES, JAC_LAUNCHES
    from .. import _build

    name = "bssfp_jac" if jac else "bssfp"
    if T1s.dtype != torch.float32:
        raise TypeError(f"the {name} kernel computes in float32, got "
                        f"{T1s.dtype}")
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, None,
                 strict=True)
    P, B = x["P"], x["B"]
    G = 4 if track_df else 3
    out = torch.empty((2 + 2 * G if jac else 2, P, B), dtype=torch.float32,
                      device=T1s.device)
    var_te = isinstance(x["TE"], torch.Tensor)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # asynchronous on the current stream; see cuda_fisp._launch on
    # temporaries
    lib = _build.load()
    args = [ptr(x["FA"]), ptr(x["phi"]), ptr(x["TR"]),
            ptr(x["TE"]) if var_te else None, 0.0 if var_te else x["TE"],
            0.0 if x["TI"] is None else x["TI"],
            ptr(x["T1"]), ptr(x["T2"]), ptr(x["B1"]), ptr(x["df"]),
            ptr(out), P, B, int(var_te), int(x["TI"] is not None),
            int(x["df"] is not None), int(bool(demodulate))]
    if jac:
        args.append(int(bool(track_df)))
    fn = lib.epg_bssfp_jac if jac else lib.epg_bssfp
    rc = fn(*args, BLOCK,
            T1s.device.index if T1s.device.index is not None
            else torch.cuda.current_device(),
            torch.cuda.current_stream(T1s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if jac:
        JAC_LAUNCHES += 1
        return _jac_views(out)
    LAUNCHES += 1
    return out[0], out[1]


def bssfp_dictionary_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                           demodulate=False, inversion=None, normalize=False):
    """bSSFP dictionary by the plain PyTorch twin of the kernel.  Arguments
    as :func:`bssfp_dictionary_cuda`; any device, either precision.
    Returns (re, im), each (B, P)."""
    re, im = bssfp_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs,
                                demodulate=demodulate, inversion=inversion)
    return _finish(re, im, normalize)


def bssfp_dictionary_cuda(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                          demodulate=False, inversion=None, normalize=False):
    """bSSFP fingerprint dictionary via the fused k = 0 CUDA kernel.

    Args mirror ``bssfp_dictionary_pallas``: FA (P,) flip angles (deg); phi
    and TR scalars or (P,); TE a scalar or (P,) (ms); T1s, T2s, B1s and the
    optional off-resonance dfs (kHz, a mapped parameter in bSSFP MRF) (B,)
    tensors, whose device selects the kernel (CUDA, float32, contiguous)
    or the plain twin (CPU).  ``inversion`` (TI, ms) prepends a 180*B1
    prep whose residual F+ precesses by df during TI.  ``normalize``
    returns unit-norm fingerprints.  Returns (re, im), each (B, P):
    transposed views of the kernel's (P, B) output unless normalized.
    """
    re, im = bssfp_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs,
                          demodulate=demodulate, inversion=inversion)
    return _finish(re, im, normalize)


def bssfp_jacobian_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                         demodulate=False, inversion=None, track_df=False):
    """bSSFP fingerprints and Jacobian by the plain PyTorch twin of the
    kernel.  Arguments and returns as :func:`bssfp_jacobian_cuda`."""
    return _jac_finish(bssfp_jacobian_echoes_plain(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, demodulate=demodulate,
        inversion=inversion, track_df=track_df))


def bssfp_jacobian_cuda(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                        demodulate=False, inversion=None, track_df=False):
    """Fingerprints + dS/d(T1, T2, B1[, df]) via one fused k = 0 kernel.

    Arguments as :func:`bssfp_dictionary_cuda` (no ``normalize``).
    Returns ((re, im), (dre, dim)): (B, P) fingerprints and (B, P, 3)
    derivatives ordered (T1, T2, B1), a 4th dS/ddf column with
    ``track_df`` (df in kHz; exact at any df, df=None included) -- the
    ``bssfp_jacobian_pallas`` layout, as views of the kernel's (P, B)
    outputs."""
    return _jac_finish(bssfp_jacobian_echoes(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, demodulate=demodulate,
        inversion=inversion, track_df=track_df))
