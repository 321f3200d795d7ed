"""Multi-echo spoiled GRE (ME-GRE) trains and their Jacobian: CUDA kernels,
plain twins.

Counterpart of ``epgpy_tpu/models/pallas_megre.py``:
``megre_dictionary_pallas`` (:169) with its kernel ``_kernel_megre`` (:93)
and ``megre_jacobian_pallas`` (:391) with ``_kernel_megre_jac`` (:220).
ME-GRE reads m >= 2 echoes per TR before the spoiler, ``[T, (E, ADC) * m,
E?, S(1)] * N``: k-independent relaxation commutes with everything between
the pulse and the shift, so echo j is the rotated k = 0 row decayed by
``exp(-te_j / T2)`` and phased by ``2 pi df te_j`` (te_j the cumulative
echo time of pulse i, from an (m, P) matrix), and the state then relaxes
over the full TR and shifts by one through the folded half-ladder of the
FISP kernel (six planes of nstate + 1 rows; nstate 0 runs as 1, as in the
JAX wrappers).  The Jacobian adds the T1, T2, B1 and off-resonance tangent
groups (30 planes): off-resonance enters only through phasors, so its
tangent is ``i 2 pi t`` times the primal on every echo (t = te_j) and on
the carried F planes (t = TR) -- computed whether or not ``dfs`` is given,
so the df column is exact at df = 0, where a B0 fit starts.

The kernels are ``epgpy_torch/csrc/megre.cu`` and ``megre_jac.cu`` (see
their headers for the design); ``megre_echoes_plain`` /
``megre_jacobian_echoes_plain`` are the same recurrences with the same
operation order, vectorised over atoms as (6, nstate+1, B) planes in a
Python loop over TRs, in any precision (float64 makes them oracles).
The echo-layout functions (``megre_echoes``, ``megre_jacobian_echoes`` and
their twins) return the train's ADC order on the first axis, row ``i m +
j`` for echo j of pulse i, (m P, B): the engine's layout, which the kernels
write directly; ``megre_dictionary_*`` / ``megre_jacobian_*`` return the
JAX functions' (B, P, m) and (B, P, m, 4) views of it.

``*_cuda`` takes the kernel for CUDA tensors (and raises on what it does
not take: no fallback) and the plain twin for CPU tensors.  ``LAUNCHES`` /
``JAC_LAUNCHES`` count kernel launches.  The TPU-only knobs (``btile``,
``pchunk``, ``interpret``) and the padding have no counterpart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import planes
from .cuda_dess import _fmul, _relax
from .cuda_fisp import (SEG_TABLE, SMEM_PER_BLOCK, _jac_views, _prepare,
                        _takes_twin, block_size, jac_kernel_fits,
                        kernel_fits, seg_geometry)

__all__ = ["megre_dictionary_cuda", "megre_dictionary_plain", "megre_echoes",
           "megre_echoes_plain", "megre_jacobian_cuda", "megre_jacobian_plain",
           "megre_jacobian_echoes", "megre_jacobian_echoes_plain",
           "megre_kernel_fits", "megre_jac_kernel_fits",
           "megre_jac_geometry", "LAUNCHES", "JAC_LAUNCHES"]

#: primal kernel launches so far (diagnostics: proves a run went through it)
LAUNCHES = 0
#: Jacobian kernel launches so far
JAC_LAUNCHES = 0

_DEG = math.pi / 180.0


def megre_kernel_fits(nstate) -> bool:
    """Whether the primal kernel's 6 planes of nstate + 1 rows fit in one
    block's shared memory at its smallest block (32 threads): nstate <=
    301."""
    return kernel_fits(max(int(nstate), 1))


def megre_jac_kernel_fits(nstate, m=None) -> bool:
    """The Jacobian kernel's gate: nstate <= 59, where the thread-per-atom
    layout's 30 planes (primal, T1, T2, B1, df) fitted 32 atoms in one
    block's shared memory.  The segmented kernel keeps its state in
    registers, at most 3 rows per lane (nstate <= 95), and keeps this gate
    so that no train changes route.  With the echo count `m`, also that one
    pulse's staged echoes fit a block (:func:`megre_jac_geometry`): m <= 360
    at nstate 1, m <= 952 at nstate 8."""
    nstate = max(int(nstate), 1)
    if not jac_kernel_fits(nstate, True):
        return False
    return m is None or megre_jac_geometry(nstate, m)["smem"] <= SMEM_PER_BLOCK


def megre_jac_geometry(nstate, m):
    """Launch geometry of the Jacobian kernel for m echoes per TR
    (``cuda_fisp.seg_geometry``: each atom stages 10 m floats per pulse,
    the table holds the m echo times beside SEG_TABLE); its shared bytes
    pass SMEM_PER_BLOCK only for hundreds of echoes."""
    return seg_geometry(max(int(nstate), 1), 10 * int(m),
                        SEG_TABLE + int(m))


def _setup(FA, phi, TR, TEs, T1s, T2s, B1s, dfs, strict):
    """_prepare's tensors plus the echo times as an (m, P) tensor ("TE")
    and the echo count ("m"); a (m,) TEs is shared by every pulse."""
    x = _prepare(FA, phi, TR, 0.0, T1s, T2s, B1s, dfs, None, None,
                 strict=strict)
    dev, dt, P = x["T1"].device, x["T1"].dtype, x["P"]
    if isinstance(TEs, torch.Tensor):
        if strict and (TEs.device != dev or TEs.dtype != dt
                       or not TEs.is_contiguous()):
            raise ValueError(f"TEs: expected a contiguous {dt} tensor on "
                             f"{dev}, got {TEs.dtype} on {TEs.device}")
        TE = TEs.to(device=dev, dtype=dt)
    else:
        TE = torch.as_tensor(np.asarray(TEs, dtype=np.float64), dtype=dt,
                             device=dev)
    if TE.ndim == 1:
        TE = TE[:, None].expand(TE.shape[0], P).contiguous()
    if TE.ndim != 2 or TE.shape[1] != P or TE.shape[0] < 1:
        raise ValueError(f"TEs: expected shape (m,) or (m, {P}), got "
                         f"{tuple(TE.shape)}")
    x["TE"], x["m"] = TE, TE.shape[0]
    return x


def _phase(pte, re, im):
    """(re, im) times the echo's df phasor (None: no off-resonance)."""
    return (re, im) if pte is None else planes.cmul(pte[0], pte[1], re, im)


def megre_echoes_plain(FA, phi, TR, TEs, T1s, T2s, B1s, dfs=None, *,
                       nstate=10, demodulate=False):
    """Echo trains (re, im), each (m P, B) in ADC order (row i m + j: echo
    j of pulse i), by the plain PyTorch recurrence (the kernel's twin), on
    T1s's device in T1s's dtype."""
    x = _setup(FA, phi, TR, TEs, T1s, T2s, B1s, dfs, strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    P, B, m, H = x["P"], x["B"], x["m"], max(int(nstate), 1) + 1
    s = [torch.zeros((H, B), dtype=T1.dtype, device=T1.device)
         for _ in range(6)]
    s[4][0] = 1.0
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * _DEG)
    out = torch.empty((2, m * P, B), dtype=T1.dtype, device=T1.device)
    FA, TR, TE = x["FA"], x["TR"], x["TE"]
    for i in range(P):
        rc = planes.rot_coeffs(FA[i] * B1 * _DEG, cp[i], sp[i], c2p[i],
                               s2p[i])
        R = planes.apply_rot(rc, s)
        # m echoes from the rotated k = 0 row, each decayed and phased to
        # its own echo time
        for j in range(m):
            te = TE[j, i]
            pte = None
            if DF is not None:
                ang = 2 * math.pi * DF * te
                pte = (torch.cos(ang), torch.sin(ang))
            eR, eI = planes.echo_copy(torch.exp(-te / T2), pte, R[0][0],
                                      R[1][0])
            if demodulate:
                eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
            out[0, i * m + j] = eR
            out[1, i * m + j] = eI
        cZ, _, cF, _ = _relax(TR[i], T1, T2, DF)
        nZR = cZ * R[4]
        nZR[0] = nZR[0] + (1.0 - cZ)
        s = planes.shift_fold(_fmul(cF, R[0], R[1]) + _fmul(cF, R[2], R[3])
                              + (nZR, cZ * R[5]))
    return out[0], out[1]


def megre_jacobian_echoes_plain(FA, phi, TR, TEs, T1s, T2s, B1s, dfs=None,
                                *, nstate=10, demodulate=False):
    """Echoes (re, im), each (m P, B), and tangents (dre, dim), each
    (m P, B, 4) ordered (T1, T2, B1, df), rows in ADC order, by the plain
    PyTorch recurrence (the Jacobian kernel's twin), on T1s's device and
    dtype."""
    x = _setup(FA, phi, TR, TEs, T1s, T2s, B1s, dfs, strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    P, B, m, H = x["P"], x["B"], x["m"], max(int(nstate), 1) + 1
    z = torch.zeros((H, B), dtype=T1.dtype, device=T1.device)
    # st[g]: plane set of group g (0 primal, then dT1, dT2, dB1, ddf)
    st = [[z.clone() for _ in range(6)] for _ in range(5)]
    st[0][4][0] = 1.0
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * _DEG)
    out = torch.empty((10, m * P, B), dtype=T1.dtype, device=T1.device)
    FA, TR, TE = x["FA"], x["TR"], x["TE"]
    for i in range(P):
        a = FA[i] * B1 * _DEG
        rc = planes.rot_coeffs(a, cp[i], sp[i], c2p[i], s2p[i])
        drc = planes.rot_coeffs_db1(a, FA[i] * _DEG, cp[i], sp[i], c2p[i],
                                    s2p[i])
        cZ, dcZ, cF, dcF = _relax(TR[i], T1, T2, DF)
        p0, r1, r2, r3, r4 = (planes.apply_rot(rc, g) for g in st)
        C = planes.apply_rot(drc, st[0])            # B1 coefficient pass

        for j in range(m):
            te = TE[j, i]
            e2te, de2te, pte = planes.te_terms(te, T2, DF)
            row = i * m + j

            def write(o, eR, eI):
                if demodulate:
                    eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
                out[2 * o, row] = eR
                out[2 * o + 1, row] = eI

            pR, pI = planes.echo_copy(e2te, pte, p0[0][0], p0[1][0])
            write(0, pR, pI)
            write(1, *planes.echo_copy(e2te, pte, r1[0][0], r1[1][0]))
            # dT2: the tangent state and the TE decay's derivative
            write(2, *_phase(pte, e2te * r2[0][0] + de2te * p0[0][0],
                             e2te * r2[1][0] + de2te * p0[1][0]))
            # dB1: the tangent state and the rotation-coefficient pass
            write(3, *planes.echo_copy(e2te, pte, r3[0][0] + C[0][0],
                                       r3[1][0] + C[1][0]))
            # ddf: the tangent state and i 2 pi te x the primal echo
            tR, tI = planes.echo_copy(e2te, pte, r4[0][0], r4[1][0])
            gR, gI = planes.df_tangent(te, pR, pI)
            write(4, tR + gR, tI + gI)

        pZ = cZ * p0[4]
        pZ[0] = pZ[0] + (1.0 - cZ)
        t1Z = cZ * r1[4] + dcZ * p0[4]
        t1Z[0] = t1Z[0] - dcZ
        xa, xb = _fmul(dcF, p0[0], p0[1]), _fmul(dcF, p0[2], p0[3])
        ta, tb = _fmul(cF, r2[0], r2[1]), _fmul(cF, r2[2], r2[3])
        # d/ddf of the carried F coefficient: i 2 pi TR (cFr + i cFi)
        fF = planes.df_tangent(TR[i], cF[0], torch.zeros_like(cF[0])
                               if cF[1] is None else cF[1])
        ya, yb = _fmul(fF, p0[0], p0[1]), _fmul(fF, p0[2], p0[3])
        fa, fb = _fmul(cF, r4[0], r4[1]), _fmul(cF, r4[2], r4[3])
        new = [
            _fmul(cF, p0[0], p0[1]) + _fmul(cF, p0[2], p0[3])
            + (pZ, cZ * p0[5]),
            _fmul(cF, r1[0], r1[1]) + _fmul(cF, r1[2], r1[3])
            + (t1Z, cZ * r1[5] + dcZ * p0[5]),
            (ta[0] + xa[0], ta[1] + xa[1], tb[0] + xb[0], tb[1] + xb[1],
             cZ * r2[4], cZ * r2[5]),
            _fmul(cF, r3[0] + C[0], r3[1] + C[1])
            + _fmul(cF, r3[2] + C[2], r3[3] + C[3])
            + (cZ * (r3[4] + C[4]), cZ * (r3[5] + C[5])),
            # Z carries no off-resonance
            (fa[0] + ya[0], fa[1] + ya[1], fb[0] + yb[0], fb[1] + yb[1],
             cZ * r4[4], cZ * r4[5]),
        ]
        st = [planes.shift_fold(n) for n in new]
    return _jac_views(out)


def megre_echoes(FA, phi, TR, TEs, T1s, T2s, B1s, dfs=None, *, nstate=10,
                 demodulate=False):
    """Echo trains (re, im), each (m P, B) float32 in ADC order: the CUDA
    kernel for CUDA tensors, the plain twin for CPU tensors."""
    kw = dict(nstate=nstate, demodulate=demodulate)
    if _takes_twin(T1s, "ME-GRE"):
        return megre_echoes_plain(FA, phi, TR, TEs, T1s, T2s, B1s, dfs, **kw)
    return _launch(FA, phi, TR, TEs, T1s, T2s, B1s, dfs, jac=False, **kw)


def megre_jacobian_echoes(FA, phi, TR, TEs, T1s, T2s, B1s, dfs=None, *,
                          nstate=10, demodulate=False):
    """Echoes (m P, B) and tangents (m P, B, 4) in float32, ADC order: the
    CUDA Jacobian kernel for CUDA tensors, the plain twin for CPU
    tensors."""
    kw = dict(nstate=nstate, demodulate=demodulate)
    if _takes_twin(T1s, "ME-GRE Jacobian"):
        return megre_jacobian_echoes_plain(FA, phi, TR, TEs, T1s, T2s, B1s,
                                           dfs, **kw)
    return _launch(FA, phi, TR, TEs, T1s, T2s, B1s, dfs, jac=True, **kw)


def _launch(FA, phi, TR, TEs, T1s, T2s, B1s, dfs, *, nstate, demodulate,
            jac):
    global LAUNCHES, JAC_LAUNCHES
    from .. import _build

    name = "megre_jac" if jac else "megre"
    if T1s.dtype != torch.float32:
        raise TypeError(f"the {name} kernel computes in float32, got "
                        f"{T1s.dtype}")
    nstate = max(int(nstate), 1)
    if not (megre_jac_kernel_fits if jac else megre_kernel_fits)(nstate):
        raise ValueError(f"nstate={nstate}: beyond the {name} kernel's gate")
    x = _setup(FA, phi, TR, TEs, T1s, T2s, B1s, dfs, strict=True)
    P, B, m = x["P"], x["B"], x["m"]
    if jac:
        geo = megre_jac_geometry(nstate, m)
        if geo["smem"] > SMEM_PER_BLOCK:
            raise ValueError(f"{m} echoes per TR: one pulse's staged echoes "
                             f"({geo['smem']} bytes) exceed "
                             f"{SMEM_PER_BLOCK} bytes of shared memory")
    out = torch.empty((10 if jac else 2, m * P, B), dtype=torch.float32,
                      device=T1s.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # asynchronous on the current stream; see cuda_fisp._launch on
    # temporaries
    lib = _build.load()
    fn = lib.epg_megre_jac if jac else lib.epg_megre
    rc = fn(ptr(x["FA"]), ptr(x["phi"]), ptr(x["TR"]), ptr(x["TE"]),
            ptr(x["T1"]), ptr(x["T2"]), ptr(x["B1"]), ptr(x["df"]), ptr(out),
            P, B, m, nstate, int(x["df"] is not None), int(bool(demodulate)),
            geo["warps"] if jac else block_size(nstate),
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


def _per_echo(x, P):
    """(B, P, m[, G]) view of (m P, B[, G]) ADC-order rows."""
    m = x.shape[0] // P
    x = x.reshape((P, m) + tuple(x.shape[1:]))
    return x.permute((2, 0, 1) + tuple(range(3, x.ndim)))


def megre_dictionary_plain(FA, phi, TR, TEs, T1s, T2s, B1s, dfs=None, *,
                           nstate=10, demodulate=False):
    """ME-GRE echo trains by the plain PyTorch twin of the kernel.
    Arguments and returns as :func:`megre_dictionary_cuda`; any device,
    either precision."""
    re, im = megre_echoes_plain(FA, phi, TR, TEs, T1s, T2s, B1s, dfs,
                                nstate=nstate, demodulate=demodulate)
    P = len(FA)
    return _per_echo(re, P), _per_echo(im, P)


def megre_dictionary_cuda(FA, phi, TR, TEs, T1s, T2s, B1s, dfs=None, *,
                          nstate=10, demodulate=False):
    """Multi-echo spoiled GRE via the fused folded-half-ladder CUDA kernel.

    Args mirror ``megre_dictionary_pallas``: FA (P,) degrees; phi and TR
    (the full TR) scalars or (P,); TEs (m,) cumulative echo times shared
    by every TR, or (m, P) per pulse; T1s, T2s, B1s and the optional
    off-resonance dfs (kHz) (B,) tensors, whose device selects the kernel
    (CUDA, float32, contiguous) or the plain twin (CPU).  Returns (re, im):
    (B, P, m) views of the kernel's ADC-order output, echo index last.
    """
    re, im = megre_echoes(FA, phi, TR, TEs, T1s, T2s, B1s, dfs,
                          nstate=nstate, demodulate=demodulate)
    P = len(FA)
    return _per_echo(re, P), _per_echo(im, P)


def _jac_split(echoes, P):
    (re, im), (dre, dim) = echoes
    return ((_per_echo(re, P), _per_echo(im, P)),
            (_per_echo(dre, P), _per_echo(dim, P)))


def megre_jacobian_plain(FA, phi, TR, TEs, T1s, T2s, B1s, dfs=None, *,
                         nstate=10, demodulate=False):
    """ME-GRE echoes and Jacobian by the plain PyTorch twin of the kernel.
    Arguments and returns as :func:`megre_jacobian_cuda`."""
    return _jac_split(megre_jacobian_echoes_plain(
        FA, phi, TR, TEs, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate), len(FA))


def megre_jacobian_cuda(FA, phi, TR, TEs, T1s, T2s, B1s, dfs=None, *,
                        nstate=10, demodulate=False):
    """ME-GRE echoes + dS/d(T1, T2, B1, df) in one fused kernel.

    Arguments as :func:`megre_dictionary_cuda`.  Returns ``(re, im), (jre,
    jim)``: signals (B, P, m) and Jacobians (B, P, m, 4) ordered (T1, T2,
    B1, df) -- the ``megre_jacobian_pallas`` layout, as views of the
    kernel's ADC-order output.  The df column (signal per kHz) is exact at
    any df, 0 included."""
    return _jac_split(megre_jacobian_echoes(
        FA, phi, TR, TEs, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate), len(FA))
