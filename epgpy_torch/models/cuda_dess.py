"""DESS (double-echo steady state) trains and their Jacobian: CUDA kernels,
plain twins.

Counterpart of ``epgpy_tpu/models/pallas_dess.py``:
``dess_dictionary_pallas`` (:151) with its kernel ``_kernel_dess`` (:33)
and ``dess_jacobian_pallas`` (:377) with ``_kernel_dess_jac`` (:201).
DESS reads two echoes per TR of the train ``[T, E(TE), ADC, E(mid), S(1),
E(TE2), ADC]``: the FISP echo, the rotated k = 0 row decayed over TE, and
the PSIF echo, the refocused F+(-1) decayed over the full TR =
TE + mid + TE2 -- which, after the folded unit shift, is the new A(0)
row.  The state is the folded half-ladder of the FISP kernel (six planes
of nstate + 1 rows), so nstate >= 1.

The kernels are ``epgpy_torch/csrc/dess.cu`` and ``dess_jac.cu`` (see
their headers for the design); ``dess_echoes_plain`` /
``dess_jacobian_echoes_plain`` are the same recurrences with the same
operation order, vectorised over atoms as (6, nstate+1, B) planes in a
Python loop over TRs, in any precision (float64 makes them oracles).
Both kernels run the segmented layout with blocked rows, the state in
registers, at the geometry :func:`dess_geometry` (the primal: a ladder of
up to 12 rows on one lane) and :func:`dess_jac_geometry` decide.
The echo-layout functions (``dess_echoes``, ``dess_jacobian_echoes`` and
their twins) return the train's ADC order, FISP_0, PSIF_0, FISP_1, ... on
the first axis, (2P, B): the engine's layout, which the kernels write
directly; ``dess_dictionary_*`` / ``dess_jacobian_*`` return the JAX
functions' per-echo (B, P) views of it.

``*_cuda`` takes the kernel for CUDA tensors (and raises on what it does
not take: no fallback) and the plain twin for CPU tensors.  ``LAUNCHES`` /
``JAC_LAUNCHES`` count kernel launches.  The TPU-only knobs (``btile``,
``pchunk``, ``interpret``) and the padding have no counterpart.  The
gates are the FISP kernels' (``cuda_fisp.kernel_fits``: 6 planes;
``cuda_fisp.jac_kernel_fits``: 24 planes), the bounds of the
thread-per-atom layout, kept so that no train changes route.
"""

from __future__ import annotations

import math

import torch

from . import planes
from .cuda_fisp import (SMEM_PER_BLOCK, _jac_views, _prepare, _takes_twin,
                        jac_kernel_fits, kernel_fits, seg_geometry)

__all__ = ["dess_dictionary_cuda", "dess_dictionary_plain", "dess_echoes",
           "dess_echoes_plain", "dess_jacobian_cuda", "dess_jacobian_plain",
           "dess_jacobian_echoes", "dess_jacobian_echoes_plain",
           "dess_rows", "dess_geometry", "dess_jac_geometry", "LAUNCHES",
           "JAC_LAUNCHES"]

#: primal kernel launches so far (diagnostics: proves a run went through it)
LAUNCHES = 0
#: Jacobian kernel launches so far
JAC_LAUNCHES = 0

_TWO_PI = 2 * math.pi
_DEG = math.pi / 180.0
#: floats the Jacobian kernel stages per atom and pulse: (re, im) of four
#: groups for both echoes
DESS_JAC_OUTPUTS = 16


#: the primal kernel (dess.cu): warps per block, TRs per chunk, table
#: floats per TR, rows per lane at most -- the kernel's kMaxWarps,
#: epg::kTabPulses, the table's two float4 and kMaxRows
DESS_WARPS, DESS_TRS, DESS_TABLE, DESS_MAX_ROWS = 4, 32, 8, 12


def dess_rows(nstate) -> int:
    """Rows per lane of the primal kernel for a ladder of H = nstate + 1
    rows (nstate >= 1): ceil(H / W) for the fewest lanes W that keep it
    within DESS_MAX_ROWS -- H on one lane up to nstate 11 (the instance of
    its length: the mapping train's nstate 8 takes 9 rows), odd R included
    (7 on 2 lanes at nstate 12, 12 on 26 lanes at the gate's 301)."""
    H = max(int(nstate), 1) + 1
    return -(-H // -(-H // DESS_MAX_ROWS))


def dess_geometry(nstate):
    """Launch geometry of the primal kernel (``dess.cu``) at
    :func:`dess_rows` rows per lane: dict(R, W, L) (lane r of a segment
    of W lanes owns rows r R + c, c < R; L ladders per warp), ``one`` (the
    ladder is the one lane's R rows: the instance of its length),
    ``warps`` per block (DESS_WARPS), ``atoms`` per block (warps x L),
    ``pulses`` (TRs per chunk, DESS_TRS) and ``smem``, the block's shared
    bytes: the chunk's table alone (each ladder's row-0 lane stores both
    echoes directly).  The wrapper passes R and warps to the kernel, which
    checks them."""
    H = max(int(nstate), 1) + 1
    R = dess_rows(nstate)
    W = -(-H // R)
    L = 32 // W
    return dict(R=R, W=W, L=L, one=W == 1, warps=DESS_WARPS,
                atoms=DESS_WARPS * L, pulses=DESS_TRS,
                smem=4 * DESS_TRS * DESS_TABLE)


def dess_jac_rows(nstate) -> int:
    """Rows per lane of the Jacobian kernel for a ladder of H = nstate + 1
    rows: 1 up to 3 rows, 2 up to 6, 3 above (the mapping's H = 9 fills
    three lanes exactly; W = ceil(H / 3) <= 25 lanes at the gate's
    H = 75)."""
    H = int(nstate) + 1
    return 1 if H <= 3 else 2 if H <= 6 else 3


def dess_jac_geometry(nstate):
    """Launch geometry of the segmented Jacobian kernel (``dess_jac.cu``):
    ``cuda_fisp.seg_geometry`` at :func:`dess_jac_rows` rows per lane with
    DESS_JAC_OUTPUTS staged floats per atom and pulse; the launch passes R,
    ``warps`` and ``pulses`` to the kernel, which checks them and dispatches
    on R."""
    return seg_geometry(nstate, DESS_JAC_OUTPUTS, R=dess_jac_rows(nstate))


def _setup(FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate, strict):
    if int(nstate) < 1:
        raise ValueError("the PSIF echo reads ladder row 1: nstate >= 1")
    return _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, None, None,
                    strict=strict)


def _relax(TRi, T1, T2, DF):
    """Full-TR coefficients: cZ, the F-plane decay (cF e^{i 2pi df TR}) as
    a (re, im) pair (im None without df), and its T2 derivative."""
    cF = torch.exp(-TRi / T2)
    cZ = torch.exp(-TRi / T1)
    dcZ, dcF = planes.relax_tangents(cZ, cF, TRi, T1, T2)
    if DF is None:
        return cZ, dcZ, (cF, None), (dcF, None)
    ang = _TWO_PI * DF * TRi
    pR, pI = torch.cos(ang), torch.sin(ang)
    return cZ, dcZ, (cF * pR, cF * pI), (dcF * pR, dcF * pI)


def _fmul(c, re, im):
    """(c[0] + i c[1]) (re + i im); a real product when c[1] is None."""
    if c[1] is None:
        return c[0] * re, c[0] * im
    return planes.cmul(c[0], c[1], re, im)


def _relax_exp2(TRi, k1, k2, DF2):
    """The primal kernel's full-TR terms (``epg::relax_exp2``): cZ and the
    F-plane decay 2^(k2 TR) with the phasor of DF2 TR half turns, as a
    (re, im) pair (im None without df), for the atom's k = -log2(e) / T."""
    cF = torch.exp2(k2 * TRi)
    cZ = torch.exp2(k1 * TRi)
    if DF2 is None:
        return cZ, (cF, None)
    c, s = planes.sincospi(DF2 * TRi)
    return cZ, (cF * c, cF * s)


def dess_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                      nstate=10, demodulate=False):
    """Both echo trains (re, im), each (2P, B) in ADC order (FISP_0,
    PSIF_0, ...), by the plain PyTorch recurrence (the kernel's twin), on
    T1s's device in T1s's dtype.  Angles in half turns
    (``planes.sincospi``, the kernel's sincospif), decays by exp2 of the
    atom's -log2(e) / T, as the kernel forms them."""
    x = _setup(FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate, strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    P, B, H = x["P"], x["B"], int(nstate) + 1
    s = [torch.zeros((H, B), dtype=T1.dtype, device=T1.device)
         for _ in range(6)]
    s[4][0] = 1.0
    cp, sp, c2p, s2p = planes.phase_terms_pi(x["phi"] * (1.0 / 180.0))
    DF2 = None if DF is None else 2.0 * DF
    k1, k2 = planes.exp2_rates(T1, T2)
    var_te = isinstance(x["TE"], torch.Tensor)
    if not var_te:
        e2te, pte = planes.exp2_te_terms(x["TE"], k2, DF2)
    out = torch.empty((2, 2 * P, B), dtype=T1.dtype, device=T1.device)
    FA, TR = x["FA"], x["TR"]

    def store(row, i, eR, eI):
        if demodulate:
            eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
        out[0, row] = eR
        out[1, row] = eI

    for i in range(P):
        if var_te:
            e2te, pte = planes.exp2_te_terms(x["TE"][i], k2, DF2)
        ca, sa = planes.sincospi(FA[i] * B1 * (1.0 / 180.0))
        rc = planes.rot_coeffs_sc(sa, ca, cp[i], sp[i], c2p[i], s2p[i])
        cZ, cF = _relax_exp2(TR[i], k1, k2, DF2)
        R = planes.apply_rot(rc, s)
        # FISP echo: the rotated k = 0 row after the TE decay
        eR, eI = R[0][0] * e2te, R[1][0] * e2te
        if pte is not None:
            eR, eI = planes.cmul(pte[0], pte[1], eR, eI)
        store(2 * i, i, eR, eI)
        nZR = cZ * R[4]
        nZR[0] = nZR[0] + (1.0 - cZ)
        s = planes.shift_fold(_fmul(cF, R[0], R[1]) + _fmul(cF, R[2], R[3])
                              + (nZR, cZ * R[5]))
        # PSIF echo: the post-shift A(0) (the relaxed B(1))
        store(2 * i + 1, i, s[0][0], s[1][0])
    return out[0], out[1]


def dess_jacobian_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                               nstate=10, demodulate=False):
    """Echoes (re, im), each (2P, B), and tangents (dre, dim), each
    (2P, B, 3) ordered (T1, T2, B1), rows in ADC order (FISP_0, PSIF_0,
    ...), by the plain PyTorch recurrence (the Jacobian kernel's twin), on
    T1s's device and dtype."""
    x = _setup(FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate, strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    P, B, H = x["P"], x["B"], int(nstate) + 1
    z = torch.zeros((H, B), dtype=T1.dtype, device=T1.device)
    # st[g]: plane set of group g (0 primal, then dT1, dT2, dB1)
    st = [[z.clone() for _ in range(6)] for _ in range(4)]
    st[0][4][0] = 1.0
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * _DEG)
    var_te = isinstance(x["TE"], torch.Tensor)
    if not var_te:
        e2te, de2te, pte = planes.te_terms(x["TE"], T2, DF)
    out = torch.empty((8, 2 * P, B), dtype=T1.dtype, device=T1.device)
    FA, TR = x["FA"], x["TR"]
    for i in range(P):
        if var_te:
            e2te, de2te, pte = planes.te_terms(x["TE"][i], T2, DF)
        a = FA[i] * B1 * _DEG
        rc = planes.rot_coeffs(a, cp[i], sp[i], c2p[i], s2p[i])
        drc = planes.rot_coeffs_db1(a, FA[i] * _DEG, cp[i], sp[i], c2p[i],
                                    s2p[i])
        cZ, dcZ, cF, dcF = _relax(TR[i], T1, T2, DF)

        def write(o, row, eR, eI, te_phase):
            if te_phase and pte is not None:
                eR, eI = planes.cmul(pte[0], pte[1], eR, eI)
            if demodulate:
                eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
            out[2 * o, row] = eR
            out[2 * o + 1, row] = eI

        p0, r1, r2, r3 = (planes.apply_rot(rc, g) for g in st)
        C = planes.apply_rot(drc, st[0])            # B1 coefficient pass
        # FISP echoes (rotated k = 0 rows, TE decay and phase)
        write(0, 2 * i, e2te * p0[0][0], e2te * p0[1][0], True)
        write(1, 2 * i, e2te * r1[0][0], e2te * r1[1][0], True)
        write(2, 2 * i, e2te * r2[0][0] + de2te * p0[0][0],
              e2te * r2[1][0] + de2te * p0[1][0], True)
        write(3, 2 * i, e2te * (r3[0][0] + C[0][0]),
              e2te * (r3[1][0] + C[1][0]), True)

        pZ = cZ * p0[4]
        pZ[0] = pZ[0] + (1.0 - cZ)
        t1Z = cZ * r1[4] + dcZ * p0[4]
        t1Z[0] = t1Z[0] - dcZ
        xa, xb = _fmul(dcF, p0[0], p0[1]), _fmul(dcF, p0[2], p0[3])
        ta, tb = _fmul(cF, r2[0], r2[1]), _fmul(cF, r2[2], r2[3])
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
        ]
        st = [planes.shift_fold(n) for n in new]
        # PSIF echoes: the post-shift A(0) rows (the relaxed B(1); the
        # full-TR dcF term is in the dT2 group already, no TE phase)
        for o in range(4):
            write(o, 2 * i + 1, st[o][0][0], st[o][1][0], False)
    return _jac_views(out)


def dess_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *, nstate=10,
                demodulate=False):
    """Both echo trains (re, im), each (2P, B) float32 in ADC order: the
    CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    kw = dict(nstate=nstate, demodulate=demodulate)
    if _takes_twin(T1s, "DESS"):
        return dess_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs, **kw)
    return _launch(FA, phi, TR, TE, T1s, T2s, B1s, dfs, jac=False, **kw)


def dess_jacobian_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                         nstate=10, demodulate=False):
    """Echoes (2P, B) and tangents (2P, B, 3) in float32, ADC order: the
    CUDA Jacobian kernel for CUDA tensors, the plain twin for CPU tensors."""
    kw = dict(nstate=nstate, demodulate=demodulate)
    if _takes_twin(T1s, "DESS Jacobian"):
        return dess_jacobian_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s,
                                          dfs, **kw)
    return _launch(FA, phi, TR, TE, T1s, T2s, B1s, dfs, jac=True, **kw)


def _launch(FA, phi, TR, TE, T1s, T2s, B1s, dfs, *, nstate, demodulate, jac):
    global LAUNCHES, JAC_LAUNCHES
    from .. import _build

    name = "dess_jac" if jac else "dess"
    if T1s.dtype != torch.float32:
        raise TypeError(f"the {name} kernel computes in float32, got "
                        f"{T1s.dtype}")
    nstate = int(nstate)
    if not (jac_kernel_fits if jac else kernel_fits)(nstate):
        raise ValueError(f"nstate={nstate}: the {name} kernel state does not "
                         f"fit in {SMEM_PER_BLOCK} bytes of shared memory")
    x = _setup(FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate, strict=True)
    P, B = x["P"], x["B"]
    out = torch.empty((8 if jac else 2, 2 * P, B), dtype=torch.float32,
                      device=T1s.device)
    var_te = isinstance(x["TE"], torch.Tensor)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if jac:
        geo = dess_jac_geometry(nstate)
        shape = (geo["R"], geo["warps"], geo["pulses"])
    else:
        geo = dess_geometry(nstate)
        shape = (geo["R"], geo["warps"])
    # asynchronous on the current stream; see cuda_fisp._launch on
    # temporaries
    lib = _build.load()
    fn = lib.epg_dess_jac if jac else lib.epg_dess
    rc = fn(ptr(x["FA"]), ptr(x["phi"]), ptr(x["TR"]),
            ptr(x["TE"]) if var_te else None, 0.0 if var_te else x["TE"],
            ptr(x["T1"]), ptr(x["T2"]), ptr(x["B1"]), ptr(x["df"]), ptr(out),
            P, B, nstate, int(var_te), int(x["df"] is not None),
            int(bool(demodulate)), *shape,
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


def _split(re, im):
    """(FISP, PSIF) pairs of (B, P) views of (2P, B[, G]) ADC-order rows."""
    return tuple((re[e::2].transpose(0, 1), im[e::2].transpose(0, 1))
                 for e in (0, 1))


def dess_dictionary_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                          nstate=10, demodulate=False):
    """DESS trains by the plain PyTorch twin of the kernel.  Arguments and
    returns as :func:`dess_dictionary_cuda`; any device, either
    precision."""
    return _split(*dess_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs,
                                     nstate=nstate, demodulate=demodulate))


def dess_dictionary_cuda(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                         nstate=10, demodulate=False):
    """DESS trains via the fused folded-half-ladder CUDA kernel.

    Args mirror ``dess_dictionary_pallas``: FA (P,) degrees; phi and TR
    (the full TR) scalars or (P,); TE the FISP echo time, a scalar or (P,)
    (the PSIF echo depends only on the full TR); T1s, T2s, B1s and the
    optional off-resonance dfs (kHz) (B,) tensors, whose device selects
    the kernel (CUDA, float32, contiguous) or the plain twin (CPU).
    Returns ((re1, im1), (re2, im2)): the FISP and PSIF trains, each
    (B, P), as views of the kernel's ADC-order output.
    """
    return _split(*dess_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs,
                               nstate=nstate, demodulate=demodulate))


def _jac_split(echoes):
    (re, im), (dre, dim) = echoes
    return _split(re, im), _split(dre, dim)


def dess_jacobian_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                        nstate=10, demodulate=False):
    """Both DESS trains and their Jacobians by the plain PyTorch twin of
    the kernel.  Arguments and returns as :func:`dess_jacobian_cuda`."""
    return _jac_split(dess_jacobian_echoes_plain(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate))


def dess_jacobian_cuda(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                       nstate=10, demodulate=False):
    """Both DESS echo trains + dS/d(T1, T2, B1) in one fused kernel.

    Arguments as :func:`dess_dictionary_cuda`.  Returns ``((re1, im1),
    (re2, im2)), ((j1re, j1im), (j2re, j2im))``: signals (B, P) and
    Jacobians (B, P, 3) ordered (T1, T2, B1) for the FISP and PSIF echoes
    -- the ``dess_jacobian_pallas`` layout, as views of the kernel's
    ADC-order output."""
    return _jac_split(dess_jacobian_echoes(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate))
