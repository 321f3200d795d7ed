"""EPG-X gradient-echo trains and their Jacobian: CUDA kernels, plain twins.

Counterpart of ``epgpy_tpu/models/pallas_xgre.py``: ``xgre_dictionary_pallas``
(:142) with its kernel ``_kernel_xgre`` (:48), ``xgre_jacobian_pallas``
(:400) with ``_kernel_xgre_jac`` (:282), the per-atom stage matrices
``_exchange_mats`` (:118) and their differentiable map
``exchange_stage_mats`` (:235).  The train is the canonical EPG-X
gradient echo over C exchanging compartments (Malik 2018; Gloor 2008 for
the balanced family):

    [ R(sat)? , T(alpha_i, phi_i) , X(tauA)? , ADC , X(tauB)? , S(1)? ] * N

with per-TR, per-compartment flips, phases and saturation factors, and
per-atom exchange stage matrices (the relaxation and exchange of each
stage as expm of the kinetic matrix).  ``shift=False`` is the balanced
family: no gradient, the ladder stays at k = 0 (nstate 0).

The kernels are ``epgpy_torch/csrc/xgre.cu`` and ``xgre_jac.cu`` (see their
headers for the design; both run the segmented layout with blocked rows,
their state in registers, at the geometries :func:`xgre_geometry` and
:func:`xgre_jac_geometry` decide);
``xgre_dictionary_plain`` /
``xgre_jacobian_plain`` are the same recurrences with the same operation
order, vectorised over atoms as (nstate+1, B) planes in a Python loop over
TRs, in any precision, on the tensors' device.  ``*_cuda`` launch the
kernels and raise on CPU tensors and on what the kernels do not take
(C outside 1..4; the Jacobian's variables outside 1..4, C (V + 1) above
12, or its 6 C (V + 1) planes beyond one block's shared memory: the JAX
package's VMEM guard);
``*_echoes`` take the kernel for CUDA tensors and the twin for CPU tensors
(what the dispatch calls).  ``LAUNCHES`` / ``JAC_LAUNCHES`` count kernel
launches.  The TPU-only knobs (``btile``, ``interpret``) and the padding
have no counterpart.  Outputs: (re, im), each (N, C, B); the Jacobian's
tangents (N, V, C, B).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import planes
from .cuda_fisp import (SEG_CHUNK_FLOATS, SEG_PULSES, SEG_WARPS,
                        SMEM_PER_BLOCK, _takes_twin, seg_layout)

__all__ = ["exchange_stage_mats", "xgre_dictionary_cuda",
           "xgre_dictionary_plain", "xgre_dictionary_echoes",
           "xgre_jacobian_cuda", "xgre_jacobian_plain",
           "xgre_jacobian_echoes", "xgre_kernel_fits",
           "xgre_jac_kernel_fits", "xgre_geometry", "xgre_jac_geometry",
           "x_rows", "LAUNCHES", "JAC_LAUNCHES",
           "xgre_dictionary_cuda_sharded"]

#: primal kernel launches so far (diagnostics: proves a run went through it)
LAUNCHES = 0
#: Jacobian kernel launches so far
JAC_LAUNCHES = 0

_DEG = math.pi / 180.0
#: compartments and plane groups (primal + tangents) the kernels take,
#: and the Jacobians' largest C G (72 planes)
MAX_C, MAX_G, MAX_CG = 4, 5, 12


def _smem(nstate, planes_, block):
    return 4 * planes_ * (int(nstate) + 1) * block


def xgre_kernel_fits(nstate, C) -> bool:
    """The primal kernels' gate (xgre and the composite EPG-X): 6 C planes
    of nstate + 1 rows at 32 threads within one block's shared memory --
    nstate <= 301, 150, 99, 74 for C = 1, 2, 3, 4 -- as the thread-per-atom
    layout set it; the segmented kernels keep their state in registers
    (:func:`xgre_geometry`) and keep this gate, so that no train changes
    route."""
    return _smem(nstate, 6 * int(C), 32) <= SMEM_PER_BLOCK


def xgre_jac_kernel_fits(nstate, C, G) -> bool:
    """Whether the Jacobian kernel's 6 C G planes fit at 32 threads."""
    return _smem(nstate, 6 * int(C) * int(G), 32) <= SMEM_PER_BLOCK


#: TR-table floats per compartment of the Jacobian kernel (its kTab: cos
#: phi, sin phi, cos 2phi, sin 2phi, four saturation factors, the flip)
XGRE_JAC_TABLE = 9


def xgre_jac_rows(nstate, C, G) -> int:
    """Rows per lane of the Jacobian kernel: 1 for H = nstate + 1 <= 3,
    else ceil(H / 32), at least 2 while the 6 C G planes of two rows stay
    within 72 floats (C G <= 6); the gate's deepest ladders take 5 rows (C
    G = 2, H 151), 4 (C G = 3, H 100), 3 (C G = 4, H 75), 2 (C G <= 9) and
    1 (C G >= 10)."""
    H = int(nstate) + 1
    if H <= 3:
        return 1
    return max(-(-H // 32), 2 if int(C) * int(G) <= 6 else 1)


def xgre_jac_geometry(nstate, C, G):
    """Launch geometry of the segmented Jacobian kernel (``xgre_jac.cu``):
    dict(R, W, L) of ``cuda_fisp.seg_layout`` at :func:`xgre_jac_rows`'
    rows per lane, ``warps`` per block (SEG_WARPS, halved while the
    block's coefficient table, one record of ``coef`` floats per ladder --
    6 C^2 G + C G, rounded up to odd -- and one TR's table and staged
    echoes pass SEG_CHUNK_FLOATS), ``atoms`` per block (warps x L),
    ``pulses`` (TRs) per chunk and ``smem``, the block's shared bytes.
    The wrapper passes R, warps and pulses to the kernel, which checks
    them."""
    C, G = int(C), int(G)
    R, W, L = seg_layout(nstate, xgre_jac_rows(nstate, C, G))
    coef = (6 * C * C * G + C * G) | 1
    return dict(R=R, W=W, L=L, **_chunk_geometry(
        coef, XGRE_JAC_TABLE * C, 2 * G * C, L))


#: floats of state a lane of the primal kernels holds at most (6 C R), and
#: their TR-table floats per compartment (epg::kXTab: cos phi, sin phi, cos
#: 2phi, sin 2phi, four saturation factors, the flip, its flags)
X_STATE, X_TABLE = 72, 10


def x_rows(nstate, C) -> int:
    """Rows per lane of the primal kernels (xgre.cu, xcomposite.cu) for a
    ladder of H = nstate + 1 rows over C pools, each lane holding all 6 C
    planes of its rows, at most X_STATE floats (R <= 12 / C): ceil(H / W)
    for the fewest lanes W within that -- H when one lane holds the ladder
    (the instance of its length: every C at nstate 0, up to 12 rows at C =
    1, 6 at C = 2); 6 rows on 2 lanes at the MT-GRE train's nstate 10, 5 on
    2 at the MT-prepared train's 8.  Padding rows cost as much as rows, and
    of two layouts with as many rows the one with fewer lanes measured
    faster (PERF.md)."""
    H, top = max(int(nstate), 0) + 1, X_STATE // (6 * int(C))
    return -(-H // -(-H // top))


def xgre_geometry(nstate, C):
    """Launch geometry of the segmented primal kernel (``xgre.cu``):
    dict(R, W, L) of ``cuda_fisp.seg_layout`` at :func:`x_rows`' rows per
    lane (lane r of a segment owns rows r R + k, k < R), ``one`` (the
    ladder is the one lane's R rows: the instance of its length),
    ``warps`` per block (SEG_WARPS, halved while the block's coefficient
    table, one record of ``coef`` = 6 C^2 floats rounded up to odd per
    ladder, and one TR's table and staged echoes pass SEG_CHUNK_FLOATS),
    ``atoms`` per block (warps x L), ``pulses`` (TRs) per chunk and
    ``smem``, the block's shared bytes.  The wrapper passes R, warps and
    pulses to the kernel, which checks them."""
    C = int(C)
    R, W, L = seg_layout(nstate, x_rows(nstate, C))
    coef = (6 * C * C) | 1
    geo = _chunk_geometry(coef, X_TABLE * C, 2 * C, L)
    return dict(R=R, W=W, L=L, one=R == int(nstate) + 1, **geo)


def _chunk_geometry(coef, table, outputs, L):
    """warps, atoms, pulses, coef and smem of a segmented kernel whose
    blocks hold `coef` floats per ladder and, per pulse, `table` floats
    and `outputs` staged floats per ladder, L ladders per warp: SEG_WARPS
    halved while the records and one pulse pass SEG_CHUNK_FLOATS, then as
    many pulses (at most SEG_PULSES) as fit."""
    def per(atoms):
        return table + outputs * atoms

    warps = SEG_WARPS
    while warps > 1 and coef * warps * L + per(warps * L) > SEG_CHUNK_FLOATS:
        warps //= 2
    A = warps * L
    pulses = min(SEG_PULSES, (SEG_CHUNK_FLOATS - coef * A) // per(A))
    return dict(warps=warps, atoms=A, pulses=pulses, coef=coef,
                smem=4 * (coef * A + pulses * per(A)))


def _cdtype(dt):
    return torch.complex128 if dt == torch.float64 else torch.complex64


def _like(x, ref, dtype=None):
    """`x` as a tensor on ref's device in ref's dtype (or `dtype`)."""
    dtype = ref.dtype if dtype is None else dtype
    if isinstance(x, torch.Tensor):
        return x.to(device=ref.device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                           device=ref.device)


def exchange_stage_mats(khi, T1, T2, g=None, tau=1.0):
    """Differentiable per-atom exchange stage matrices ``(mr, mi, ml)``.

    The map from physical parameters to the Jacobian entry points' stage
    matrices: run ``torch.func.jvp`` of it once per fit variable to obtain
    the tangents.  khi: kinetic matrix, (C, C) shared or (C, C, B) per
    atom; T1, T2: (C, B) per compartment and atom (ms); g: optional (C, B)
    off-resonance (kHz); tau: scalar mixing time (ms).  Tensors in, their
    device and real dtype out (T2 must be a tensor; the others may be host
    values).  Returns three (B, C, C) real tensors: the transverse mixing
    matrix's real and imaginary parts and the (real) longitudinal one.
    Two compartments use the closed-form 2x2 spectral exponential
    (``ops.exchange._expm2``), more ``torch.linalg.matrix_exp``.
    """
    from ..ops.exchange import _expm

    T2 = T2 if isinstance(T2, torch.Tensor) else torch.as_tensor(
        np.asarray(T2, dtype=np.float32))
    dt, cdt = T2.dtype, _cdtype(T2.dtype)
    T1 = _like(T1, T2)
    C = T2.shape[0]
    khi = _like(khi, T2)
    if khi.ndim == 2:
        khi = khi[:, :, None]
    gv = torch.zeros_like(T2) if g is None else _like(g, T2)
    eye = torch.eye(C, dtype=dt, device=T2.device)[:, :, None].to(cdt)
    rT = (-1.0 / T2).to(cdt) + 2j * math.pi * gv.to(cdt)        # (C, B)
    rL = (-1.0 / T1).to(cdt)
    xT = -khi.to(cdt) + eye * rT[:, None, :]
    xL = -khi.to(cdt) + eye * rL[:, None, :]
    tau = _like(tau, T2).to(cdt)
    mT = _expm(torch.movedim(xT * tau, -1, 0))                  # (B, C, C)
    mL = _expm(torch.movedim(xL * tau, -1, 0)).real
    return mT.real, mT.imag, mL


def _exchange_mats(khi, T1, T2, g, tau):
    """Per-atom (mT, mr, mi, ml) of one stage, (B, C, C): khi (C, C),
    T1/T2/g (C, B), tau a scalar; tau == 0 (with khi = 0: an absent stage)
    yields identities."""
    mr, mi, ml = exchange_stage_mats(khi, T1, T2, g, tau)
    return torch.complex(mr, mi), mr, mi, ml


def _rows(m):
    """(..., B, C, C) -> (..., C C, B): the kernels' coefficient rows."""
    sh = m.shape
    return torch.movedim(m.reshape(sh[:-2] + (sh[-2] * sh[-1],)), -1, -2)


def _train(alpha, phi, satf_re, satf_im, satz_re, satz_im, ref, strict):
    """The (N, C) per-TR tables as tensors on ref's device and dtype
    (phi and the saturation factors broadcast from scalars or rows).  With
    `strict` (the kernels) a tensor of another device or dtype, or a
    non-contiguous one, raises."""
    a = alpha if isinstance(alpha, torch.Tensor) else np.asarray(alpha)
    if a.ndim != 2:
        raise ValueError(f"alpha: expected (N, C), got {tuple(a.shape)}")
    N, C = int(a.shape[0]), int(a.shape[1])
    out = {}
    for name, x in (("alpha", alpha), ("phi", phi), ("sfr", satf_re),
                    ("sfi", satf_im), ("szr", satz_re), ("szi", satz_im)):
        if isinstance(x, torch.Tensor) and strict and (
                x.device != ref.device or x.dtype != ref.dtype
                or not x.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {ref.dtype} "
                             f"tensor on {ref.device}, got {x.dtype} on "
                             f"{x.device}")
        t = _like(x, ref)
        out[name] = torch.broadcast_to(t, (N, C)).contiguous()
    return out, N, C


def _b1_row(b1, ref, B):
    if b1 is None:
        return torch.ones(B, dtype=ref.dtype, device=ref.device)
    b1 = _like(b1, ref).reshape(-1)
    if b1.shape[0] != B:
        raise ValueError(f"b1: expected ({B},), got {tuple(b1.shape)}")
    return b1.contiguous()


def _stage_coef(stageA, stageB, ref):
    """The primal's (6 C C, B) coefficient rows: stage A then B, each mT
    re, mT im, mL."""
    rows = []
    for khi, T1, T2, g, tau in (stageA, stageB):
        _, mr, mi, ml = _exchange_mats(khi, _like(T1, ref), _like(T2, ref),
                                       None if g is None else _like(g, ref),
                                       tau)
        rows += [_rows(mr), _rows(mi), _rows(ml)]
    return torch.cat(rows).contiguous()


def _jac_coef(matsA, matsB, dmatsA, dmatsB, ref):
    """The Jacobian's (G 6 C C, B) coefficient rows: per group (primal,
    then each variable's tangent) stage A then B, each mr, mi, ml."""
    V = int(dmatsA[0].shape[0])
    groups = [(matsA, matsB)] + [(tuple(d[v] for d in dmatsA),
                                  tuple(d[v] for d in dmatsB))
                                 for v in range(V)]
    rows = [_rows(_like(m, ref)) for mA, mB in groups for m in mA + mB]
    return torch.cat(rows).contiguous(), V


def _jac_dens(dens, ddens, C, B, V, ref):
    """(G C, B) density rows: the densities then each variable's
    tangents ((C,) or (C, B); (V, C) or (V, C, B))."""
    dens = _like(dens, ref)
    if dens.ndim == 1:
        dens = dens[:, None]
    ddens = _like(ddens, ref)
    if ddens.ndim == 2:
        ddens = ddens[:, :, None]
    rows = torch.cat([torch.broadcast_to(dens, (C, B)),
                      torch.broadcast_to(ddens, (V, C, B)).reshape(V * C,
                                                                   B)])
    return rows.contiguous()


def _twin(tr, b1, coef, dens, nstate, shift):
    """The kernels' recurrence: tr the (N, C) tables, b1 (B,), coef (G, 2,
    3, C, C, B) stage coefficients, dens (G, C, B') densities (B' = B or
    1).  Returns (2, N, G, C, B): (re, im) of F0 per TR, group and
    compartment."""
    N, C = tr["alpha"].shape
    G, B, H = coef.shape[0], b1.shape[0], int(nstate) + 1
    dt, dev = b1.dtype, b1.device
    st = [[_unit_set(H, B, dt, dev, g == 0) for _ in range(C)]
          for g in range(G)]
    out = torch.empty((2, N, G, C, B), dtype=dt, device=dev)
    cp, sp, c2p, s2p = planes.phase_terms(tr["phi"] * _DEG)
    for i in range(N):
        rc = [planes.rot_coeffs(tr["alpha"][i, c] * _DEG * b1, cp[i, c],
                                sp[i, c], c2p[i, c], s2p[i, c])
              for c in range(C)]
        sat = [(tr["sfr"][i, c], tr["sfi"][i, c], tr["szr"][i, c],
                tr["szi"][i, c]) for c in range(C)]
        x = [[planes.apply_rot(rc[c], _saturate(st[g][c], sat[c]))
              for c in range(C)] for g in range(G)]
        y = _mix_groups(x, lambda g, p, a, b_: coef[g, 0, p, a, b_], dens)
        for g in range(G):
            for c in range(C):
                out[0, i, g, c], out[1, i, g, c] = y[g][c][0][0], \
                    y[g][c][1][0]
        z = _mix_groups(y, lambda g, p, a, b_: coef[g, 1, p, a, b_], dens)
        st = [[planes.shift_fold(s) if shift else s for s in zg]
              for zg in z]
    return out


def _unit_set(H, B, dt, dev, primal):
    """A plane set of zeros with Z(0) = 1 for the primal."""
    s = [torch.zeros((H, B), dtype=dt, device=dev) for _ in range(6)]
    if primal:
        s[4][0] = 1.0
    return tuple(s)


def _saturate(s, f):
    """The saturation of one plane set before the pulse: A and B times
    conj(e^{-rT}) = f[0] + i f[1], Z times e^{-rL} = f[2] + i f[3]."""
    ar, ai = planes.cmul(f[0], f[1], s[0], s[1])
    br, bi = planes.cmul(f[0], f[1], s[2], s[3])
    zr, zi = planes.cmul(f[2], f[3], s[4], s[5])
    return ar, ai, br, bi, zr, zi


def _mix_groups(sets, m, dens):
    """One exchange stage on every group: sets[g][c] plane sets, m(g, part,
    i, j) the coefficients, dens (G, C, B') the densities and their
    tangents; the tangents are mixed first, from the pre-mix primal."""
    out = [None] * len(sets)
    for g in range(1, len(sets)):
        out[g] = planes.mix_tangent(
            sets[g], sets[0], lambda p, i, j: m(0, p, i, j),
            lambda p, i, j, g=g: m(g, p, i, j), lambda j: dens[0, j],
            lambda j, g=g: dens[g, j])
    out[0] = planes.mix_planes(sets[0], lambda p, i, j: m(0, p, i, j),
                               lambda j: dens[0, j])
    return out


def _check_stage(stage, what):
    if len(stage) != 5:
        raise ValueError(f"{what}: expected (khi, T1, T2, g, tau)")


def _primal_setup(alpha, phi, satf_re, satf_im, satz_re, satz_im, dens,
                  stageA, stageB, b1, strict):
    _check_stage(stageA, "stageA")
    _check_stage(stageB, "stageB")
    ref = stageA[2]
    if not isinstance(ref, torch.Tensor) or ref.ndim != 2:
        raise TypeError("stageA's T2 must be a (C, B) tensor: its device "
                        "selects the kernel (CUDA) or the plain twin (CPU)")
    tr, N, C = _train(alpha, phi, satf_re, satf_im, satz_re, satz_im, ref,
                      strict)
    B = int(ref.shape[1])
    if ref.shape[0] != C:
        raise ValueError(f"stageA's T2 has {ref.shape[0]} compartments, "
                         f"alpha {C}")
    dens = _like(dens, ref).reshape(-1)
    if dens.shape[0] != C:
        raise ValueError(f"dens: expected ({C},), got {tuple(dens.shape)}")
    coef = _stage_coef(stageA, stageB, ref)
    return tr, _b1_row(b1, ref, B), coef, dens.contiguous(), ref, N, C, B


def xgre_dictionary_plain(alpha, phi, satf_re, satf_im, satz_re, satz_im,
                          dens, stageA, stageB, b1=None, *, nstate,
                          shift=True):
    """EPG-X GRE echo trains (re, im), each (N, C, B), by the plain PyTorch
    recurrence (the kernel's twin), on stageA's T2's device and dtype.
    Arguments as :func:`xgre_dictionary_cuda`."""
    tr, b1, coef, dens, ref, N, C, B = _primal_setup(
        alpha, phi, satf_re, satf_im, satz_re, satz_im, dens, stageA, stageB,
        b1, strict=False)
    out = _twin(tr, b1, coef.reshape(1, 2, 3, C, C, B),
                dens.reshape(1, C, 1), nstate, shift)
    return out[0, :, 0], out[1, :, 0]


def xgre_dictionary_cuda(alpha, phi, satf_re, satf_im, satz_re, satz_im,
                         dens, stageA, stageB, b1=None, *, nstate,
                         shift=True):
    """EPG-X GRE trains through the CUDA kernel (xgre.cu).

    Args mirror ``xgre_dictionary_pallas``: alpha, phi (N, C) per-TR
    per-compartment flips and phases (degrees); satf_re/im, satz_re/im
    (N, C) saturation factors applied before the pulse -- conj(e^{-rT}) on
    the F+ states, e^{-rL} on Z (1 + 0i when absent); dens (C,)
    equilibrium densities; stageA, stageB the two exchange stages as
    ``(khi, T1, T2, g, tau)`` -- khi (C, C), T1/T2/g (C, B) per compartment
    and atom (g may be None), tau ms (0 with khi = 0: an absent stage);
    b1 optional (B,) flip scale (rank-1 ``outer(alpha_ic, B1)`` trains);
    nstate the ladder capacity (0 for a balanced train); shift False for
    the balanced family.  stageA's T2 is a float32 CUDA tensor; tensor
    arguments of the train must be float32, contiguous and on its device.
    Returns (re, im): (N, C, B) float32 F0 per TR and compartment."""
    global LAUNCHES
    tr, b1, coef, dens, ref, N, C, B = _primal_setup(
        alpha, phi, satf_re, satf_im, satz_re, satz_im, dens, stageA, stageB,
        b1, strict=True)
    _cuda_ref(ref, "xgre")
    nstate = _check_nstate(nstate, shift)
    if not 1 <= C <= MAX_C or not xgre_kernel_fits(nstate, C):
        raise ValueError(f"C={C}, nstate={nstate}: the xgre kernel takes 1 "
                         f"to {MAX_C} compartments whose 6 C planes fit in "
                         f"{SMEM_PER_BLOCK} bytes of shared memory")
    out = torch.empty((2, N, C, B), dtype=torch.float32, device=ref.device)
    geo = xgre_geometry(nstate, C)
    lib, dev, stream = _launch_env(ref)
    rc = lib.epg_xgre(*(tr[k].data_ptr() for k in ("alpha", "phi", "sfr",
                                                   "sfi", "szr", "szi")),
                      dens.data_ptr(), b1.data_ptr(), coef.data_ptr(),
                      out.data_ptr(), N, C, B, nstate, int(bool(shift)),
                      geo["R"], geo["warps"], geo["pulses"], dev, stream)
    if rc != 0:
        raise RuntimeError(f"xgre kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out[0], out[1]


def _jac_setup(alpha, phi, satf_re, satf_im, satz_re, satz_im, dens, matsA,
               matsB, dmatsA, dmatsB, ddens, b1, strict):
    ref = matsA[0]
    if not isinstance(ref, torch.Tensor) or ref.ndim != 3:
        raise TypeError("matsA[0] must be a (B, C, C) tensor: its device "
                        "selects the kernel (CUDA) or the plain twin (CPU)")
    tr, N, C = _train(alpha, phi, satf_re, satf_im, satz_re, satz_im, ref,
                      strict)
    B = int(ref.shape[0])
    coef, V = _jac_coef(matsA, matsB, dmatsA, dmatsB, ref)
    drows = _jac_dens(dens, ddens, C, B, V, ref)
    return tr, _b1_row(b1, ref, B), coef, drows, ref, N, C, B, V


def xgre_jacobian_plain(alpha, phi, satf_re, satf_im, satz_re, satz_im,
                        dens, matsA, matsB, dmatsA, dmatsB, ddens, b1=None,
                        *, nstate, shift=True):
    """Signals and tangents by the plain PyTorch recurrence (the Jacobian
    kernel's twin); arguments and returns as :func:`xgre_jacobian_cuda`."""
    tr, b1, coef, drows, ref, N, C, B, V = _jac_setup(
        alpha, phi, satf_re, satf_im, satz_re, satz_im, dens, matsA, matsB,
        dmatsA, dmatsB, ddens, b1, strict=False)
    G = V + 1
    out = _twin(tr, b1, coef.reshape(G, 2, 3, C, C, B),
                drows.reshape(G, C, B), nstate, shift)
    return _jac_views(out)


def xgre_jacobian_cuda(alpha, phi, satf_re, satf_im, satz_re, satz_im,
                       dens, matsA, matsB, dmatsA, dmatsB, ddens, b1=None,
                       *, nstate, shift=True):
    """EPG-X GRE train and its tangents in one CUDA kernel (xgre_jac.cu).

    Args mirror ``xgre_jacobian_pallas``: the (N, C) train as
    :func:`xgre_dictionary_cuda`; dens (C, B) per-atom densities (or (C,)
    shared); matsA, matsB the stages' ``(mr, mi, ml)``, each (B, C, C)
    (identities for an absent stage; from :func:`exchange_stage_mats`);
    dmatsA, dmatsB their per-variable tangents, each (V, B, C, C) x 3;
    ddens (V, C, B) (or (V, C)) density tangents; b1 optional (B,) flip
    scale (a constant of the fit).  The variables must enter only through
    the matrices and densities.  matsA[0] is a float32 CUDA tensor.
    Raises ValueError for V outside 1..4, C (V + 1) above 12, or when the
    6 C (V + 1) planes do not fit in shared memory.  Returns ``(re, im),
    (jre, jim)``: (N, C, B) signals and (N, V, C, B) tangents, float32."""
    global JAC_LAUNCHES
    tr, b1, coef, drows, ref, N, C, B, V = _jac_setup(
        alpha, phi, satf_re, satf_im, satz_re, satz_im, dens, matsA, matsB,
        dmatsA, dmatsB, ddens, b1, strict=True)
    _cuda_ref(ref, "xgre_jac")
    G = V + 1
    nstate = _check_nstate(nstate, shift)
    _check_jac_fits("xgre_jac", C, G, nstate)
    out = torch.empty((2, N, G, C, B), dtype=torch.float32,
                      device=ref.device)
    geo = xgre_jac_geometry(nstate, C, G)
    lib, dev, stream = _launch_env(ref)
    rc = lib.epg_xgre_jac(*(tr[k].data_ptr() for k in ("alpha", "phi", "sfr",
                                                       "sfi", "szr", "szi")),
                          b1.data_ptr(), drows.data_ptr(), coef.data_ptr(),
                          out.data_ptr(), N, C, G, B, nstate,
                          int(bool(shift)), geo["R"], geo["warps"],
                          geo["pulses"], dev, stream)
    if rc != 0:
        raise RuntimeError(f"xgre_jac kernel launch failed: CUDA error {rc}")
    JAC_LAUNCHES += 1
    return _jac_views(out)


def _jac_views(out):
    """((re, im), (jre, jim)) views of a (2, N, G, C, B) buffer: (N, C, B)
    signals and (N, V, C, B) tangents."""
    return (out[0, :, 0], out[1, :, 0]), (out[0, :, 1:], out[1, :, 1:])


def _check_nstate(nstate, shift):
    nstate = int(nstate)
    if nstate < 0 or (shift and nstate < 1):
        raise ValueError(f"nstate={nstate}: must be >= 0, and >= 1 for a "
                         f"spoiled (shifting) train")
    return nstate


def _check_jac_fits(name, C, G, nstate):
    """The Jacobian entry points' guard (the JAX package's VMEM guard):
    1..4 compartments, 1..4 variables with C (V + 1) <= 12, 6 C G planes
    in shared memory."""
    if not 1 <= C <= MAX_C or not 2 <= G <= MAX_G or C * G > MAX_CG:
        raise ValueError(f"{name}: C={C} compartments and {G - 1} variables;"
                         f" the kernel takes 1 to {MAX_C} compartments and 1"
                         f" to {MAX_G - 1} variables per pass with C (V + 1)"
                         f" <= {MAX_CG}")
    if not xgre_jac_kernel_fits(nstate, C, G):
        raise ValueError(f"{name} shared-memory budget exceeded: 6 C G = "
                         f"{6 * C * G} planes of nstate + 1 = {nstate + 1} "
                         f"rows at 32 threads need "
                         f"{_smem(nstate, 6 * C * G, 32)} bytes of "
                         f"{SMEM_PER_BLOCK}; reduce nstate or fit fewer "
                         f"variables per pass")


def _cuda_ref(ref, name):
    if ref.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors (got "
                         f"{ref.device}); the plain twin runs elsewhere")
    if ref.dtype != torch.float32:
        raise TypeError(f"the {name} kernel computes in float32, got "
                        f"{ref.dtype}")


def _launch_env(ref):
    """(library, device index, stream) for a launch beside `ref`: the
    launch is asynchronous on PyTorch's current stream (see
    cuda_fisp._launch on temporaries)."""
    from .. import _build

    dev = (ref.device.index if ref.device.index is not None
           else torch.cuda.current_device())
    return _build.load(), dev, torch.cuda.current_stream(
        ref.device).cuda_stream


def xgre_dictionary_echoes(*args, **kw):
    """:func:`xgre_dictionary_cuda` for CUDA tensors,
    :func:`xgre_dictionary_plain` for CPU tensors."""
    fn = xgre_dictionary_plain if _takes_twin(args[7][2], "xgre") \
        else xgre_dictionary_cuda
    return fn(*args, **kw)


def xgre_dictionary_cuda_sharded(alpha, phi, satf_re, satf_im, satz_re,
                                 satz_im, dens, stageA, stageB, b1=None, *,
                                 mesh, axis="atoms", **kw):
    """Atom-sharded EPG-X GRE dictionary over a device mesh
    (``xgre_dictionary_pallas_sharded``): each entry of the mesh's `axis`
    runs :func:`xgre_dictionary_cuda` (the plain twin on a CPU entry) on
    its atom shard -- axis 1 of the stages' (C, B) T1, T2 and g, b1 (B,)
    with them; the axis size must divide the atom count, the train and the
    stages' khi and tau are replicated.  Returns (re, im), each (N, C, B),
    on the mesh's first device."""
    from ..parallel.mesh import shard_map

    def local(t1a, t2a, ga, t1b, t2b, gb, b1s, rest, *train):
        (khia, taua), (khib, taub) = rest
        return xgre_dictionary_echoes(
            *train, (khia, t1a, t2a, ga, taua), (khib, t1b, t2b, gb, taub),
            b1s, **kw)

    stage_planes = [(stage[k], 1) for stage in (stageA, stageB)
                    for k in (1, 2, 3)]
    return shard_map(local, mesh, stage_planes + [(b1, 0)], axis=axis,
                     out_dim=2,
                     replicated=(((stageA[0], stageA[4]),
                                  (stageB[0], stageB[4])),
                                 alpha, phi, satf_re, satf_im, satz_re,
                                 satz_im, dens))


def xgre_jacobian_echoes(*args, **kw):
    """:func:`xgre_jacobian_cuda` for CUDA tensors,
    :func:`xgre_jacobian_plain` for CPU tensors."""
    fn = xgre_jacobian_plain if _takes_twin(args[7][0], "xgre Jacobian") \
        else xgre_jacobian_cuda
    return fn(*args, **kw)
