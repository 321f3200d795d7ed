"""Per-pulse MRF Jacobian/Hessian: the CUDA kernel and its plain twin.

Counterpart of ``epgpy_tpu/models/pallas_hessian.py:fisp_hessian_pallas``
(:383) with its kernel ``_kernel_hess`` (:83).  The train is the FISP
differentiation workload

    [T(FA_i, phi_i), E(TAU_i, T1, T2), ADC, S(1)] * N          (te=None)
    [T(FA_i, phi_i), E(TE), ADC, E(TAU_i), S(1)] * N            (te=TE)

optionally after a perfect 180 inversion and ``inversion`` ms of
relaxation.  Per atom, the outputs are the signal and dS/dT1, dS/dT2 at
every echo j, and per pulse variable i (the "lane") dS_j/dalpha_i,
dS_j/dtau_i and, with ``second_order``, d2S_j/dT1 dalpha_i,
d2S_j/dT2 dalpha_i, d2S_j/dT1 dtau_i, d2S_j/dT2 dtau_i.  Every tangent
propagates by the primal's own per-pulse operator plus seed terms (see the
JAX module's docstring), so it is one pass over nine groups of folded
plane sets: P, U1, U2 per atom, A, T, W1, W2, X1, X2 per lane.  A lane is
exactly zero before its pulse, so outputs with i > j are exact zeros.

``fisp_hessian_cuda`` takes the kernel (``epgpy_torch/csrc/fisp_hess.cu``)
for CUDA tensors and raises on what it does not take; for CPU tensors it
runs ``fisp_hessian_plain``, the same recurrence vectorised over (rows,
atoms, lanes), in any precision.  The kernel runs it in two passes on the
segmented layout (see its header): an atom pass over P, U1, U2 that keeps
their rows before every pulse in a seed scratch the wrapper allocates, then
a lane pass whose ladders are (atom, chain, lane) -- ``hess_geometry`` gives
both passes' launch geometry.  ``HESS_LAUNCHES`` counts kernel launches (one
per call: both passes).  The TPU-only knobs of the JAX signature
(``pchunk``, ``interpret``, the lane padding) are not taken.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import planes
from .cuda_fisp import SMEM_PER_BLOCK, _takes_twin, seg_layout

__all__ = ["fisp_hessian_cuda", "fisp_hessian_plain", "hess_kernel_fits",
           "hess_geometry", "HESS_LAUNCHES",
           "fisp_hessian_cuda_sharded"]

#: Hessian kernel launches so far (diagnostics: proves a run went through it)
HESS_LAUNCHES = 0

#: per-lane plane groups: A, T (first order), W1, W2, X1, X2 (second)
_LANE_NAMES = ("dalpha", "dtau", "dT1dalpha", "dT2dalpha", "dT1dtau",
               "dT2dtau")
#: warps per lane-pass block and pulses per chunk (the kernel's
#: kWarps and kPulses)
HESS_WARPS, HESS_PULSES = 16, 32


def _lane_groups(second_order):
    return 6 if second_order else 2


def hess_kernel_fits(nstate, second_order=True) -> bool:
    """The Hessian kernel's gate: nstate <= 46 (second order), <= 126
    (first), where the thread-per-lane layout's lane groups (6 planes x
    nstate + 1 rows each) and two buffers of the 36-float per-atom rows
    fitted 32 lanes in one block's shared memory.  The two-pass kernel
    keeps its state in registers (:func:`hess_geometry`) and keeps this
    gate, so that no train changes route."""
    H = int(nstate) + 1
    return 4 * (6 * _lane_groups(second_order) * H * 32 + 72 * H) \
        <= SMEM_PER_BLOCK


def hess_geometry(nstate, second_order=True):
    """Launch geometry of the two-pass Hessian kernel for a ladder of H =
    nstate + 1 rows: ``R`` rows per lane (2; 1 for H <= 3; ceil(H / 32)
    past 64 rows, 4 at the first-order gate's 127), ``W`` = ceil(H / R)
    lanes per ladder, ``L`` = 32 // W ladders per warp, HESS_WARPS
    ``warps`` per lane-pass block; ``atoms`` per atom-pass block (one
    warp: L) and ``lanes`` per lane-pass block (warps x L); ``seed``, the
    scratch floats per (pulse, atom) (6 C planes of W R rows, C = 3 groups
    at second order, 1 at first); ``smem``, a lane-pass block's shared
    bytes (its staged echoes, 2 C x HESS_PULSES x lanes floats, and its
    table of 36 floats per pulse).  The launch passes R to the kernel,
    which dispatches on it, and sizes the seed scratch from it."""
    H = int(nstate) + 1
    R, W, L = seg_layout(nstate, 1 if H <= 3 else (2 if H <= 64
                                                   else -(-H // 32)))
    C = 3 if second_order else 1
    lanes = HESS_WARPS * L
    return dict(R=R, W=W, L=L, warps=HESS_WARPS, atoms=L, lanes=lanes,
                seed=6 * C * W * R,
                smem=4 * (2 * C * HESS_PULSES * lanes + 36 * HESS_PULSES))


def _prepare(FA, phi, TAU, T1s, T2s, strict):
    """Per-pulse (N,) and per-atom (B,) tensors on T1s's device and dtype;
    with `strict` (the kernel) a tensor of another device or dtype, or a
    non-contiguous one, raises instead of being converted."""
    if not isinstance(T1s, torch.Tensor):
        raise TypeError("T1s must be a tensor: its device selects the "
                        "kernel (CUDA) or the plain twin (CPU)")
    dev, dt = T1s.device, T1s.dtype

    def vec(x, name):
        if isinstance(x, torch.Tensor):
            if strict and (x.device != dev or x.dtype != dt
                           or not x.is_contiguous()):
                raise ValueError(f"{name}: expected a contiguous {dt} tensor "
                                 f"on {dev}, got {x.dtype} on {x.device}")
            return x.to(device=dev, dtype=dt)
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dt,
                               device=dev)

    FA = vec(FA, "FA")
    if FA.ndim != 1 or FA.shape[0] < 1:
        raise ValueError("FA: expected a non-empty (N,) pulse train")
    N = FA.shape[0]
    phi, TAU = vec(phi, "phi"), vec(TAU, "TAU")
    T1, T2 = vec(T1s, "T1s"), vec(T2s, "T2s")
    if T1.ndim > 1 or T2.ndim > 1:
        raise ValueError("T1s, T2s: expected scalars or (B,) atom vectors")
    T1, T2 = torch.broadcast_tensors(torch.atleast_1d(T1),
                                     torch.atleast_1d(T2))
    out = {"FA": FA, "phi": phi.expand(N).contiguous(),
           "TAU": TAU.expand(N).contiguous(), "T1": T1.contiguous(),
           "T2": T2.contiguous(), "N": N, "B": T1.shape[0]}
    for k in ("phi", "TAU"):
        if tuple(out[k].shape) != (N,):
            raise ValueError(f"{k}: expected a scalar or shape ({N},)")
    return out


def _result(atom, lane, second_order):
    """The JAX dict layout from the (6, B, N) per-atom and (2G, B, N, N)
    per-lane output buffers (views, no copies)."""
    res = {"sig": (atom[0], atom[1]), "dT1": (atom[2], atom[3]),
           "dT2": (atom[4], atom[5])}
    for g in range(_lane_groups(second_order)):
        res[_LANE_NAMES[g]] = (lane[2 * g], lane[2 * g + 1])
    return res


def fisp_hessian_plain(FA, phi, TAU, T1s, T2s, *, te=None, inversion=None,
                       nstate=10, second_order=True):
    """Per-pulse Jacobian/Hessian by the plain PyTorch twin of the kernel.

    Arguments and returns as :func:`fisp_hessian_cuda`; any device, the
    dtype of T1s (float64 makes it an oracle).  At pulse n only lanes
    0..n are live (a lane is zero before its pulse), so each step works
    on those; the seed of lane n is the mask term of the JAX kernel."""
    nstate = int(nstate)
    if nstate < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    x = _prepare(FA, phi, TAU, T1s, T2s, strict=False)
    T1, T2, N, B = x["T1"], x["T2"], x["N"], x["B"]
    H, G = nstate + 1, _lane_groups(second_order)
    dt, dev = T1.dtype, T1.device
    te_sep = te is not None
    z = torch.zeros((H, B), dtype=dt, device=dev)
    # per-atom groups P, U1, U2 as plane 6-tuples of (H, B)
    sP, sU1, sU2 = ([z.clone() for _ in range(6)] for _ in range(3))
    if inversion is not None:
        TI = float(inversion)
        E1i = torch.exp(-TI / T1)
        sP[4][0] = 1.0 - 2.0 * E1i
        sU1[4][0] = -2.0 * E1i * TI / (T1 * T1)
    else:
        sP[4][0] = 1.0
    # lane groups A, T[, W1, W2, X1, X2]: (G, 6 planes, H, B, lanes)
    lane = torch.zeros((G, 6, H, B, N), dtype=dt, device=dev)
    out_atom = torch.empty((6, B, N), dtype=dt, device=dev)
    out_lane = torch.zeros((2 * G, B, N, N), dtype=dt, device=dev)

    deg = math.pi / 180.0
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * deg)
    if te_sep:
        TEc = float(te)
        E2TE = torch.exp(-TEc / T2)
        dE2TE = E2TE * TEc / (T2 * T2)
    rowm = torch.zeros((H, 1, 1), dtype=dt, device=dev)
    rowm[0] = 1.0

    def lanes(t):      # per-atom (H, B) or (B,) -> broadcast over lanes
        return t.unsqueeze(-1)

    for n in range(N):
        a = x["FA"][n] * deg
        rc = planes.rot_coeffs(a, cp[n], sp[n], c2p[n], s2p[n])
        drc = planes.rot_coeffs_db1(a, deg, cp[n], sp[n], c2p[n], s2p[n])
        ttot = x["TAU"][n] + TEc if te_sep else x["TAU"][n]
        cF = torch.exp(-ttot / T2)
        cZ = torch.exp(-ttot / T1)
        rec = 1.0 - cZ
        dcZ1, dcF2 = planes.relax_tangents(cZ, cF, ttot, T1, T2)
        cFt, cZt, cFt2, cZt1 = planes.relax_tau_terms(cZ, cF, ttot, T1, T2)
        e2, de2 = (E2TE, dE2TE) if te_sep else (cF, dcF2)

        YP, YU1, YU2 = (planes.apply_rot(rc, s) for s in (sP, sU1, sU2))
        QP, QU1, QU2 = (planes.apply_rot(drc, s) for s in (sP, sU1, sU2))
        # per-atom echoes from the rotated k = 0 row
        out_atom[0, :, n], out_atom[1, :, n] = e2 * YP[0][0], e2 * YP[1][0]
        out_atom[2, :, n], out_atom[3, :, n] = e2 * YU1[0][0], e2 * YU1[1][0]
        out_atom[4, :, n] = e2 * YU2[0][0] + de2 * YP[0][0]
        out_atom[5, :, n] = e2 * YU2[1][0] + de2 * YP[1][0]

        # live lanes 0..n; m seeds lane n
        L = n + 1
        m = torch.zeros(L, dtype=dt, device=dev)
        m[n] = 1.0
        Y = planes.apply_rot(rc, tuple(lane[:, j, :, :, :L] for j in range(6)))
        yA = tuple(y[0] for y in Y)
        yT = tuple(y[1] for y in Y)
        P_, U1_, U2_ = (tuple(lanes(v) for v in s) for s in (YP, YU1, YU2))
        qP, qU1, qU2 = (tuple(lanes(v) for v in s) for s in (QP, QU1, QU2))
        cF_, cZ_, dcZ1_, dcF2_ = (lanes(v) for v in (cF, cZ, dcZ1, dcF2))
        cFt_, cZt_, cFt2_, cZt1_ = (lanes(v) for v in (cFt, cZt, cFt2, cZt1))
        e2_, de2_ = lanes(e2), lanes(de2)

        # lane echoes (rows 0 of the rotated lane groups)
        def echo(g, re, im):
            out_lane[2 * g, :, n, :L] = re
            out_lane[2 * g + 1, :, n, :L] = im

        def r0(t):
            return t[0]

        echo(0, e2_ * (r0(yA[0]) + m * r0(qP[0])),
             e2_ * (r0(yA[1]) + m * r0(qP[1])))
        if te_sep:
            echo(1, e2_ * r0(yT[0]), e2_ * r0(yT[1]))
        else:
            echo(1, e2_ * r0(yT[0]) + m * cFt_ * r0(P_[0]),
                 e2_ * r0(yT[1]) + m * cFt_ * r0(P_[1]))

        # unshifted new lane values, group by group (JAX :294-375)
        new = [tuple(cF_ * (yA[j] + m * qP[j]) for j in range(4))
               + tuple(cZ_ * (yA[j] + m * qP[j]) for j in (4, 5)),
               tuple(cF_ * yT[j] + m * cFt_ * P_[j] for j in range(4))
               + (cZ_ * yT[4] + m * (cZt_ * P_[4] - rowm * cZt_),
                  cZ_ * yT[5] + m * cZt_ * P_[5])]
        if second_order:
            yW1, yW2, yX1, yX2 = (tuple(y[g] for y in Y) for g in range(2, 6))
            echo(2, e2_ * (r0(yW1[0]) + m * r0(qU1[0])),
                 e2_ * (r0(yW1[1]) + m * r0(qU1[1])))
            echo(3, *(e2_ * r0(yW2[c]) + de2_ * r0(yA[c])
                      + m * (e2_ * r0(qU2[c]) + de2_ * r0(qP[c]))
                      for c in (0, 1)))
            if te_sep:
                echo(4, e2_ * r0(yX1[0]), e2_ * r0(yX1[1]))
                echo(5, *(e2_ * r0(yX2[c]) + de2_ * r0(yT[c])
                          for c in (0, 1)))
            else:
                echo(4, *(e2_ * r0(yX1[c]) + m * cFt_ * r0(U1_[c])
                          for c in (0, 1)))
                echo(5, *(e2_ * r0(yX2[c]) + de2_ * r0(yT[c])
                          + m * (cFt_ * r0(U2_[c]) + cFt2_ * r0(P_[c]))
                          for c in (0, 1)))
            new += [
                tuple(cF_ * (yW1[j] + m * qU1[j]) for j in range(4))
                + tuple(cZ_ * (yW1[j] + m * qU1[j])
                        + dcZ1_ * (yA[j] + m * qP[j]) for j in (4, 5)),
                tuple(cF_ * (yW2[j] + m * qU2[j])
                      + dcF2_ * (yA[j] + m * qP[j]) for j in range(4))
                + tuple(cZ_ * (yW2[j] + m * qU2[j]) for j in (4, 5)),
                tuple(cF_ * yX1[j] + m * cFt_ * U1_[j] for j in range(4))
                + (cZ_ * yX1[4] + dcZ1_ * yT[4]
                   + m * (cZt_ * U1_[4] + cZt1_ * P_[4] - rowm * cZt1_),
                   cZ_ * yX1[5] + dcZ1_ * yT[5]
                   + m * (cZt_ * U1_[5] + cZt1_ * P_[5])),
                tuple(cF_ * yX2[j] + dcF2_ * yT[j]
                      + m * (cFt_ * U2_[j] + cFt2_ * P_[j]) for j in range(4))
                + tuple(cZ_ * yX2[j] + m * cZt_ * U2_[j] for j in (4, 5)),
            ]
        # the folded unit shift of every lane group at once
        nv = torch.stack([torch.stack(g) for g in new])   # (G, 6, H, B, L)
        live = lane[..., :L]
        live[:, 0:2, 1:] = nv[:, 0:2, :-1]
        live[:, 0:2, 0] = nv[:, 2:4, 1]
        live[:, 2:4, :-1] = nv[:, 2:4, 1:]
        live[:, 2:4, -1] = 0.0
        live[:, 4:6] = nv[:, 4:6]

        # per-atom groups (JAX :280-293)
        pZ = cZ * YP[4]
        pZ[0] = pZ[0] + rec
        u1Z = cZ * YU1[4] + dcZ1 * YP[4]
        u1Z[0] = u1Z[0] - dcZ1
        sP = planes.shift_fold(tuple(cF * v for v in YP[:4])
                               + (pZ, cZ * YP[5]))
        sU1 = planes.shift_fold(tuple(cF * v for v in YU1[:4])
                                + (u1Z, cZ * YU1[5] + dcZ1 * YP[5]))
        sU2 = planes.shift_fold(tuple(cF * u + dcF2 * p
                                      for u, p in zip(YU2[:4], YP[:4]))
                                + (cZ * YU2[4], cZ * YU2[5]))
    return _result(out_atom, out_lane, second_order)


def fisp_hessian_cuda(FA, phi, TAU, T1s, T2s, *, te=None, inversion=None,
                      nstate=10, second_order=True):
    """Per-pulse MRF Jacobian/Hessian via the fused CUDA kernel.

    Args mirror ``fisp_hessian_pallas``: FA (N,) flip angles (deg); phi and
    TAU scalars or (N,) (deg, ms; with ``te`` TAU is the tracked tail
    TR - TE); T1s, T2s scalars or (B,) tensors, whose device selects the
    kernel (CUDA, float32, contiguous) or the plain twin (CPU).
    ``te=TE`` is the 5-op form (echo at the fixed TE), ``inversion=TI``
    prepends a perfect inversion.

    Returns a dict of (re, im) pairs: ``sig``, ``dT1``, ``dT2`` (B, N);
    ``dalpha``, ``dtau`` and with ``second_order`` ``dT1dalpha``,
    ``dT2dalpha``, ``dT1dtau``, ``dT2dtau`` (B, N_echo, N_pulse), entries
    with pulse > echo exactly zero.
    """
    kw = dict(te=te, inversion=inversion, nstate=nstate,
              second_order=second_order)
    if _takes_twin(T1s, "FISP Hessian"):
        return fisp_hessian_plain(FA, phi, TAU, T1s, T2s, **kw)
    return _launch(FA, phi, TAU, T1s, T2s, **kw)


def fisp_hessian_cuda_sharded(FA, phi, TAU, T1s, T2s, *, mesh, axis="atoms",
                              second_order=True, **kw):
    """Atom-sharded :func:`fisp_hessian_cuda` over a device mesh
    (``fisp_hessian_pallas_sharded``): each entry of the mesh's `axis` runs
    the kernel (the plain twin on a CPU entry) on its atom shard; the axis
    size must divide the atom count, the pulse arrays are replicated.
    Returns the :func:`fisp_hessian_cuda` dict on the mesh's first device,
    every block with its atoms leading."""
    from ..parallel.mesh import per_atom, shard_map

    T1s, T2s = torch.broadcast_tensors(
        *(torch.atleast_1d(per_atom(x)) for x in (T1s, T2s)))

    def local(t1, t2, *train):
        return fisp_hessian_cuda(*train, t1, t2, second_order=second_order,
                                 **kw)

    return shard_map(local, mesh, [(T1s, 0), (T2s, 0)], axis=axis,
                     replicated=(FA, phi, TAU))


def _launch(FA, phi, TAU, T1s, T2s, *, te, inversion, nstate, second_order):
    global HESS_LAUNCHES
    from .. import _build

    if T1s.dtype != torch.float32:
        raise TypeError(f"the FISP Hessian kernel computes in float32, got "
                        f"{T1s.dtype}")
    nstate = int(nstate)
    second_order = bool(second_order)
    if nstate < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    if not hess_kernel_fits(nstate, second_order):
        raise ValueError(f"nstate={nstate}: beyond the Hessian kernel's "
                         f"gate")
    x = _prepare(FA, phi, TAU, T1s, T2s, strict=True)
    N, B = x["N"], x["B"]
    dev = T1s.device
    out_atom = torch.empty((6, B, N), dtype=torch.float32, device=dev)
    out_lane = torch.empty((2 * _lane_groups(second_order), B, N, N),
                           dtype=torch.float32, device=dev)
    # the atom pass's seed rows, read by the lane pass on the same stream
    geo = hess_geometry(nstate, second_order)
    seed = torch.empty(N * B * geo["seed"], dtype=torch.float32, device=dev)
    # asynchronous on the current stream; see cuda_fisp._launch on
    # temporaries
    lib = _build.load()
    rc = lib.epg_fisp_hess(
        x["FA"].data_ptr(), x["phi"].data_ptr(), x["TAU"].data_ptr(),
        0.0 if te is None else float(te),
        0.0 if inversion is None else float(inversion),
        x["T1"].data_ptr(), x["T2"].data_ptr(), out_atom.data_ptr(),
        out_lane.data_ptr(), seed.data_ptr(), N, B, nstate, geo["R"],
        int(te is not None), int(inversion is not None), int(second_order),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fisp_hess kernel launch failed: CUDA error {rc}")
    HESS_LAUNCHES += 1
    return _result(out_atom, out_lane, second_order)
