"""Composite EPG-X stage trains and their Jacobian: CUDA kernels, plain twins.

Counterpart of ``epgpy_tpu/models/pallas_xcomposite.py``:
``xcomposite_pallas`` (:147) with its kernel ``_kernel_xcomp`` (:51),
``xcomposite_jacobian_pallas`` (:475) with ``_kernel_xcomp_jac`` (:292) and
the differentiable table map ``xcomposite_stage_mat_tables`` (:448).  A
stage is

    [ R(sat)?, T(alpha_c, phi_c)?, X(tau_a)*, ADC?, X(tau_b)*, S(+-1)? ]

over C exchanging compartments, given by per-stage tables: flips and
phases per compartment, saturation factors, the output row adci (-1: no
readout), the shift direction, the ADC phase aph (radians), the B1
sensitivity b1u and the indices mia / mib into a small table of per-atom
stage matrices, one per distinct accumulated tau (entry 0 the identity).
MT-prepared segmented GRE, IR-MT and saturation-recovery MT are such trains
(``fisp_dispatch.match_xcomposite`` builds the tables).

The kernels are ``epgpy_torch/csrc/xcomposite.cu`` and
``xcomposite_jac.cu`` (see their headers for the design; both run
``xgre_jac.cu``'s segmented layout with blocked rows at the geometries
:func:`xcomp_geometry` and :func:`xcomp_jac_geometry` decide, their state
in registers);
``xcomposite_plain`` / ``xcomposite_jacobian_plain`` are the same
recurrences with the same operation order, in any precision, on the
tensors' device.  ``*_cuda`` launch the kernels and raise on CPU tensors
and on what they do not take (C outside 1..4; the Jacobian's variables
outside 1..4, C (V + 1) above 12, or its 6 C (V + 1) planes of nstate + 1
rows beyond one block's shared memory at 32 threads: the gate the
thread-per-atom layout set, kept as the counterpart of the JAX package's
VMEM guard, so that no train changed route with the layout); ``*_echoes``
take the kernel for CUDA tensors and the twin for CPU tensors.
``LAUNCHES`` / ``JAC_LAUNCHES`` count kernel launches.  The TPU-only
knobs (``btile``, ``interpret``), the 8-row alignment of the table blocks
and the padding have no counterpart.
Output rows no stage's adci names are left unwritten: the matcher's adci
is a permutation of 0..nadc-1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import planes
from .cuda_fisp import (SEG_CHUNK_FLOATS, SEG_PULSES, SEG_WARPS,
                        SMEM_PER_BLOCK, _takes_twin, seg_layout)
from .cuda_xgre import (MAX_C, X_TABLE, _check_jac_fits, _chunk_geometry,
                        _cuda_ref, _launch_env, _like, _mix_groups,
                        _saturate, _train, _unit_set, exchange_stage_mats,
                        x_rows, xgre_kernel_fits)

__all__ = ["xcomposite_stage_mat_tables", "xcomposite_cuda",
           "xcomposite_plain", "xcomposite_echoes",
           "xcomposite_jacobian_cuda", "xcomposite_jacobian_plain",
           "xcomposite_jacobian_echoes", "xcomp_geometry", "xcomp_jac_rows",
           "xcomp_jac_geometry", "LAUNCHES", "JAC_LAUNCHES",
           "xcomposite_cuda_sharded"]

#: primal kernel launches so far (diagnostics: proves a run went through it)
LAUNCHES = 0
#: Jacobian kernel launches so far
JAC_LAUNCHES = 0

_DEG = math.pi / 180.0

#: stage-table floats of the Jacobian kernel per compartment (its kTab:
#: cos phi, sin phi, cos 2phi, sin 2phi, four saturation factors, the
#: flip, the saturate / rotate flags) and per stage (kStage: output row,
#: shift direction, mia, mib, b1u, cos and sin of the ADC phase)
XCOMP_JAC_TABLE, XCOMP_JAC_STAGE = 10, 7
#: stage-table floats per stage of the primal kernel (its kStage, as the
#: Jacobian's), beside cuda_xgre.X_TABLE per compartment
XCOMP_STAGE = 7


def xcomp_geometry(nstate, C, nmat):
    """Launch geometry of the segmented primal kernel (``xcomposite.cu``)
    for nmat table entries: dict(R, W, L) of ``cuda_fisp.seg_layout`` at
    ``cuda_xgre.x_rows``' rows per lane, ``one`` (the ladder is the one
    lane's R rows), ``coef``, the floats of one ladder's record (nmat 3
    C^2, rounded up to odd), ``shared``, whether the records sit in the
    block's shared memory (else the kernel reads the stage's two entries
    from device memory: tables too large for one warp's records),
    ``warps`` per block (SEG_WARPS, halved while the records and one
    stage's table and staged echoes pass SEG_CHUNK_FLOATS), ``atoms`` per
    block, ``pulses`` (stages) per chunk and ``smem``.  The wrapper passes
    R, warps, pulses and the mode to the kernel, which checks them."""
    C, nmat = int(C), int(nmat)
    R, W, L = seg_layout(nstate, x_rows(nstate, C))
    return dict(R=R, W=W, L=L, one=R == int(nstate) + 1,
                **_tables_geometry((nmat * 3 * C * C) | 1,
                                   X_TABLE * C + XCOMP_STAGE, 2 * C, L))


def xcomp_jac_rows(nstate, C, G) -> int:
    """Rows per lane of the Jacobian kernel: 1 for H = nstate + 1 <= 3,
    else ceil(H / 32), at least 3 while the 6 C G planes of three rows stay
    within 72 floats (C G <= 4) and at least 2 while two rows do (C G <=
    6): 3 at the exchange-rate fit (C = 2, G = 2, nstate 8: 10 ladders of
    3 lanes per warp, no padding row), measured 10% faster than 2 there
    (PERF.md).  The gate's deepest ladders take 5 rows (C G = 2, H 151), 4
    (C G = 3, H 100), 3 (C G = 4, H 75), 2 (C G <= 9) and 1 (C G >=
    10)."""
    H, CG = int(nstate) + 1, int(C) * int(G)
    if H <= 3:
        return 1
    return max(-(-H // 32), 3 if CG <= 4 else 2 if CG <= 6 else 1)


def xcomp_jac_geometry(nstate, C, G, nmat):
    """Launch geometry of the segmented Jacobian kernel
    (``xcomposite_jac.cu``) for nmat table entries: dict(R, W, L) of
    ``cuda_fisp.seg_layout`` at :func:`xcomp_jac_rows`' rows per lane;
    ``coef``, the floats of one ladder's record (nmat G 3 C^2 table floats
    and C G densities, rounded up to odd); ``shared``, whether the records
    sit in the block's shared memory (else the kernel reads the stage's two
    table entries from device memory, the mode for tables too large for
    one warp's records); ``warps`` per block (SEG_WARPS, halved while the
    records and one stage's table and staged echoes pass
    SEG_CHUNK_FLOATS); ``atoms`` per block (warps x L), ``pulses`` (stages)
    per chunk and ``smem``, the block's shared bytes.  The wrapper passes
    R, warps, pulses and the mode to the kernel, which checks them."""
    C, G, nmat = int(C), int(G), int(nmat)
    R, W, L = seg_layout(nstate, xcomp_jac_rows(nstate, C, G))
    coef = (nmat * G * 3 * C * C + C * G) | 1
    return dict(R=R, W=W, L=L, **_tables_geometry(
        coef, XCOMP_JAC_TABLE * C + XCOMP_JAC_STAGE, 2 * G * C, L))


def _tables_geometry(coef, table, outputs, L):
    """``cuda_xgre._chunk_geometry`` of a composite EPG-X kernel whose
    ladders each hold a record of `coef` floats: ``shared``, whether one
    warp's records and one stage fit SEG_CHUNK_FLOATS (else the kernel
    reads the table from device memory and the block holds no records),
    and ``coef``, the record's floats, beside the chunk's keys."""
    shared = coef * L + table + outputs * L <= SEG_CHUNK_FLOATS
    geo = _chunk_geometry(coef if shared else 0, table, outputs, L)
    return dict(geo, coef=coef, shared=shared)


def xcomposite_stage_mat_tables(khi, T1, T2, g, taus):
    """Differentiable distinct-tau stage-matrix tables: run
    ``torch.func.jvp`` of it once per fit variable for the Jacobian's
    tangent tables (variables may enter through khi, T1, T2, g; taus are
    host numbers, taus[0] = 0 the identity entry).  khi (C, C) or (C, C,
    B); T1, T2 (C, B); g (C, B) or None.  Returns (mr, mi, ml), each
    (nmat, B, C, C)."""
    outs = [exchange_stage_mats(khi, T1, T2, g, float(t))
            for t in np.asarray(taus, dtype=np.float64).reshape(-1)]
    return tuple(torch.stack([o[k] for o in outs]) for k in range(3))


def _pack_table(mats, ref):
    """(mr, mi, ml), each (nmat, B, C, C) -> (nmat, 3, C C, B) rows."""
    mr, mi, ml = (_like(m, ref) for m in mats)
    nmat, B, C, _ = mr.shape
    t = torch.stack([mr, mi, ml], dim=1).reshape(nmat, 3, B, C * C)
    return t.transpose(-1, -2).contiguous()


def _stage_tables(adci, shift, aph, mia, mib, b1u, N, ref):
    """The per-stage integer and phase tables on ref's device: adci,
    shift, mia, mib int32; aph, b1u in ref's dtype."""
    def ivec(x, name):
        t = _like(x, ref, torch.int32).reshape(-1)
        if t.shape[0] != N:
            raise ValueError(f"{name}: expected ({N},), got "
                             f"{tuple(t.shape)}")
        return t.contiguous()

    def fvec(x, name, fill):
        t = _like(fill if x is None else x, ref).reshape(-1)
        return torch.broadcast_to(t, (N,)).contiguous()

    return {"adci": ivec(adci, "adci"), "shift": ivec(shift, "shift"),
            "mia": ivec(mia, "mia"), "mib": ivec(mib, "mib"),
            "aph": fvec(aph, "aph", 0.0), "b1u": fvec(b1u, "b1u", 1.0)}


def _twin(tr, st_tab, b1, table, dens, nadc, nstate, flags):
    """The kernels' recurrence: tr the (N, C) tables, st_tab the per-stage
    tables, b1 (B,), table (G, nmat, 3, C, C, B), dens (G, C, B').
    Returns (2, nadc, G, C, B)."""
    up, down, adcph, sat_on, b1u_on = flags
    N, C = tr["alpha"].shape
    G, B, H = table.shape[0], b1.shape[0], int(nstate) + 1
    dt, dev = b1.dtype, b1.device
    st = [[_unit_set(H, B, dt, dev, g == 0) for _ in range(C)]
          for g in range(G)]
    out = torch.empty((2, nadc, G, C, B), dtype=dt, device=dev)
    cp, sp, c2p, s2p = planes.phase_terms(tr["phi"] * _DEG)
    # the tables the loop branches on, read once (one copy each from a card)
    adci, shift = st_tab["adci"].tolist(), st_tab["shift"].tolist()
    mia, mib = st_tab["mia"].tolist(), st_tab["mib"].tolist()
    aph, b1u = st_tab["aph"], st_tab["b1u"]
    for i in range(N):
        eff = 1.0 + b1u[i] * (b1 - 1.0) if b1u_on else b1
        rc = [planes.rot_coeffs(tr["alpha"][i, c] * _DEG * eff, cp[i, c],
                                sp[i, c], c2p[i, c], s2p[i, c])
              for c in range(C)]
        x = []
        for g in range(G):
            row = []
            for c in range(C):
                s = st[g][c]
                if sat_on:
                    s = _saturate(s, (tr["sfr"][i, c], tr["sfi"][i, c],
                                      tr["szr"][i, c], tr["szi"][i, c]))
                row.append(planes.apply_rot(rc[c], s))
            x.append(row)
        y = _mix_groups(x, lambda g, p, a, b_, m=mia[i]: table[g, m, p, a,
                                                              b_], dens)
        idx = adci[i]
        if 0 <= idx < nadc:
            q = (torch.cos(aph[i]), torch.sin(aph[i])) if adcph else None
            for g in range(G):
                for c in range(C):
                    eR, eI = y[g][c][0][0], y[g][c][1][0]
                    if q is not None:
                        eR, eI = planes.cmul(q[0], q[1], eR, eI)
                    out[0, idx, g, c], out[1, idx, g, c] = eR, eI
        z = _mix_groups(y, lambda g, p, a, b_, m=mib[i]: table[g, m, p, a,
                                                              b_], dens)
        if shift[i] == 1 and up:
            z = [[planes.shift_fold(s) for s in zg] for zg in z]
        elif shift[i] == -1 and down:
            z = [[planes.shift_down(s) for s in zg] for zg in z]
        st = z
    return out


def _setup(alpha, phi, satf_re, satf_im, satz_re, satz_im, adci, shift, aph,
           mia, mib, b1, b1u, ref, nadc, nstate, flags, strict):
    tr, N, C = _train(alpha, phi, satf_re, satf_im, satz_re, satz_im, ref,
                      strict)
    up, down = flags[0], flags[1]
    if (up or down) and int(nstate) < 1:
        raise ValueError("shifting composite EPG-X trains need nstate >= 1")
    if int(nstate) < 0 or int(nadc) < 1:
        raise ValueError(f"nstate must be >= 0 and nadc >= 1, got {nstate}, "
                         f"{nadc}")
    st_tab = _stage_tables(adci, shift, aph, mia, mib, b1u, N, ref)
    return tr, st_tab, N, C


def _b1(b1, ref, B):
    if b1 is None:
        return torch.ones(B, dtype=ref.dtype, device=ref.device)
    return _like(b1, ref).reshape(-1).contiguous()


def _primal(alpha, phi, satf_re, satf_im, satz_re, satz_im, adci, shift,
            aph, mia, mib, dens, taus, khi, T1, T2, g, b1, b1u, nadc, nstate,
            flags, strict):
    if not isinstance(T1, torch.Tensor) or T1.ndim != 2:
        raise TypeError("T1 must be a (C, B) tensor: its device selects the "
                        "kernel (CUDA) or the plain twin (CPU)")
    ref = T1
    tr, st_tab, N, C = _setup(alpha, phi, satf_re, satf_im, satz_re,
                              satz_im, adci, shift, aph, mia, mib, b1, b1u,
                              ref, nadc, nstate, flags, strict)
    B = int(T1.shape[1])
    table = _pack_table(xcomposite_stage_mat_tables(
        khi, T1, _like(T2, ref), None if g is None else _like(g, ref), taus),
        ref)
    dens = _like(dens, ref).reshape(-1).contiguous()
    if dens.shape[0] != C:
        raise ValueError(f"dens: expected ({C},), got {tuple(dens.shape)}")
    return tr, st_tab, _b1(b1, ref, B), table, dens, ref, N, C, B


def xcomposite_plain(alpha, phi, satf_re, satf_im, satz_re, satz_im, adci,
                     shift, aph, mia, mib, dens, taus, khi, T1, T2, g,
                     b1=None, b1u=None, *, nadc, nstate, has_up=True,
                     has_down=False, has_adcph=False, has_sat=False,
                     has_b1u=False):
    """Composite EPG-X echo trains (re, im), each (nadc, C, B), by the
    plain PyTorch recurrence (the kernel's twin), on T1's device and
    dtype.  Arguments as :func:`xcomposite_cuda`."""
    flags = (has_up, has_down, has_adcph, has_sat, has_b1u)
    tr, st_tab, b1, table, dens, ref, N, C, B = _primal(
        alpha, phi, satf_re, satf_im, satz_re, satz_im, adci, shift, aph,
        mia, mib, dens, taus, khi, T1, T2, g, b1, b1u, nadc, nstate, flags,
        strict=False)
    nmat = table.shape[0]
    out = _twin(tr, st_tab, b1, table.reshape(1, nmat, 3, C, C, B),
                dens.reshape(1, C, 1), int(nadc), nstate, flags)
    return out[0, :, 0], out[1, :, 0]


def xcomposite_cuda(alpha, phi, satf_re, satf_im, satz_re, satz_im, adci,
                    shift, aph, mia, mib, dens, taus, khi, T1, T2, g,
                    b1=None, b1u=None, *, nadc, nstate, has_up=True,
                    has_down=False, has_adcph=False, has_sat=False,
                    has_b1u=False):
    """Composite EPG-X stage train through the CUDA kernel (xcomposite.cu).

    Args mirror ``xcomposite_pallas``: alpha, phi (N, C) per-stage
    per-compartment flips and phases (degrees); satf_re/im, satz_re/im
    (N, C) saturation factors (read when has_sat); adci (N,) output row
    (-1: none); shift (N,) in {-1, 0, +1}; aph (N,) ADC phase (radians,
    read when has_adcph); mia, mib (N,) table indices of the pre- and
    post-readout exchange stages (0: the identity); dens (C,) equilibrium
    densities; taus (nmat,) mixing times, taus[0] = 0; khi (C, C) and T1,
    T2, g (C, B) the one generator every X stage shares (g may be None);
    b1 optional (B,) flip scale; b1u optional (N,) per-stage B1
    sensitivity (read when has_b1u); nadc, nstate the output rows and the
    ladder capacity.  T1 is a float32 CUDA tensor; tensor arguments of the
    train must be float32 (adci, shift, mia, mib int32), contiguous and on
    its device.  Returns (re, im): (nadc, C, B) float32."""
    global LAUNCHES
    flags = (has_up, has_down, has_adcph, has_sat, has_b1u)
    tr, st_tab, b1, table, dens, ref, N, C, B = _primal(
        alpha, phi, satf_re, satf_im, satz_re, satz_im, adci, shift, aph,
        mia, mib, dens, taus, khi, T1, T2, g, b1, b1u, nadc, nstate, flags,
        strict=True)
    _cuda_ref(ref, "xcomposite")
    nstate, nadc = int(nstate), int(nadc)
    if not 1 <= C <= MAX_C or not xgre_kernel_fits(nstate, C):
        raise ValueError(f"C={C}, nstate={nstate}: the xcomposite kernel "
                         f"takes 1 to {MAX_C} compartments whose 6 C planes "
                         f"fit in {SMEM_PER_BLOCK} bytes of shared memory")
    out = torch.empty((2, nadc, C, B), dtype=torch.float32,
                      device=ref.device)
    nmat = int(table.shape[0])
    geo = xcomp_geometry(nstate, C, nmat)
    lib, dev, stream = _launch_env(ref)
    rc = lib.epg_xcomposite(
        *_ptrs(tr, st_tab), dens.data_ptr(), b1.data_ptr(), table.data_ptr(),
        out.data_ptr(), N, C, B, nadc, nmat, nstate,
        *(int(bool(f)) for f in flags), geo["R"], geo["warps"],
        geo["pulses"], int(geo["shared"]), dev, stream)
    if rc != 0:
        raise RuntimeError(f"xcomposite kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return out[0], out[1]


def _ptrs(tr, st_tab):
    return ([tr[k].data_ptr() for k in ("alpha", "phi", "sfr", "sfi", "szr",
                                        "szi")]
            + [st_tab[k].data_ptr() for k in ("adci", "shift", "aph", "mia",
                                              "mib", "b1u")])


def _jac(alpha, phi, satf_re, satf_im, satz_re, satz_im, adci, shift, aph,
         mia, mib, dens, mats, dmats, ddens, b1, b1u, nadc, nstate, flags,
         strict):
    ref = mats[0]
    if not isinstance(ref, torch.Tensor) or ref.ndim != 4:
        raise TypeError("mats[0] must be a (nmat, B, C, C) tensor: its "
                        "device selects the kernel (CUDA) or the plain twin "
                        "(CPU)")
    tr, st_tab, N, C = _setup(alpha, phi, satf_re, satf_im, satz_re,
                              satz_im, adci, shift, aph, mia, mib, b1, b1u,
                              ref, nadc, nstate, flags, strict)
    nmat, B = int(ref.shape[0]), int(ref.shape[1])
    V = len(dmats)
    table = torch.stack([_pack_table(mats, ref)]
                        + [_pack_table(d, ref) for d in dmats]).contiguous()
    dens = _like(dens, ref)
    if dens.ndim == 1:
        dens = dens[:, None]
    rows = [torch.broadcast_to(dens, (C, B))]
    rows += [torch.broadcast_to(_like(ddens[v], ref), (C, B))
             for v in range(V)]
    drows = torch.cat(rows).contiguous()
    return tr, st_tab, _b1(b1, ref, B), table, drows, ref, N, C, B, V, nmat


def xcomposite_jacobian_plain(alpha, phi, satf_re, satf_im, satz_re,
                              satz_im, adci, shift, aph, mia, mib, dens,
                              mats, dmats, ddens, b1=None, b1u=None, *,
                              nadc, nstate, has_up=True, has_down=False,
                              has_adcph=False, has_sat=False, has_b1u=False):
    """Signals and tangents (re, im), each (nadc, G, C, B), by the plain
    PyTorch recurrence (the Jacobian kernel's twin); arguments as
    :func:`xcomposite_jacobian_cuda`."""
    flags = (has_up, has_down, has_adcph, has_sat, has_b1u)
    tr, st_tab, b1, table, drows, ref, N, C, B, V, nmat = _jac(
        alpha, phi, satf_re, satf_im, satz_re, satz_im, adci, shift, aph,
        mia, mib, dens, mats, dmats, ddens, b1, b1u, nadc, nstate, flags,
        strict=False)
    G = V + 1
    out = _twin(tr, st_tab, b1, table.reshape(G, nmat, 3, C, C, B),
                drows.reshape(G, C, B), int(nadc), nstate, flags)
    return out[0], out[1]


def xcomposite_jacobian_cuda(alpha, phi, satf_re, satf_im, satz_re,
                             satz_im, adci, shift, aph, mia, mib, dens,
                             mats, dmats, ddens, b1=None, b1u=None, *,
                             nadc, nstate, has_up=True, has_down=False,
                             has_adcph=False, has_sat=False, has_b1u=False):
    """Composite EPG-X stage train and per-variable tangents in one CUDA
    kernel (xcomposite_jac.cu).

    Args mirror ``xcomposite_jacobian_pallas``: the stage tables as
    :func:`xcomposite_cuda`; dens (C, B) per-atom densities (or (C,));
    mats ``(mr, mi, ml)`` distinct-tau tables, each (nmat, B, C, C), from
    :func:`xcomposite_stage_mat_tables`; dmats the per-variable tangent
    tables, each a 3-tuple of (nmat, B, C, C); ddens the per-variable
    density tangents, each (C, B) or (C,) (zeros when the variable does
    not move the equilibrium).  mats[0] is a float32 CUDA tensor.  Raises
    ValueError for V outside 1..4, C (V + 1) above 12, or past the gate
    (6 C (V + 1) planes of nstate + 1 rows at 32 threads within a block's
    shared memory; the state itself sits in registers).  Returns (re, im):
    (nadc, G, C, B) float32, G = 1 + V (primal first, then one tangent
    per variable)."""
    global JAC_LAUNCHES
    flags = (has_up, has_down, has_adcph, has_sat, has_b1u)
    tr, st_tab, b1, table, drows, ref, N, C, B, V, nmat = _jac(
        alpha, phi, satf_re, satf_im, satz_re, satz_im, adci, shift, aph,
        mia, mib, dens, mats, dmats, ddens, b1, b1u, nadc, nstate, flags,
        strict=True)
    _cuda_ref(ref, "xcomposite_jac")
    G, nstate, nadc = V + 1, int(nstate), int(nadc)
    _check_jac_fits("xcomposite_jac", C, G, nstate)
    geo = xcomp_jac_geometry(nstate, C, G, nmat)
    out = torch.empty((2, nadc, G, C, B), dtype=torch.float32,
                      device=ref.device)
    lib, dev, stream = _launch_env(ref)
    rc = lib.epg_xcomposite_jac(
        *_ptrs(tr, st_tab), drows.data_ptr(), b1.data_ptr(),
        table.data_ptr(), out.data_ptr(), N, C, G, B, nadc, nmat, nstate,
        *(int(bool(f)) for f in flags), geo["R"], geo["warps"],
        geo["pulses"], int(geo["shared"]), dev, stream)
    if rc != 0:
        raise RuntimeError(f"xcomposite_jac kernel launch failed: CUDA error "
                           f"{rc}")
    JAC_LAUNCHES += 1
    return out[0], out[1]


def xcomposite_echoes(*args, **kw):
    """:func:`xcomposite_cuda` for CUDA tensors, :func:`xcomposite_plain`
    for CPU tensors (the twin stands in for the kernel on the CPU)."""
    fn = xcomposite_plain if _takes_twin(args[14], "xcomposite") \
        else xcomposite_cuda
    return fn(*args, **kw)


def xcomposite_cuda_sharded(alpha, phi, satf_re, satf_im, satz_re, satz_im,
                            adci, shift, aph, mia, mib, dens, taus, khi, T1,
                            T2, g, b1=None, *, mesh, axis="atoms", **kw):
    """Atom-sharded composite EPG-X kernel over a device mesh
    (``xcomposite_pallas_sharded``): each entry of the mesh's `axis` runs
    :func:`xcomposite_cuda` (the plain twin on a CPU entry) on its atom
    shard -- axis 1 of the (C, B) T1, T2 and g, b1 (B,) with them; the axis
    size must divide the atom count, the per-stage rows, the kinetic matrix
    and the mixing times are replicated.  Returns (re, im), each (nadc, C,
    B), on the mesh's first device."""
    from ..parallel.mesh import shard_map

    def local(t1, t2, gg, b1s, *train):
        return xcomposite_echoes(*train, t1, t2, gg, b1s, **kw)

    return shard_map(local, mesh, [(T1, 1), (T2, 1), (g, 1), (b1, 0)],
                     axis=axis, out_dim=2,
                     replicated=(alpha, phi, satf_re, satf_im, satz_re,
                                 satz_im, adci, shift, aph, mia, mib, dens,
                                 taus, khi))


def xcomposite_jacobian_echoes(*args, **kw):
    """:func:`xcomposite_jacobian_cuda` for CUDA tensors,
    :func:`xcomposite_jacobian_plain` for CPU tensors."""
    fn = xcomposite_jacobian_plain \
        if _takes_twin(args[12][0], "xcomposite Jacobian") \
        else xcomposite_jacobian_cuda
    return fn(*args, **kw)
