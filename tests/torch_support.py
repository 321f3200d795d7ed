"""Shared helpers of the epgpy_torch parity tests (tests/test_torch_*.py).

The port's tests run the same numpy inputs (made from a seed) through the
JAX package and through epgpy_torch.  ``tests/conftest.py`` turns on JAX
x64 and pins JAX to the CPU; these fixtures pin the port to the CPU in
the precision a test asks for and restore the previous setting after it.
"""

import os

import numpy as np
import pytest
import torch

from epgpy_torch import config

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _pinned(precision):
    old = (config.precision(), config.device(), torch.get_num_threads())
    config.set_device("cpu")
    config.set_precision(precision)
    torch.set_num_threads(1)          # six test workers share the cores
    yield
    config.set_precision(old[0])
    config.set_device(old[1])
    torch.set_num_threads(old[2])


@pytest.fixture
def port_f64():
    """epgpy_torch on the CPU in float64 (complex128)."""
    yield from _pinned("float64")


@pytest.fixture
def port_f32():
    """epgpy_torch on the CPU in float32 (complex64)."""
    yield from _pinned("float32")


def random_ladder(rng, batch, nstate):
    """A random complex (*batch, 2n+1, 3) ladder with the EPG conjugate
    symmetry F-(k) = conj(F+(-k)), Z(-k) = conj(Z(k))."""
    K = 2 * nstate + 1
    shape = tuple(batch) + (K,)
    fp = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    z = 0.5 * (z + np.conj(z[..., ::-1]))
    return np.stack([fp, np.conj(fp[..., ::-1]), z], axis=-1)


def composite_claims(tfd, jfd, seq, jseq, before, kvalue=1.0):
    """The dispatch counts after one forced simulate() of an off-pattern
    train (`seq`; `jseq` the same train in the JAX package): `before`, plus
    one "comp" where the composite family -- last in the family table --
    claims it, as the JAX matcher does (tests/test_dwfisp_dispatch.py:
    112-116)."""
    claimed = tfd.match_composite(seq, kvalue) is not None
    assert claimed == (jfd.match_composite(jseq, kvalue) is not None)
    if not claimed:
        return before
    return dict(before, comp=before.get("comp", 0) + 1)


#: the family grammars' batch (tests/test_dispatch_fuzz.py)
_T1, _T2 = np.array([600.0, 1100.0, 1700.0]), np.array([50.0, 90.0, 150.0])


def family_train(e, fam, n=4):
    """tests/test_dispatch_fuzz.py's family grammars (plus DW-FISP and a
    prepared train only the composite family takes) in package `e`,
    deterministic."""
    seq = []
    if fam == "fisp":
        for i in range(n):
            seq += [e.T(20.0 + i, 90.0), e.E(5.0, _T1, _T2), e.ADC,
                    e.E(7.0, _T1, _T2), e.S(1)]
    elif fam == "mse":
        seq = [e.T(90, 90)]
        for i in range(n):
            seq += [e.E(4.0, _T1, _T2), e.S(1), e.T(150.0 + i, 0.0),
                    e.E(4.0, _T1, _T2), e.S(1), e.ADC]
    elif fam == "bssfp":
        for i in range(n):
            seq += [e.T(30.0 + i, 180.0 * (i % 2)),
                    e.E(6.0, _T1, _T2, -0.01), e.ADC,
                    e.E(6.0, _T1, _T2, -0.01)]
    elif fam == "dess":
        for i in range(n):
            seq += [e.T(25.0, 0.0), e.E(5.0, _T1, _T2), e.ADC,
                    e.E(8.0, _T1, _T2), e.S(1), e.E(5.0, _T1, _T2), e.ADC]
    elif fam == "megre":
        for i in range(n):
            seq.append(e.T(14.0, 0.0))
            prev = 0.0
            for te in (3.0, 7.0, 11.0):
                seq += [e.E(te - prev, _T1, _T2), e.ADC]
                prev = te
            seq += [e.E(4.0, _T1, _T2), e.S(1)]
    elif fam == "megre_m1":          # one echo per TR: FISP's
        for i in range(n):
            seq += [e.T(14.0, 0.0), e.E(3.0, _T1, _T2), e.ADC,
                    e.E(4.0, _T1, _T2), e.S(1)]
    elif fam == "dw":
        d = e.D(5.0, 1.3e-3, k=1)
        for i in range(n):
            seq += [e.T(20.0 + i, 90.0), e.E(5.0, _T1, _T2), e.ADC,
                    e.E(7.0, _T1, _T2), e.S(1), d]
    else:                             # "comp": an inversion-prepared train
        seq = [e.T(180.0, 0.0), e.E(20.0, _T1, _T2)]
        for i in range(n):
            seq += [e.T(20.0 + i, 90.0), e.E(5.0, _T1, _T2), e.ADC,
                    e.E(7.0, _T1, _T2), e.S(1)]
        seq += [e.E(300.0, _T1, _T2)]
    return seq


def cplx(re, im):
    """(re, im) pair of arrays or tensors -> one complex numpy array."""
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return host(re) + 1j * host(im)


def same_match(got, want):
    """A port match dict holds a JAX match dict's every key with the same
    value (numbers exactly, arrays to 1e-12 relative)."""
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert g is None and w is None, k
        elif isinstance(w, (bool, int, float, tuple)):
            assert g == w, k
        else:
            assert np.allclose(np.asarray(g), np.asarray(w), rtol=1e-12,
                               atol=0), k


class ShiftRecorder:
    """Records every plane set that ``planes.shift_fold`` returns while
    active (the plain twins shift each group once per half-stage), so a
    test can read the folded ladders the twins otherwise keep to
    themselves."""

    def __init__(self, monkeypatch):
        from epgpy_torch.models import planes

        self.sets = []
        fold = planes.shift_fold

        def record(s):
            out = fold(s)
            self.sets.append(out)
            return out

        monkeypatch.setattr(planes, "shift_fold", record)


def rows_beyond(s, top):
    """The largest |value| of a plane set's rows past `top` (0 when none)."""
    return max((float(p[top + 1:].abs().max()) if p.shape[0] > top + 1
                else 0.0) for p in s)


def seg_shift_emulated(s, R=None, down=False, padding=False, blocked=False):
    """``planes.shift_fold`` (``planes.shift_down`` with `down`) through the
    segmented layout's lane map, in numpy: the planes (each (H, B)) are laid
    out as the segmented kernels hold them -- a ladder in a segment of W =
    ceil(H / R) lanes, 32 // W ladders per warp, lane r owning rows r + W c,
    c < R (R from ``cuda_fisp.seg_layout`` when None) -- with NaN in the
    lanes past the last segment and atom and in the padding rows;
    ``epg::seg_shift`` (``epg::seg_shift_down``, csrc/epg_planes.cuh) is
    replayed step by step (two rotations of each segment by one lane, then
    the row-0, wrap, last-row and padding selects), and the lanes' rows are
    read back; with `padding`, also the values the shift leaves in the
    padding rows of the stored atoms' lanes, (6, n).  A NaN that reached a
    ladder row or a padding row would show in the result.  With `blocked`
    lane r owns rows r R + c instead
    (``epg::seg_shift_blocked``, ``epg::seg_shift_blocked_down`` with
    `down`): rows move within a lane, and one row of A and of B per lane
    crosses to the next lane; padding rows' A and B come out 0, their Z as
    it went in."""
    from epgpy_torch.models import cuda_fisp

    dtype = s[0].dtype
    v0 = np.stack([np.asarray(p, dtype=np.float64) for p in s])  # (6, H, B)
    H, B = v0.shape[1:]
    if R is None:
        R = cuda_fisp.seg_layout(H - 1)[0]
    W = -(-H // R)
    L = 32 // W
    # the down shift is the up shift with the A and B planes' roles swapped
    up, dn = ((2, 3), (0, 1)) if down else ((0, 1), (2, 3))
    nwarps = -(-B // L)
    lane = np.arange(32)
    seg, r = lane // W, lane % W
    base = seg * W
    if blocked:
        k = r[None, :] * R + np.arange(R)[:, None]               # (R, 32)
    else:
        k = r[None, :] + W * np.arange(R)[:, None]               # (R, 32)
    atom = np.arange(nwarps)[:, None] * L + seg[None, :]         # (w, 32)
    valid = ((seg < L)[None, None, :] & (atom < B)[None, :, :]
             & (k < H)[:, None, :])                              # (R, w, 32)
    kk = np.broadcast_to(np.minimum(k, H - 1)[:, None, :], valid.shape)
    aa = np.broadcast_to(np.minimum(atom, B - 1)[None], valid.shape)
    v = np.where(valid[None], v0[:, kk, aa], np.nan)        # (6, R, w, 32)
    first, last = r == 0, r == W - 1
    up, dn = list(up), list(dn)
    if blocked:
        out = v.copy()
        a = v[up, R - 1][..., (lane - 1) % 32]     # the lane below's last
        b = v[dn, 0][..., (lane + 1) % 32]         # the lane above's first
        a0 = np.where(first, v[dn, 1] if R > 1 else b, a)
        for c in range(R):
            A = v[up, c - 1] if c > 0 else a0
            Bn = v[dn, c + 1] if c + 1 < R else b
            out[up, c] = np.where(k[c] < H, A, 0.0)
            out[dn, c] = np.where(k[c] >= H - 1, 0.0, Bn)
        res = np.zeros_like(v0)
        c_, w_, l_ = np.nonzero(valid)
        res[:, k[c_, l_], atom[w_, l_]] = out[:, c_, w_, l_]
        res = tuple(torch.as_tensor(x, dtype=dtype) for x in res)
        if padding:
            pad = ((seg < L)[None, None, :] & (atom < B)[None, :, :]
                   & (k >= H)[:, None, :])
            return res, out[:4, pad]
        return res
    below = np.where(first, base + W - 1, lane - 1) % 32
    above = np.where(last, base, lane + 1) % 32
    a, b = v[up][..., below], v[dn][..., above]
    out = v.copy()
    for c in range(R):
        kc = k[c]
        A = np.where(first, b[:, 0] if c == 0 else a[:, c - 1], a[:, c])
        nxt = last & (c + 1 < R)
        Bn = np.where(nxt, b[:, min(c + 1, R - 1)], b[:, c])
        keep = (R == 1) | (kc < H)
        zero_b = kc >= H - 1
        out[up, c] = np.where(keep, A, 0.0)
        out[dn, c] = np.where(zero_b, 0.0, Bn)
        out[4:6, c] = np.where(keep, v[4:6, c], 0.0)
    res = np.zeros_like(v0)
    c_, w_, l_ = np.nonzero(valid)
    res[:, k[c_, l_], atom[w_, l_]] = out[:, c_, w_, l_]
    res = tuple(torch.as_tensor(x, dtype=dtype) for x in res)
    if padding:
        pad = ((seg < L)[None, None, :] & (atom < B)[None, :, :]
               & (k >= H)[:, None, :])
        return res, out[:, pad]
    return res


def hessian_two_pass(FA, phi, TAU, T1s, T2s, *, te=None, inversion=None,
                     nstate=10, second_order=True, seeds=("A", "T")):
    """The per-pulse Hessian the way csrc/fisp_hess.cu computes it, in
    float64: an atom pass propagates P, U1, U2 and keeps their rows before
    each pulse's rotation (the seeds); then every lane i runs two chains,
    {A, W1, W2} and {T, X1, X2} ({A} and {T} at first order), zero before
    pulse i.  At pulse i a chain takes the seed rows rotated by the pulse's
    d/dalpha (A) or its rotation (T) as its rotated state and steps them
    with the normal relaxation (A) or the tau derivatives of the relaxation
    and the recovery (T); after pulse i every lane steps all its groups
    together in the m = 0 form of fisp_hessian_plain (no seed terms).
    `seeds` names the chains that are seeded (the other one stays zero).
    Returns fisp_hessian_plain's dict."""
    from epgpy_torch.models import cuda_hessian, planes

    f64 = torch.float64
    T1 = torch.as_tensor(np.atleast_1d(np.asarray(T1s, np.float64)))
    T2 = torch.as_tensor(np.atleast_1d(np.asarray(T2s, np.float64)))
    T1, T2 = torch.broadcast_tensors(T1, T2)
    FA = torch.as_tensor(np.asarray(FA, np.float64))
    N, B, H = FA.shape[0], T1.shape[0], int(nstate) + 1
    phi = torch.tensor(np.broadcast_to(np.asarray(phi, np.float64), N))
    TAU = torch.tensor(np.broadcast_to(np.asarray(TAU, np.float64), N))
    te_sep = te is not None
    deg = np.pi / 180.0
    cp, sp, c2p, s2p = planes.phase_terms(phi * deg)

    def zeros(*shape):
        return tuple(torch.zeros((H, B) + shape, dtype=f64)
                     for _ in range(6))

    def step(y, c, rec):
        """One chain (or the atom groups) over rotated rows y = (y0[, y1,
        y2]): echoes and unshifted new values; c = (cF, cZ, dcZ1, dcF2, e2,
        de2), rec the row-0 Z terms of y0, y1."""
        cF, cZ, dcZ1, dcF2, e2, de2 = c
        echo = [(e2 * y[0][0][0], e2 * y[0][1][0])]
        new0 = tuple(cF * v for v in y[0][:4]) + tuple(cZ * v
                                                        for v in y[0][4:])
        new0[4][0] += rec[0]
        new = [new0]
        if len(y) == 3:
            echo += [(e2 * y[1][0][0], e2 * y[1][1][0]),
                     (e2 * y[2][0][0] + de2 * y[0][0][0],
                      e2 * y[2][1][0] + de2 * y[0][1][0])]
            new1 = tuple(cF * v for v in y[1][:4]) + tuple(
                cZ * v + dcZ1 * p for v, p in zip(y[1][4:], y[0][4:]))
            new1[4][0] += rec[1]
            new += [new1, tuple(cF * v + dcF2 * p for v, p in
                                zip(y[2][:4], y[0][:4]))
                    + tuple(cZ * v for v in y[2][4:])]
        return echo, new

    # the atom pass: P, U1, U2 and their pre-rotation rows at every pulse
    sP, sU1, sU2 = zeros(), zeros(), zeros()
    if inversion is not None:
        E1i = torch.exp(-float(inversion) / T1)
        sP[4][0] = 1.0 - 2.0 * E1i
        sU1[4][0] = -2.0 * E1i * float(inversion) / (T1 * T1)
    else:
        sP[4][0] = 1.0
    out_atom = torch.empty((6, B, N), dtype=f64)
    G = 6 if second_order else 2
    out_lane = torch.zeros((2 * G, B, N, N), dtype=f64)
    coeffs, seed_rows = [], []
    for n in range(N):
        a = FA[n] * deg
        rc = planes.rot_coeffs(a, cp[n], sp[n], c2p[n], s2p[n])
        drc = planes.rot_coeffs_db1(a, deg, cp[n], sp[n], c2p[n], s2p[n])
        ttot = TAU[n] + float(te) if te_sep else TAU[n]
        cF, cZ = torch.exp(-ttot / T2), torch.exp(-ttot / T1)
        dcZ1, dcF2 = planes.relax_tangents(cZ, cF, ttot, T1, T2)
        cFt, cZt, cFt2, cZt1 = planes.relax_tau_terms(cZ, cF, ttot, T1, T2)
        if te_sep:
            e2 = torch.exp(-float(te) / T2)
            de2 = e2 * float(te) / (T2 * T2)
            z = torch.zeros_like(cF)
            tau_c = (cFt, cZt, cZt1, cFt2, z, z)
        else:
            e2, de2 = cF, dcF2
            tau_c = (cFt, cZt, cZt1, cFt2, cFt, cFt2)
        coeffs.append((rc, drc, (cF, cZ, dcZ1, dcF2, e2, de2), tau_c,
                       (-cZt, -cZt1)))
        seed_rows.append((sP, sU1, sU2) if second_order else (sP,))
        y = [planes.apply_rot(rc, g) for g in (sP, sU1, sU2)]
        echo, new = step(y, coeffs[n][2], (1.0 - cZ, -dcZ1))
        for o, (re, im) in enumerate(echo):
            out_atom[2 * o, :, n], out_atom[2 * o + 1, :, n] = re, im
        sP, sU1, sU2 = (planes.shift_fold(g) for g in new)

    # the lane pass: groups (A, T, W1, W2, X1, X2) over lanes (H, B, N)
    chains = (0, 2, 3), (1, 4, 5)
    if not second_order:
        chains = (0,), (1,)
    lane = [zeros(N) for _ in range(G)]
    bc = lambda t: t.unsqueeze(-1)   # noqa: E731  per-atom over lanes
    for n in range(N):
        rc, drc, c, tau_c, tau_rec = coeffs[n]
        cF, cZ, dcZ1, dcF2, e2, de2 = (bc(v) for v in c)
        Y = [planes.apply_rot(rc, g) for g in lane]
        # the m = 0 form of fisp_hessian_plain: every group of every lane
        yA, yT = Y[0], Y[1]
        echo = [(e2 * yA[0][0], e2 * yA[1][0]), (e2 * yT[0][0],
                                                   e2 * yT[1][0])]
        new = [tuple(cF * v for v in yA[:4]) + tuple(cZ * v
                                                     for v in yA[4:]),
               tuple(cF * v for v in yT[:4]) + tuple(cZ * v
                                                     for v in yT[4:])]
        if second_order:
            yW1, yW2, yX1, yX2 = Y[2:]
            echo += [(e2 * yW1[0][0], e2 * yW1[1][0]),
                     tuple(e2 * yW2[j][0] + de2 * yA[j][0] for j in (0, 1)),
                     (e2 * yX1[0][0], e2 * yX1[1][0]),
                     tuple(e2 * yX2[j][0] + de2 * yT[j][0] for j in (0, 1))]
            new += [tuple(cF * v for v in yW1[:4])
                    + tuple(cZ * v + dcZ1 * p
                            for v, p in zip(yW1[4:], yA[4:])),
                    tuple(cF * v + dcF2 * p for v, p in zip(yW2[:4], yA[:4]))
                    + tuple(cZ * v for v in yW2[4:]),
                    tuple(cF * v for v in yX1[:4])
                    + tuple(cZ * v + dcZ1 * p
                            for v, p in zip(yX1[4:], yT[4:])),
                    tuple(cF * v + dcF2 * p for v, p in zip(yX2[:4], yT[:4]))
                    + tuple(cZ * v for v in yX2[4:])]
        # lane n starts: its chains' seeds (its state is zero before)
        for name, groups, rot, cs, rec in (
                ("A", chains[0], drc, c, (0.0, 0.0)),
                ("T", chains[1], rc, tau_c, tau_rec)):
            if name not in seeds:
                continue
            ys = [planes.apply_rot(rot, g) for g in seed_rows[n]]
            se, sn = step(ys, cs, rec)
            for g, e_, v in zip(groups, se, sn):
                echo[g] = tuple(x.clone() for x in echo[g])
                for j in (0, 1):
                    echo[g][j][:, n] = e_[j]
                new[g] = tuple(x.clone() for x in new[g])
                for j in range(6):
                    new[g][j][..., n] = v[j]
        for g in range(G):
            out_lane[2 * g, :, n], out_lane[2 * g + 1, :, n] = echo[g]
            out_lane[2 * g:2 * g + 2, :, n, n + 1:] = 0.0
        lane = [planes.shift_fold(v) for v in new]
    return cuda_hessian._result(out_atom, out_lane, second_order)


def seg_owned_atoms(geo, B):
    """The atoms the segmented kernels store, one entry per (block, warp,
    segment) that stores, for a launch geometry ``geo``
    (``cuda_fisp.seg_geometry``) over B atoms: block i's warp w, segment
    s < L, owns atom i * atoms + w * L + s when it is below B; the grid
    has ceil(B / atoms) blocks."""
    grid = -(-B // geo["atoms"])
    return [a for i in range(grid) for w in range(geo["warps"])
            for s in range(geo["L"])
            for a in [i * geo["atoms"] + w * geo["L"] + s] if a < B], grid


def warps_all(geo, flags):
    """Per atom, whether every atom of its warp has `flags` set, for a
    segmented launch geometry ``geo`` over B = len(flags) atoms: block i's
    warp w holds atoms i * atoms + w * L + s, s < L, clamped to B - 1 (its
    lanes past the last segment and past the last atom run on a clamped
    atom), as the kernels' warp-uniform tests (``__all_sync``) see them."""
    flags = np.asarray(flags, bool)
    B, L = len(flags), geo["L"]
    b = np.arange(B)
    first = (b // L) * L                       # the warp's first atom
    held = np.minimum(first[:, None] + np.arange(L)[None, :], B - 1)
    return flags[held].all(axis=1)


def to_f64(x):
    """Tensors of a (nested) argument tuple as float64 (other values as
    they are)."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, (tuple, list)):
        return type(x)(to_f64(v) for v in x)
    return x
