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


def seg_shift_emulated(s):
    """``planes.shift_fold`` through the segmented layout's lane map, in
    numpy: the planes (each (H, B)) are laid out as the FISP and ME-GRE
    Jacobian kernels hold them -- a ladder in a segment of W lanes, 32 // W
    ladders per warp, lane r owning rows r + W c, c < R
    (``cuda_fisp.seg_layout``) -- with NaN in the lanes past the last
    segment and atom and in the padding rows; ``epg::seg_shift``
    (csrc/epg_planes.cuh) is replayed step by step (two rotations of each
    segment by one lane, then the row-0, wrap, last-row and padding
    selects), and the lanes' rows are read back.  A NaN that reached a
    ladder row would show in the result."""
    from epgpy_torch.models import cuda_fisp

    dtype = s[0].dtype
    v0 = np.stack([np.asarray(p, dtype=np.float64) for p in s])  # (6, H, B)
    H, B = v0.shape[1:]
    R, W, L = cuda_fisp.seg_layout(H - 1)
    nwarps = -(-B // L)
    lane = np.arange(32)
    seg, r = lane // W, lane % W
    base = seg * W
    k = r[None, :] + W * np.arange(R)[:, None]                   # (R, 32)
    atom = np.arange(nwarps)[:, None] * L + seg[None, :]         # (w, 32)
    valid = ((seg < L)[None, None, :] & (atom < B)[None, :, :]
             & (k < H)[:, None, :])                              # (R, w, 32)
    kk = np.broadcast_to(np.minimum(k, H - 1)[:, None, :], valid.shape)
    aa = np.broadcast_to(np.minimum(atom, B - 1)[None], valid.shape)
    v = np.where(valid[None], v0[:, kk, aa], np.nan)        # (6, R, w, 32)
    first, last = r == 0, r == W - 1
    below = np.where(first, base + W - 1, lane - 1) % 32
    above = np.where(last, base, lane + 1) % 32
    a, b = v[0:2][..., below], v[2:4][..., above]
    out = v.copy()
    for c in range(R):
        kc = k[c]
        A = np.where(first, b[:, 0] if c == 0 else a[:, c - 1], a[:, c])
        up = last & (c + 1 < R)
        Bn = np.where(up, b[:, min(c + 1, R - 1)], b[:, c])
        keep = kc < H
        zero_b = kc >= H - 1
        out[0:2, c] = np.where(keep, A, 0.0)
        out[2:4, c] = np.where(zero_b, 0.0, Bn)
        out[4:6, c] = np.where(keep, v[4:6, c], 0.0)
    res = np.zeros_like(v0)
    c_, w_, l_ = np.nonzero(valid)
    res[:, k[c_, l_], atom[w_, l_]] = out[:, c_, w_, l_]
    return tuple(torch.as_tensor(x, dtype=dtype) for x in res)


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
