"""The FISP Jacobian kernel's plain twin vs the JAX Pallas kernel and the
float64 models.

On the CPU ``fisp_jacobian_cuda`` runs its plain PyTorch twin, held here
against ``fisp_jacobian_pallas(interpret=True)`` over the covering set of
option cases (chip_smoke.JAC_CASES), both in float32: fingerprints to
atol 1e-5, tangent columns to 1e-4 of the column's largest magnitude (the
JAX package's own Jacobian budget, tests/test_pallas.py:83-88: the
tangents are sums of more terms than the primal).  In float64 the twin
and the port's ``fisp_mrf_jacobian`` (a jvp of the full-ladder model)
equal JAX's ``fisp_mrf_jacobian`` to 1e-10 of each column's largest
magnitude.  The CUDA kernel itself is held against the twin on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import JAC_CASES, make_jac_case, _tensors
from epgpy_torch.models import cuda_dess, cuda_fisp, mrf, planes
from epgpy_tpu.models import mrf as jmrf
from epgpy_tpu.models.pallas_fisp import fisp_jacobian_pallas

from torch_support import (cplx, port_f32, port_f64,  # noqa: F401
                           seg_owned_atoms, seg_shift_emulated)

NATOMS, NPULSE = 100, 60     # 100 atoms: a ragged 128-atom tile in JAX


def _case(case, natoms, npulse, seed):
    args, kw = make_jac_case(case, natoms, npulse, seed=seed)
    kw["nstate"] = case.get("nstate", 5)
    return args, kw


def _col_err(got, want):
    """Per-column max |delta| relative to the column's largest value."""
    return [np.abs(got[..., c] - want[..., c]).max()
            / np.abs(want[..., c]).max() for c in range(want.shape[-1])]


@pytest.mark.parametrize("case", JAC_CASES, ids=lambda c: c["name"])
def test_plain_twin_matches_pallas_kernel(port_f32, case):
    args, kw = _case(case, NATOMS, NPULSE, seed=5)
    (re, im), (dre, dim) = fisp_jacobian_pallas(*args, interpret=True,
                                                btile=128, **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    (tre, tim), (tdre, tdim) = cuda_fisp.fisp_jacobian_cuda(*targs, **tkw)
    ncol = 4 if case.get("track_d") else 3
    assert tre.shape == (NATOMS, NPULSE)
    assert tdre.shape == (NATOMS, NPULSE, ncol) == np.shape(dre)
    sig, jac = cplx(tre, tim), cplx(tdre, tdim)
    assert np.isfinite(sig).all() and np.isfinite(jac).all()
    assert np.abs(sig - cplx(re, im)).max() < 1e-5
    assert max(_col_err(jac, cplx(dre, dim))) < 1e-4


F64_CASES = [c for c in JAC_CASES if c["name"] in (
    "base", "var_te", "inv", "inv_df", "df_demod", "demod", "nstate6")]


def _jax_f64(args, kw):
    FA, phi, TR, TE, T1, T2, B1, df = args
    (re, im), (dre, dim) = jmrf.fisp_mrf_jacobian(
        FA, TR, TE, T1, T2, B1, df, phi=phi, variables=("T1", "T2", "B1"),
        nstate=kw["nstate"], demodulate=kw["demodulate"],
        inversion=kw["inversion"])
    return cplx(re, im), cplx(dre, dim)


@pytest.mark.parametrize("case", F64_CASES, ids=lambda c: c["name"])
def test_f64_twin_and_model_match_jax_model(port_f64, case):
    """The folded twin (in float64) and the port's full-ladder
    fisp_mrf_jacobian both equal the JAX model (x64)."""
    args, kw = _case(case, 12, 50, seed=6)
    sig, jac = _jax_f64(args, kw)
    FA, phi, TR, TE, T1, T2, B1, df = args
    t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    (tre, tim), (tdre, tdim) = cuda_fisp.fisp_jacobian_plain(
        t(FA), t(phi), t(TR), TE if np.ndim(TE) == 0 else t(TE), t(T1),
        t(T2), t(B1), t(df), **kw)
    assert tre.dtype == torch.float64
    assert np.abs(cplx(tre, tim) - sig).max() < 1e-10 * np.abs(sig).max()
    assert max(_col_err(cplx(tdre, tdim), jac)) < 1e-10
    (mre, mim), (mdre, mdim) = mrf.fisp_mrf_jacobian(
        FA, TR, TE, T1, T2, B1, df, phi=phi, variables=("T1", "T2", "B1"),
        nstate=kw["nstate"], demodulate=kw["demodulate"],
        inversion=kw["inversion"])
    assert np.abs(cplx(mre, mim) - sig).max() < 1e-10 * np.abs(sig).max()
    assert max(_col_err(cplx(mdre, mdim), jac)) < 1e-10


def test_f64_model_variable_subsets(port_f64):
    """Columns follow `variables` (any subset and order of T1/T2/B1)."""
    args, kw = _case(JAC_CASES[0], 6, 30, seed=7)
    FA, phi, TR, TE, T1, T2, B1, _ = args
    _, full = mrf.fisp_mrf_jacobian(FA, TR, TE, T1, T2, B1, phi=phi,
                                    variables=("T1", "T2", "B1"), nstate=5)
    _, sub = mrf.fisp_mrf_jacobian(FA, TR, TE, T1, T2, B1, phi=phi,
                                   variables=("B1", "T1"), nstate=5)
    assert sub[0].shape == (6, 30, 2)
    assert torch.allclose(sub[0][..., 0], full[0][..., 2], rtol=0,
                          atol=1e-14)
    assert torch.allclose(sub[1][..., 1], full[1][..., 0], rtol=0,
                          atol=1e-14)


def test_dd_column_matches_finite_difference(port_f64):
    """The dD tangent (no JAX model has one) against a central finite
    difference of the twin's fingerprints in float64."""
    case = next(c for c in JAC_CASES if c["name"] == "diff_noramp_d")
    args, kw = _case(case, 8, 40, seed=8)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    targs = tuple(a.double() if isinstance(a, torch.Tensor) else a
                  for a in targs)
    bT, bL, Dc = tkw["diffusion"]
    Dc = Dc.double()
    tkw["diffusion"] = (bT, bL, Dc)
    _, (dre, dim) = cuda_fisp.fisp_jacobian_plain(*targs, **tkw)
    h = 1e-7
    kw0 = dict(tkw, track_diffusivity=False)
    (pr, pi), _ = cuda_fisp.fisp_jacobian_plain(
        *targs, **dict(kw0, diffusion=(bT, bL, Dc + h)))
    (mr, mi), _ = cuda_fisp.fisp_jacobian_plain(
        *targs, **dict(kw0, diffusion=(bT, bL, Dc - h)))
    fd = (cplx(pr, pi) - cplx(mr, mi)) / (2 * h)
    col = cplx(dre[..., 3], dim[..., 3])
    assert np.abs(col - fd).max() < 1e-6 * np.abs(col).max()


def test_cpu_tensors_take_the_plain_twin(port_f32):
    args, kw = make_jac_case(JAC_CASES[0], 40, 30)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    before = cuda_fisp.JAC_LAUNCHES
    a = cuda_fisp.fisp_jacobian_cuda(*targs, **tkw)
    b = cuda_fisp.fisp_jacobian_plain(*targs, **tkw)
    assert cuda_fisp.JAC_LAUNCHES == before
    assert torch.equal(a[0][0], b[0][0]) and torch.equal(a[1][1], b[1][1])
    assert a[0][0].shape == (40, 30) and a[1][0].shape == (40, 30, 3)
    (re, im), (dre, dim) = cuda_fisp.fisp_jacobian_echoes(*targs, **tkw)
    assert re.shape == (30, 40) and dre.shape == (30, 40, 3)
    assert torch.equal(re, a[0][0].T)
    with pytest.raises(TypeError):
        cuda_fisp.fisp_jacobian_cuda(*args, **kw)              # numpy T1s
    with pytest.raises(ValueError, match="nstate"):
        cuda_fisp.fisp_jacobian_plain(*targs, **{**tkw, "nstate": 0})
    with pytest.raises(ValueError, match="diffusion"):
        cuda_fisp.fisp_jacobian_plain(*targs, **{**tkw,
                                                 "track_diffusivity": True})


def test_jacobian_shared_memory_gate():
    # 24 (30) planes x (nstate+1) rows x 32 atoms x 4 B within 227 KB; the
    # DESS Jacobian kernel, the gate's last thread-per-atom user, now runs
    # the segmented layout: its geometry at the gate's depths keeps 24 R <=
    # 72 floats of state per lane and its chunk within 48 KB
    assert cuda_fisp.jac_kernel_fits(74) and not cuda_fisp.jac_kernel_fits(75)
    assert cuda_fisp.jac_kernel_fits(59, True)
    assert not cuda_fisp.jac_kernel_fits(60, True)
    geo = cuda_dess.dess_jac_geometry(10)
    assert (geo["R"], geo["W"], geo["L"], geo["warps"]) == (3, 4, 8, 4)
    geo = cuda_dess.dess_jac_geometry(40)
    assert (geo["R"], geo["W"], geo["L"], geo["warps"]) == (3, 14, 2, 4)
    for n in (1, 10, 36, 74):
        geo = cuda_dess.dess_jac_geometry(n)
        assert 24 * geo["R"] <= 72 and geo["smem"] <= 48 * 1024
        assert geo["smem"] <= cuda_fisp.SMEM_PER_BLOCK


# -- the segmented layout of fisp_jac.cu: its lane map, geometry and gate --

#: ladders of H = nstate + 1 rows: 2 (one row per lane, 16 per warp), 9,
#: 11 (the main paths' depths, two rows per lane), 32, 33 (one and two
#: ladders per warp), 64, 65 (two and three rows per lane), 75 (the gate's)
SEG_ROWS = (2, 9, 11, 32, 33, 64, 65, 75)


@pytest.mark.parametrize("H", SEG_ROWS)
def test_segmented_lane_map_matches_twin(port_f64, monkeypatch, H):
    """The float64 twin with every folded shift replayed through the
    segmented layout's lane map (epg::seg_shift, emulated in numpy with NaN
    in the idle lanes and padding rows) equals the twin exactly, every
    group and pulse: inversion, df, per-pulse TE, demodulation and the
    diffusion attenuation, with the dD group where the gate admits it; the
    train is longer than the ladder, so the shift reaches its last row."""
    case = dict(name="lane_map", var_te=True, inversion=20.0, df=True,
                demodulate=True, diffusion="ramp", track_d=H <= 60,
                nstate=H - 1)
    args, kw = make_jac_case(case, 37, H + 6, seed=9)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    targs = tuple(a.double() if isinstance(a, torch.Tensor) else a
                  for a in targs)
    bT, bL, Dc = tkw["diffusion"]
    tkw["diffusion"] = (bT, bL, Dc.double())
    want = cuda_fisp.fisp_jacobian_echoes_plain(*targs, **tkw)
    monkeypatch.setattr(planes, "shift_fold", seg_shift_emulated)
    got = cuda_fisp.fisp_jacobian_echoes_plain(*targs, **tkw)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.isfinite(g).all() and torch.equal(g, w)


@pytest.mark.parametrize("track_d", [False, True], ids=["G3", "G4"])
def test_segmented_launch_geometry(track_d):
    """For every ladder the gate admits: 1-3 rows per lane (2, 3 past 64
    rows, 1 up to 3 rows), a segment of W = ceil(H / R) lanes holding the
    H rows, as many ladders per warp as fit its 32 lanes, 1-4 warps per
    block, 1-32 pulses per chunk, the table and staged echoes within 48 KB
    of shared memory, and a grid whose (block, warp, segment) slots store
    each of 1, 2, 3, 33 and 4,097 atoms exactly once."""
    G = 4 if track_d else 3
    for n in range(1, (59 if track_d else 74) + 1):
        geo = cuda_fisp.fisp_jac_geometry(n, track_d)
        R, W, L, warps = geo["R"], geo["W"], geo["L"], geo["warps"]
        H = n + 1
        assert R == (1 if H <= 3 else 2 if H <= 64 else 3)
        assert W == -(-H // R) <= 32 and W * R >= H
        assert 1 <= L and L * W <= 32 < (L + 1) * W
        assert 1 <= warps <= cuda_fisp.SEG_WARPS == 4
        assert geo["atoms"] == warps * L
        assert 1 <= geo["pulses"] <= cuda_fisp.SEG_PULSES == 32
        assert geo["smem"] == 4 * geo["pulses"] * (
            cuda_fisp.SEG_TABLE + (2 + 2 * G) * geo["atoms"])
        assert geo["smem"] <= 48 * 1024 <= cuda_fisp.SMEM_PER_BLOCK
        for B in (1, 2, 3, 33, 4097):
            owned, grid = seg_owned_atoms(geo, B)
            assert sorted(owned) == list(range(B)), (n, B)
            assert (grid - 1) * geo["atoms"] < B <= grid * geo["atoms"]


def test_jacobian_gate_unchanged():
    """The gate answers as the thread-per-atom layout set it, for nstate
    1-400: nstate <= 74, and <= 59 with D; the segmented kernel keeps it,
    so no train changes route."""
    fits = [n for n in range(1, 401) if cuda_fisp.jac_kernel_fits(n)]
    fits_d = [n for n in range(1, 401) if cuda_fisp.jac_kernel_fits(n, True)]
    assert fits == list(range(1, 75))
    assert fits_d == list(range(1, 60))
    # the kernels' templates hold at most 3 rows per lane
    assert max(cuda_fisp.seg_layout(n)[0] for n in fits) <= 3
