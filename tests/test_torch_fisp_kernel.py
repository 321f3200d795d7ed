"""The FISP dictionary kernel's plain twin vs the JAX Pallas kernel.

On the CPU ``fisp_dictionary_cuda`` runs its plain PyTorch twin, which is
held here against ``fisp_dictionary_pallas(interpret=True)`` over the
covering set of option cases (chip_smoke.OPTION_CASES), both in float32:
atol 1e-5, since the two sides round differently (operation order, libm)
and the difference grows with the pulse count.  In float64 the folded
twin equals the port's full-ladder model (models/mrf.py) to 1e-11, which
proves the fold; with every shift replayed through the CUDA kernel's
lane map (blocked rows, ``torch_support.seg_shift_emulated``) it equals
itself exactly, and the kernel's geometry and the gates are pinned.  The CUDA kernel itself is held against the twin on the
card (tests/test_torch_cuda.py and chip_smoke.py).

The full-ladder twin (``fisp_full_ladder_plain``, the JAX wrapper's
``half_ladder=False`` and its nstate-0 route) is held against
``fisp_dictionary_pallas(half_ladder=False, interpret=True)`` at nstate 0
and at nstate >= 1 (1e-5, float32 both), and against the folded twin at
nstate >= 1 (float64, 1e-11: the fold is exact).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (FULL_CASES, HALF_EDGE_CASES, HALF_EDGE_PULSES,
                        HALF_ROW_EDGES, OPTION_CASES, make_case, _tensors)
from epgpy_torch.models import cuda_fisp, mrf, planes
from epgpy_tpu.models.pallas_fisp import fisp_dictionary_pallas

from torch_support import (cplx, port_f32, port_f64,  # noqa: F401
                           seg_owned_atoms, seg_shift_emulated)

NATOMS, NPULSE = 200, 120     # 200 atoms: a ragged 128-atom tile in JAX


def _jax(args, kw):
    re, im = fisp_dictionary_pallas(*args, interpret=True, btile=128, **kw)
    return cplx(re, im)


@pytest.mark.parametrize("case", OPTION_CASES, ids=lambda c: c["name"])
def test_plain_twin_matches_pallas_kernel(port_f32, case):
    args, kw = make_case(case, NATOMS, NPULSE, seed=3)
    want = _jax(args, kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    got = cplx(*cuda_fisp.fisp_dictionary_cuda(*targs, **tkw))
    assert got.shape == want.shape == (NATOMS, NPULSE)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-5


FOLD_CASES = [c for c in OPTION_CASES
              if c["name"] in ("base", "var_te", "inv", "inv_df", "df_demod",
                               "normalize", "nstate6")]


@pytest.mark.parametrize("case", FOLD_CASES, ids=lambda c: c["name"])
def test_fold_matches_full_ladder(port_f64, case):
    """The folded half-ladder twin == the full (2N+1)-row model, f64."""
    (FA, phi, TR, TE, T1, T2, B1, df), kw = make_case(case, 16, 80, seed=4)
    re, im = mrf.fisp_mrf_dictionary(
        FA, TR, TE, T1, T2, B1, df, phi=phi, nstate=kw["nstate"],
        demodulate=kw["demodulate"], inversion=kw["inversion"],
        normalize=kw["normalize"])
    t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    fre, fim = cuda_fisp.fisp_dictionary_plain(
        t(FA), t(phi), t(TR), TE if np.ndim(TE) == 0 else t(TE), t(T1),
        t(T2), t(B1), t(df), **kw)
    assert fre.dtype == torch.float64
    assert np.abs(cplx(fre, fim) - cplx(re, im)).max() < 1e-11


def test_cpu_tensors_take_the_plain_twin(port_f32):
    args, kw = make_case(OPTION_CASES[0], 40, 30)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    before = cuda_fisp.LAUNCHES
    a = cuda_fisp.fisp_dictionary_cuda(*targs, **tkw)
    b = cuda_fisp.fisp_dictionary_plain(*targs, **tkw)
    assert cuda_fisp.LAUNCHES == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # (B, P) views of the (P, B) echo train
    assert a[0].shape == (40, 30) and a[0].T.is_contiguous()
    with pytest.raises(TypeError):
        cuda_fisp.fisp_dictionary_cuda(*args, **kw)     # numpy T1s
    with pytest.raises(ValueError, match="nstate"):
        cuda_fisp.fisp_dictionary_plain(*targs, **{**tkw, "nstate": -1})
    # nstate 0 takes the full-ladder twin, as the JAX wrapper does
    before = cuda_fisp.FULL_LAUNCHES
    z = cuda_fisp.fisp_dictionary_cuda(*targs, **{**tkw, "nstate": 0})
    f = cuda_fisp.fisp_full_ladder_plain(*targs, **{**tkw, "nstate": 0})
    assert cuda_fisp.FULL_LAUNCHES == before
    assert torch.equal(z[0], f[0]) and torch.equal(z[1], f[1])


def test_shared_memory_gate():
    # 6 planes x (nstate+1) rows x 32 atoms x 4 B within 227 KB per block
    assert cuda_fisp.kernel_fits(301) and not cuda_fisp.kernel_fits(302)
    assert cuda_fisp.block_size(10) == 128
    assert cuda_fisp.block_size(100) == 64
    assert cuda_fisp.block_size(301) == 32
    for n in (1, 10, 40, 150, 301):
        assert (24 * (n + 1) * cuda_fisp.block_size(n)
                <= cuda_fisp.SMEM_PER_BLOCK)


@pytest.mark.parametrize("case", FULL_CASES[::3] + FULL_CASES[1::4],
                         ids=lambda c: c["name"])
def test_full_ladder_twin_matches_pallas_kernel(port_f32, case):
    args, kw = make_case(case, 40, 60, seed=5)
    re, im = fisp_dictionary_pallas(*args, interpret=True, btile=128,
                                    half_ladder=False, **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    got = cplx(*cuda_fisp.fisp_full_ladder_cuda(*targs, **tkw))
    assert got.shape == (40, 60)
    assert np.abs(got - cplx(re, im)).max() < 1e-5
    if kw["nstate"] == 0:
        # the dictionary's nstate-0 route is this kernel
        z = cplx(*cuda_fisp.fisp_dictionary_cuda(*targs, **tkw))
        assert np.array_equal(z, got)


@pytest.mark.parametrize("case", [c for c in FULL_CASES if c["nstate"]],
                         ids=lambda c: c["name"])
def test_full_ladder_twin_equals_fold(port_f64, case):
    """The full-ladder twin == the folded half-ladder twin, float64."""
    (FA, phi, TR, TE, T1, T2, B1, df), kw = make_case(case, 12, 50, seed=6)
    t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    targs = (t(FA), t(phi), t(TR), TE if np.ndim(TE) == 0 else t(TE), t(T1),
             t(T2), t(B1), t(df))
    kw = {k: v for k, v in kw.items() if k != "normalize"}
    full = cuda_fisp.fisp_full_ladder_plain(*targs, **kw)
    fold = cuda_fisp.fisp_dictionary_plain(*targs, **kw)
    assert full[0].dtype == torch.float64
    assert np.abs(cplx(*full) - cplx(*fold)).max() < 1e-11


def test_full_ladder_gate_and_diffusion():
    # 6 planes x (2 nstate + 1) rows x 32 atoms x 4 B within 227 KB
    assert cuda_fisp.full_kernel_fits(150)
    assert not cuda_fisp.full_kernel_fits(151)
    assert cuda_fisp.full_block_size(10) == 128
    assert cuda_fisp.full_block_size(150) == 32
    args, kw = _tensors(torch, *make_case(OPTION_CASES[7], 8, 10), "cpu")
    with pytest.raises(ValueError, match="half-ladder"):
        cuda_fisp.fisp_dictionary_cuda(*args, **{**kw, "nstate": 0})


# -- the segmented layout of fisp_half.cu: lane map, geometry and gates --


def _f64(args):
    return tuple(None if a is None else a if np.ndim(a) == 0
                 else torch.as_tensor(np.asarray(a, np.float64))
                 for a in args)


#: the lane-map replay's cases: every option case at the headline depth
#: (one lane per ladder) and the kernel's edges (the gate's nstate 301 on
#: 26 lanes with and without DW-FISP, TR / TE runs, both sides of every
#: change of the rows per lane)
HALF_LANE_CASES = OPTION_CASES + HALF_EDGE_CASES


@pytest.mark.parametrize("case", HALF_LANE_CASES, ids=lambda c: c["name"])
def test_fisp_half_lane_map_matches_twin(monkeypatch, case):
    """The float64 FISP twin with every folded shift replayed through the
    kernel's lane map at its rows per lane (blocked rows,
    epg::seg_shift_blocked, emulated in numpy with NaN in the idle lanes,
    past the last atom and in the padding rows) equals the twin, over 37
    atoms and a train HALF_EDGE_PULSES pulses longer than the ladder (60
    pulses at least)."""
    nstate = case.get("nstate", 10)
    npulse = max(60, nstate + 1 + HALF_EDGE_PULSES)
    args, kw = make_case(case, 37, npulse, seed=7)
    kw = {k: v for k, v in kw.items() if k != "normalize"}
    if "diffusion" in kw:
        bT, bL, Dc = kw["diffusion"]
        kw["diffusion"] = (bT, bL, torch.as_tensor(Dc))
    targs = _f64(args)
    want = cuda_fisp.fisp_echoes_plain(*targs, **kw)
    R = cuda_fisp.fisp_half_geometry(nstate, "diffusion" in kw)["R"]
    calls = [0]

    def shift(s):
        calls[0] += 1
        return seg_shift_emulated(s, R, blocked=True)

    monkeypatch.setattr(planes, "shift_fold", shift)
    got = cuda_fisp.fisp_echoes_plain(*targs, **kw)
    assert calls[0] == npulse
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and torch.isfinite(g).all()
        assert torch.equal(g, w)


@pytest.mark.parametrize("diffusion", [False, True])
def test_fisp_half_geometry(diffusion):
    """For every ladder the gate admits (nstate 1-301, with and without
    DW-FISP): R rows per lane in the kernel's instances (1, 2, 4, ..., 12),
    the fewest lanes per ladder W = ceil(H / R) <= 32 that keep R within
    12, L = 32 // W ladders per warp, 4 warps and 32 pulses per chunk, the
    table and the staged echoes within 48 KB; a grid whose (block, warp,
    segment) slots store each of 1, 33 and 4,097 atoms exactly once; with
    DW-FISP, each thread's 3 R attenuation factors in shared memory too,
    four blocks still fitting an SM; one
    ladder of 12 rows per lane at the headline's nstate 10 (32 per warp,
    800 blocks at 102,400 atoms) and 12 rows on 26 lanes at nstate 301."""
    assert cuda_fisp.HALF_ROWS == (1, 2, 4, 6, 8, 10, 12)
    for n in range(1, 302):
        geo = cuda_fisp.fisp_half_geometry(n, diffusion)
        H, R, W, L = n + 1, geo["R"], geo["W"], geo["L"]
        assert R in cuda_fisp.HALF_ROWS
        assert W == -(-H // R) <= 32 and L == 32 // W
        fewest = -(-H // 12)
        assert W <= fewest and R - -(-H // fewest) in (0, 1)
        assert (geo["warps"], geo["pulses"]) == (4, 32)
        assert geo["atoms"] == 4 * L
        chunk = 4 * 32 * (cuda_fisp.HALF_TABLE + 2 * geo["atoms"])
        assert chunk <= 48 * 1024
        assert geo["smem"] == chunk + (4 * 3 * R * 128 if diffusion else 0)
        assert 4 * (geo["smem"] + 1024) <= 233472   # 4 blocks per SM
        for B_ in (1, 33, 4097):
            owned, _ = seg_owned_atoms(geo, B_)
            assert sorted(owned) == list(range(B_)), (n, B_)
    main = cuda_fisp.fisp_half_geometry(10, diffusion)
    assert (main["R"], main["W"], main["L"]) == (12, 1, 32)
    assert -(-102400 // main["atoms"]) == 800
    top = cuda_fisp.fisp_half_geometry(301, diffusion)
    assert (top["R"], top["W"]) == (12, 26)


def test_half_row_edges_cover_every_change():
    """HALF_ROW_EDGES, the nstates of the card's edge cases, holds both
    sides of every nstate where the rows per lane change (1-301)."""
    ch = [n for n in range(2, 302)
          if cuda_fisp.half_rows(n) != cuda_fisp.half_rows(n - 1)]
    assert ch and sorted({c - 1 for c in ch} | set(ch)) == list(
        HALF_ROW_EDGES)


def test_fisp_gates_unchanged():
    """kernel_fits (the FISP dictionary's gate, also DESS's, ME-GRE's and
    DW-FISP's) and block_size (dess.cu launches with it) over
    nstate 0-400 answer as the thread-per-atom layout set them: fits up to
    nstate 301; 128 threads to nstate 74, 64 to 150, 32 above."""
    for n in range(401):
        assert cuda_fisp.kernel_fits(n) == (n <= 301), n
        assert cuda_fisp.block_size(n) == (128 if n <= 74 else 64
                                           if n <= 150 else 32), n
