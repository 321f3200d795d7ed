"""The CPMG family of epgpy_torch vs epgpy_tpu: kernels' plain twins,
dispatch, Jacobian probes and the goldens.

* ``cpmg_dictionary_plain`` / ``cpmg_jacobian_plain`` (float32) vs the JAX
  Pallas kernels in interpret mode, 64 atoms x 8 echoes, nstate 16, over
  the options (DW on/off, ramps, per-echo spacings and phases, B1 batch):
  echoes to 2e-6 absolute, tangent columns to 1e-5 of the column's scale
  (float32 both, a different operation order);
* the float64 paths -- ``simulate(fisp_kernel="force")`` (the twin),
  ``simulate(fisp_kernel=False)`` (the eager loop) and ``mse_signal`` --
  vs the goldens ``cpmg.npz``, ``mse_b1.npz`` and ``dw_cpmg.npz`` to
  1e-10;
* ``match_mse`` returns the JAX matcher's dict, key by key, engages
  ``DISPATCH_COUNTS["mse"]`` / ``["jac:mse"]`` and falls through with a
  logged reason on off-pattern trains;
* Jacobian probes through the CPMG Jacobian twin == the port's general
  diff path to 1e-8 in float64;
* a JAX match dict carried through ``convert`` runs the port's runners
  to the JAX runners' values.
"""

import logging
import os

import numpy as np
import pytest
import torch

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch.convert import from_numpy_params
from epgpy_torch.models import cuda_fisp, cuda_mse
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu.models import pallas_mse

from chip_smoke import MSE_CASES, make_mse_case
from epgpy_torch.models import planes
from torch_support import (GOLDEN_DIR, ShiftRecorder, cplx,  # noqa: F401
                           port_f32, port_f64, rows_beyond, seg_owned_atoms,
                           seg_shift_emulated)

KV = 2 * np.pi / 1e-3        # 1 mm voxel: 6283 rad/m per state index
EXC = (90.0, 90.0)
B, NECHO, NSTATE = 64, 8, 16

#: option cases of the two CPMG kernels
CASES = {
    "base": dict(),
    "spacing_phase": dict(var=True),
    "b1": dict(b1=True),
    "dw_ramp": dict(diff=(True, True)),
    "dw_const_ramp": dict(diff=(False, True), var=True),
    "dw_b1": dict(diff=(True, False), b1=True),
}


def _inputs(case, seed=0):
    """Numpy inputs (args, kwargs) of one option case for
    cpmg_{dictionary,jacobian}_{plain,pallas}."""
    rng = np.random.default_rng(seed)
    FA = rng.uniform(100.0, 180.0, NECHO)
    if case.get("var"):
        phi = rng.uniform(0.0, 40.0, NECHO)
        tau1, tau2 = rng.uniform(3.0, 6.0, NECHO), rng.uniform(3.0, 6.0, NECHO)
    else:
        phi, tau1, tau2 = np.zeros(NECHO), np.full(NECHO, 4.5), \
            np.full(NECHO, 4.5)
    T1 = rng.uniform(400.0, 1600.0, B)
    T2 = rng.uniform(30.0, 150.0, B)
    B1 = rng.uniform(0.6, 1.1, B) if case.get("b1") else np.ones(B)
    kw = dict(nstate=NSTATE)
    if case.get("diff"):
        kw["diffusion"] = (3.0, 4.0, 5.0, 6.0, rng.uniform(5e-4, 3e-3, B),
                           rng.uniform(5e-4, 3e-3, B))
        kw["diff_ramp"] = case["diff"]
    return (EXC, FA, phi, tau1, tau2, T1, T2, B1), kw


def _torch(args, kw):
    """float32 CPU tensors of the per-atom inputs."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    args = args[:5] + tuple(t(a) for a in args[5:])
    kw = dict(kw)
    if "diffusion" in kw:
        kw["diffusion"] = kw["diffusion"][:4] + tuple(
            t(d) for d in kw["diffusion"][4:])
    return args, kw


@pytest.mark.parametrize("name", CASES)
def test_cpmg_twin_matches_jax_kernel(name):
    args, kw = _inputs(CASES[name])
    jre, jim = pallas_mse.cpmg_dictionary_pallas(*args, interpret=True, **kw)
    tre, tim = cuda_mse.cpmg_dictionary_plain(*_torch(args, kw)[0],
                                              **_torch(args, kw)[1])
    assert tre.shape == (B, NECHO) and tre.dtype == torch.float32
    assert np.abs(tre.numpy() - np.asarray(jre)).max() < 2e-6
    assert np.abs(tim.numpy() - np.asarray(jim)).max() < 2e-6


@pytest.mark.parametrize("name", CASES)
def test_cpmg_jacobian_twin_matches_jax_kernel(name):
    args, kw = _inputs(CASES[name], seed=1)
    (jre, jim), (jdre, jdim) = pallas_mse.cpmg_jacobian_pallas(
        *args, interpret=True, **kw)
    targs, tkw = _torch(args, kw)
    (tre, tim), (tdre, tdim) = cuda_mse.cpmg_jacobian_plain(*targs, **tkw)
    assert tdre.shape == (B, NECHO, 3)
    assert np.abs(cplx(tre, tim) - cplx(jre, jim)).max() < 2e-6
    want, got = cplx(jdre, jdim), cplx(tdre, tdim)
    for c in range(3):
        scale = np.abs(want[..., c]).max()
        assert np.abs(got[..., c] - want[..., c]).max() < 1e-5 * scale, c


def test_echo_layout_and_launch_counters():
    """The echo-layout wrappers take the twins for CPU tensors and count no
    kernel launch; the dictionary is the transposed echo train."""
    args, kw = _torch(*_inputs(CASES["b1"]))
    before = (cuda_mse.LAUNCHES, cuda_mse.JAC_LAUNCHES)
    re, im = cuda_mse.cpmg_echoes(*args, **kw)
    dre, dim = cuda_mse.cpmg_dictionary_cuda(*args, **kw)
    (jre, _), (jd, _) = cuda_mse.cpmg_jacobian_echoes(*args, **kw)
    assert torch.equal(re, dre.T) and torch.equal(im, dim.T)
    assert torch.equal(re, jre) and jd.shape == (NECHO, B, 3)
    assert (cuda_mse.LAUNCHES, cuda_mse.JAC_LAUNCHES) == before
    assert cuda_mse.mse_kernel_fits(301) and not cuda_mse.mse_kernel_fits(302)
    assert cuda_mse.mse_kernel_fits(150, True)
    assert not cuda_mse.mse_kernel_fits(151, True)
    assert cuda_mse.mse_jac_kernel_fits(74)
    assert not cuda_mse.mse_jac_kernel_fits(60, True)
    # atom-warps per block (one warp per atom), with and without DW-TSE
    assert cuda_mse.mse_jac_block_size(36) == 8
    assert cuda_mse.mse_jac_block_size(36, True) == 8
    with pytest.raises(TypeError):
        cuda_mse.cpmg_echoes(*args[:5], np.ones(3), *args[6:], **kw)


# -- what the warp-row Jacobian kernel's chunk skip and geometry rest on --


#: cases of the reach test: per-echo spacings and phases, a B1 batch,
#: DW-TSE with and without the ramp term
REACH_CASES = {
    "base": dict(),
    "spacing_phase_b1": dict(var=True, b1=True),
    "dw_ramps": dict(diff=(True, False), var=True),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", REACH_CASES)
def test_jacobian_twin_ladder_stays_within_reach(monkeypatch, name, dtype):
    """After half-stage h (0-based, two per echo) every group of the
    Jacobian twin is exactly zero past row min(h + 1, nstate): rows the
    echo cannot have reached hold zeros, the invariant by which the kernel
    skips the 32-row chunks beyond the reach.  And a train cut to j + 1
    echoes gives the same outputs at nstate 2 (j + 1) and deeper."""
    args, kw = _inputs(REACH_CASES[name], seed=3)
    targs, tkw = _torch(args, kw)
    targs = targs[:5] + tuple(a.to(dtype) for a in targs[5:])
    if "diffusion" in tkw:
        tkw["diffusion"] = tkw["diffusion"][:4] + tuple(
            d.to(dtype) for d in tkw["diffusion"][4:])
    rec = ShiftRecorder(monkeypatch)
    cuda_mse.cpmg_jacobian_echoes_plain(*targs, **tkw)
    assert len(rec.sets) == 2 * NECHO * 4
    for q, s in enumerate(rec.sets):
        h = q // 4
        assert rows_beyond(s, min(h + 1, NSTATE)) == 0.0, (q, h)
    for j in (0, 2, 5):
        cut = targs[:1] + tuple(a[:j + 1] for a in targs[1:5]) + targs[5:]
        want = cuda_mse.cpmg_jacobian_echoes_plain(
            *cut, **dict(tkw, nstate=2 * (j + 1)))
        for n in (2 * (j + 1) + 1, 2 * (j + 1) + 9, 40):
            got = cuda_mse.cpmg_jacobian_echoes_plain(*cut,
                                                      **dict(tkw, nstate=n))
            for a, b in zip(got[0] + got[1], want[0] + want[1]):
                assert torch.equal(a, b), (j, n)


#: the Jacobian gates as the one-thread-per-atom layout set them: the
#: warp-row kernel keeps them, so no train changes route
JAC_GATE = {False: 74, True: 59}


@pytest.mark.parametrize("diffusion", [False, True])
def test_jacobian_gate_unchanged(diffusion):
    """mse_jac_kernel_fits over nstate 1-400 is the pinned table: nstate
    <= 74 without DW-TSE, <= 59 with it."""
    got = [cuda_mse.mse_jac_kernel_fits(n, diffusion) for n in range(1, 401)]
    assert got == [n <= JAC_GATE[diffusion] for n in range(1, 401)]


@pytest.mark.parametrize("diffusion", [False, True])
def test_jacobian_launch_geometry_fits(diffusion):
    """For every ladder the gate admits: 1 to 8 atom-warps per block whose
    row records (24 plane values, 30 with DW-TSE, and one more) fit one
    block's shared memory."""
    record = (30 if diffusion else 24) + 1
    for n in range(1, JAC_GATE[diffusion] + 1):
        warps = cuda_mse.mse_jac_block_size(n, diffusion)
        assert 1 <= warps <= cuda_mse.JAC_MAX_WARPS == 8, n
        smem = 4 * record * (n + 1) * warps
        assert cuda_mse.jac_block_smem(n, warps, diffusion) == smem, n
        assert smem <= cuda_fisp.SMEM_PER_BLOCK, n


# -- the segmented CPMG kernel: reach, lane map, geometry, gate --


def _mse64(case, natoms, necho, seed=2):
    """chip_smoke.make_mse_case's inputs as float64 CPU tensors."""
    args, kw = make_mse_case(case, natoms, necho, seed)
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64))  # noqa: E731
    if kw.get("diffusion") is not None:
        kw["diffusion"] = kw["diffusion"][:4] + tuple(
            f64(d) for d in kw["diffusion"][4:])
    return args[:5] + tuple(f64(a) for a in args[5:]), kw


def _reach(i, half, H):
    """epg::reach: the last row half-stage `half` (1, 2) of echo i can
    make non-zero, within the ladder."""
    return min(2 * i + half, H - 1)


#: (case, nstate, echoes) of the primal reach test: the published depth
#: and a truncated ladder (nstate 8 < 2 x 18 echoes), each with and
#: without DW-TSE
CPMG_REACH_RUNS = [(name, n, 18) for name in ("spacing_phase_b1", "dw_ramps")
                   for n in (36, 8)]


@pytest.mark.parametrize("name,nstate,necho", CPMG_REACH_RUNS,
                         ids=lambda v: str(v))
def test_cpmg_twin_ladder_stays_within_reach(monkeypatch, name, nstate,
                                            necho):
    """After half-stage (i, half) the CPMG twin's ladder is exactly zero
    past row epg::reach(i, half, H) and not at it (with DW-TSE, whose
    attenuation keeps zeros; on a truncated ladder the reach clamps at the
    last row): the invariant a chunk skip rests on, as in the Jacobian
    kernel.  The primal kernel measured faster stepping every row on
    blocked rows than skipping chunks on cyclic ones (PERF.md)."""
    case = dict(REACH_CASES[name], nstate=nstate)
    targs, tkw = _mse64(case, 7, necho)
    rec = ShiftRecorder(monkeypatch)
    cuda_mse.cpmg_echoes_plain(*targs, **tkw)
    assert len(rec.sets) == 2 * necho
    for q, s in enumerate(rec.sets):
        i, half = divmod(q, 2)
        top = _reach(i, half + 1, nstate + 1)
        assert rows_beyond(s, top) == 0.0, (q, top)
        assert rows_beyond(s, top - 1) > 0.0 or top == nstate, (q, top)


#: the lane-map replay's cases: MSE_CASES' options (the gates' 74 and 59
#: among them) and truncated ladders with and without DW-TSE
CPMG_LANE_CASES = MSE_CASES + [
    dict(name="truncated", var=True, b1=True, nstate=8),
    dict(name="truncated_dw", diff=(True, True), var=True, nstate=8),
]


@pytest.mark.parametrize("case", CPMG_LANE_CASES, ids=lambda c: c["name"])
def test_cpmg_lane_map_matches_twin(monkeypatch, case):
    """The float64 CPMG twin with every folded shift replayed through the
    kernel's lane map at its rows per lane (blocked rows,
    epg::seg_shift_blocked, emulated in numpy with NaN in the idle lanes
    and the padding rows) is within 1e-12 of the twin (equal), over 37
    atoms x 18 echoes."""
    targs, tkw = _mse64(case, 37, 18)
    want = cuda_mse.cpmg_echoes_plain(*targs, **tkw)
    R = cuda_mse.cpmg_geometry(tkw["nstate"], "diffusion" in tkw)["R"]
    calls = [0]

    def shift(s):
        calls[0] += 1
        return seg_shift_emulated(s, R, blocked=True)

    monkeypatch.setattr(planes, "shift_fold", shift)
    got = cuda_mse.cpmg_echoes_plain(*targs, **tkw)
    assert calls[0] == 2 * 18
    for g_, w in zip(got, want):
        assert g_.dtype == torch.float64 and torch.isfinite(g_).all()
        assert float((g_ - w).abs().max()) <= 1e-12
        assert torch.equal(g_, w)


@pytest.mark.parametrize("diffusion", [False, True])
def test_cpmg_geometry(diffusion):
    """For every ladder the gate admits (nstate 0-301, 0-150 with DW-TSE):
    the fewest lanes per ladder W >= 2 with ceil(H / W) <= 10 rows per
    lane, R that count rounded up to even above 1 (the kernel's instances:
    1, 2, 4, 6, 8, 10), W = ceil(H / R) <= 32, 32 // W ladders per warp; 4
    warps, 32 echoes per chunk, the echo table in shared memory; a grid
    whose (block, warp, segment) slots store each of 1, 33 and 4,097
    atoms exactly once; R = 10, W = 4 at the published nstate 36."""
    top = 150 if diffusion else 301
    for n in range(0, top + 1):
        geo = cuda_mse.cpmg_geometry(n, diffusion)
        H, R, W, L = max(n, 1) + 1, geo["R"], geo["W"], geo["L"]
        assert R in (1, 2, 4, 6, 8, 10) and cuda_mse.CPMG_MAX_ROWS == 10
        assert 2 <= W == -(-H // R) <= 32 and L == 32 // W
        fewest = max(2, -(-H // 10))
        assert R - -(-H // fewest) in (0, 1) and W <= fewest
        assert (geo["warps"], geo["echoes"]) == (4, 32)
        assert geo["atoms"] == 4 * L
        assert geo["smem"] == 4 * cuda_mse.CPMG_TABLE * 32
        for B_ in (1, 33, 4097):
            owned, _ = seg_owned_atoms(geo, B_)
            assert sorted(owned) == list(range(B_)), (n, B_)
    main = cuda_mse.cpmg_geometry(36, diffusion)
    assert (main["R"], main["W"], main["L"]) == (10, 4, 8)
    assert cuda_mse.cpmg_geometry(top, diffusion)["W"] == (
        16 if diffusion else 31)


@pytest.mark.parametrize("diffusion", [False, True])
def test_primal_gate_unchanged(diffusion):
    """mse_kernel_fits over nstate 0-400 answers as the one-thread-per-atom
    layout set it: 6 planes (12 with DW-TSE) of max(nstate, 1) + 1 rows at
    32 atoms in 232,448 bytes -- nstate <= 301 (150)."""
    planes_ = 12 if diffusion else 6
    for n in range(401):
        assert cuda_mse.mse_kernel_fits(n, diffusion) == (
            4 * planes_ * (max(n, 1) + 1) * 32 <= 232448), n
    assert cuda_mse.mse_kernel_fits(150 if diffusion else 301, diffusion)
    assert not cuda_mse.mse_kernel_fits(151 if diffusion else 302,
                                        diffusion)


# -- float64 paths vs the goldens --


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


def _cpmg_golden_train(e):
    g = _golden("cpmg")
    T2s = list(g["T2s"])
    return ([e.T(90, 90)] + [e.E(4.5, 1400, T2s), e.S(1), e.T(150, 0),
                             e.E(4.5, 1400, T2s), e.S(1), e.ADC] * 8,
            {}, g["signal"])


def _mse_b1_train(e):
    g = _golden("mse_b1")
    seq = [e.T(90, 90)]
    for _ in range(g["signal"].shape[0]):
        seq += [e.E(4.5, 1400, g["T2s"]), e.S(1),
                e.T(150 * g["B1s"][None, :], 0),
                e.E(4.5, 1400, g["T2s"]), e.S(1), e.ADC]
    return seq, {}, g["signal"]


def _dw_train(e, key):
    g = _golden("dw_cpmg")
    Dc = 1.2e-3 if key == "signal" else np.diag([1.5e-3, 0.5e-3, 0.25e-3])
    d1, d2 = e.D(4.0, Dc, k=1), e.D(4.5, Dc, k=1)
    seq = [e.T(90, 90)]
    for i in range(10):
        seq += [e.E(4.0, g["T1s"], g["T2s"]), e.S(1), d1,
                e.T(100.0 + 4.0 * (i % 5), 0.0),
                e.E(4.5, g["T1s"], g["T2s"]), e.S(1), d2, e.ADC]
    return seq, {"kvalue": float(g["kvalue"])}, g[key]


GOLDENS = {
    "cpmg": _cpmg_golden_train,
    "mse_b1": _mse_b1_train,
    "dw_cpmg": lambda e: _dw_train(e, "signal"),
    "dw_cpmg_tensor": lambda e: _dw_train(e, "signal_tensor"),
}


@pytest.mark.parametrize("name", GOLDENS)
def test_float64_paths_match_goldens(port_f64, name):
    seq, kw, golden = GOLDENS[name](tepg)
    before = tfd.DISPATCH_COUNTS.get("mse", 0)
    forced = tepg.simulate(seq, fisp_kernel="force", **kw)
    assert tfd.DISPATCH_COUNTS.get("mse", 0) == before + 1
    loop = tepg.simulate(seq, fisp_kernel=False, **kw)
    assert tfd.DISPATCH_COUNTS.get("mse", 0) == before + 1
    assert forced.dtype == loop.dtype == np.complex128
    assert forced.shape == loop.shape == golden.shape
    assert np.abs(forced - golden).max() < 1e-10
    assert np.abs(loop - golden).max() < 1e-10


def test_mse_signal_matches_goldens(port_f64):
    g = _golden("cpmg")
    got = tepg.models.mse_signal(8, 1400.0, list(g["T2s"]), esp=9.0)
    assert np.abs(got - g["signal"]).max() < 1e-10
    g = _golden("mse_b1")
    got = tepg.models.mse_signal(18, 1400.0, g["T2s"], B1=g["B1s"][None, :])
    assert got.shape == g["signal"].shape
    assert np.abs(got - g["signal"]).max() < 1e-10
    seq = tepg.models.cpmg_sequence(3)
    assert len(seq) == 13 and isinstance(seq[1], tepg.S)


def test_simulate_force_float32_matches_jax_forced(port_f32):
    seq, kw, golden = _mse_b1_train(tepg)
    got = tepg.simulate(seq, fisp_kernel="force")
    want = np.asarray(jepg.simulate(_mse_b1_train(jepg)[0],
                                    fisp_kernel="force"))
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(got - golden).max() < 1e-5


# -- the matcher --


def _train(e, necho=6, *, att=None, order="ES", track=None, b1_track=False,
           dw=False, ramp=True, mutate=None):
    """A CPMG train in package `e`; `mutate` makes it off-pattern."""
    T1, T2 = np.array([800.0, 1200.0, 1600.0]), np.array([60.0, 90.0, 140.0])
    tau1, tau2 = 4.0, 4.5
    kw = dict(k=1) if ramp else {}
    dop1, dop2 = e.D(tau1, 1.2e-3, **kw), e.D(tau2, 1.2e-3, **kw)
    okw = {} if track is None else {"order1": list(track)}
    seq = [e.T(90, 90)]
    for i in range(necho):
        fa = 100.0 + 4.0 * (i % 5)
        alpha = fa if att is None else fa * np.asarray(att)[None, :]
        tkw = {"order1": {"B1": {"alpha": fa}}} if b1_track else {}
        g = 0.01 if mutate == "g_nonzero" else 0.0
        e1 = e.E(tau1, T1, T2, g, **okw)
        e2 = e.E(tau2, T1, T2, g, **okw)
        h1 = [e1, e.S(1)] if order == "ES" else [e.S(1), e1]
        h2 = [e2, e.S(1)] if order == "ES" else [e.S(1), e2]
        if dw or mutate in ("d_per_echo", "d_before_s", "two_d_in_half",
                            "tracked_d", "nonunit_ramp"):
            d1 = dop1
            if mutate == "d_per_echo":
                d1 = e.D(tau1, 1.2e-3, **kw)
            elif mutate == "tracked_d":
                d1 = e.D(tau1, 1.2e-3, k=1, order1=["Dcoef"])
            elif mutate == "nonunit_ramp" and i == 2:
                d1 = e.D(tau1, 1.2e-3, k=2)
            h1 = [h1[0], d1, h1[1]] if (mutate == "d_before_s"
                                        and i == 1) else h1 + [d1]
            h2 = h2 + [dop2]
            if mutate == "two_d_in_half" and i == 3:
                h2 = h2 + [e.D(1.0, 1e-3, k=1)]
        if mutate == "shift2" and i == 2:
            h1 = [h1[0], e.S(2)] + h1[2:]
        seq += h1 + [e.T(alpha, 0.0, **tkw)] + h2 + [e.ADC]
    return seq


TRAINS = {
    "plain": dict(),
    "se_order": dict(order="SE"),
    "b1_batch": dict(att=np.linspace(0.6, 1.1, 4)),
    "tracked": dict(track=("T1", "T2")),
    "b1_tracked": dict(track=("T2",), b1_track=True,
                       att=np.array([0.7, 0.9])),
    "dw": dict(dw=True),
    "dw_const_k": dict(dw=True, ramp=False, track=("T1", "T2")),
}
KEYS = ("exc", "FA", "phi", "tau1", "tau2", "T1", "T2", "B1", "shape", "vars",
        "b1_scale", "diffusion")


def _same_params(j, t):
    assert set(KEYS) <= set(t)
    for k in KEYS:
        a, b = j[k], t[k]
        if k == "diffusion" and a is not None:
            assert set(a) == set(b)
            for kk in a:
                assert np.allclose(np.asarray(a[kk], float),
                                   np.asarray(b[kk], float), rtol=1e-15), kk
        elif a is None or b is None or isinstance(a, (bool, float, tuple)):
            assert a == b or (np.ndim(a) == 0 and np.ndim(b) == 0
                              and float(a) == float(b)), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


@pytest.mark.parametrize("name", TRAINS)
def test_match_mse_equals_jax(name):
    j = jfd.match_mse(_train(jepg, **TRAINS[name]), KV)
    t = tfd.match_mse(_train(tepg, **TRAINS[name]), KV)
    assert j is not None and t is not None
    _same_params(j, t)


OFF_PATTERN = ["d_per_echo", "d_before_s", "nonunit_ramp", "two_d_in_half",
               "tracked_d", "g_nonzero", "shift2"]


@pytest.mark.parametrize("mutate", OFF_PATTERN)
def test_off_pattern_trains_fall_through(port_f64, mutate, caplog):
    assert jfd.match_mse(_train(jepg, mutate=mutate), KV) is None
    seq = _train(tepg, mutate=mutate)
    tfd.clear_cache()
    before = tfd.DISPATCH_COUNTS.get("mse", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        got = tepg.simulate(seq, kvalue=KV, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("mse", 0) == before
    assert any("not a CPMG train" in r.getMessage() for r in caplog.records)
    want = np.asarray(jepg.simulate(_train(jepg, mutate=mutate), kvalue=KV,
                                    fisp_kernel=False))
    assert np.abs(got - want).max() < 1e-10


def test_shared_memory_gate_falls_through(port_f32, caplog):
    """A DW-TSE train too deep for the primal's 12 planes at the smallest
    block (76 echoes: nstate 152 > 150) takes the general path, with the
    reason logged."""
    seq = _train(tepg, necho=76, dw=True)
    before = tfd.DISPATCH_COUNTS.get("mse", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        out = tepg.simulate(seq, kvalue=KV, fisp_kernel="force",
                            asarray=False)
    assert tfd.DISPATCH_COUNTS.get("mse", 0) == before
    assert any("CPMG kernel not used: gate" in r.getMessage()
               for r in caplog.records)
    assert tuple(out.shape) == (76, 3)


# -- Jacobian probes --


JAC_TRAINS = {
    "t1_t2": (dict(track=("T1", "T2")), ["magnitude", "T1", "T2"]),
    "b1_tracked": (dict(track=("T1", "T2"), b1_track=True,
                        att=np.array([0.7, 0.9])),
                   ["magnitude", "T1", "T2", "B1"]),
    "dw": (dict(track=("T1", "T2"), dw=True), ["T2", "magnitude", "T1"]),
}


@pytest.mark.parametrize("name", JAC_TRAINS)
def test_jacobian_probes_match_general_diff_path(port_f64, name):
    kw, names = JAC_TRAINS[name]
    seq = _train(tepg, **kw)
    probes = [tepg.ADC, tepg.Jacobian(names)]
    before = tfd.DISPATCH_COUNTS.get("jac:mse", 0)
    sig_k, jac_k = tepg.simulate(seq, kvalue=KV, probe=probes,
                                 fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("jac:mse", 0) == before + 1
    sig_g, jac_g = tepg.simulate(seq, kvalue=KV, probe=probes,
                                 fisp_kernel=False)
    assert tfd.DISPATCH_COUNTS.get("jac:mse", 0) == before + 1
    assert jac_k.shape == jac_g.shape == sig_k.shape + (len(names),)
    assert np.abs(sig_k - sig_g).max() < 1e-8
    for c in range(len(names)):
        scale = max(np.abs(jac_g[..., c]).max(), 1.0)
        assert np.abs(jac_k[..., c] - jac_g[..., c]).max() < 1e-8 * scale


def test_jacobian_of_untracked_variable_falls_through(port_f64, caplog):
    seq = _train(tepg, track=("T2",))
    before = tfd.DISPATCH_COUNTS.get("jac:mse", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        with pytest.raises(ValueError):
            tepg.simulate(seq, probe=[tepg.Jacobian(["T1"])],
                          fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("jac:mse", 0) == before
    assert any("CPMG Jacobian kernel not used" in r.getMessage()
               for r in caplog.records)


# -- parameters carried across from the JAX matcher --


@pytest.mark.parametrize("name", ["b1_batch", "dw", "b1_tracked"])
def test_jax_params_through_port_runners(port_f32, name):
    jp = jfd.match_mse(_train(jepg, **TRAINS[name]), KV)
    tp = from_numpy_params(jp, "cpu")
    got = tfd.run_mse_kernel(tp, 12).numpy()
    want = jfd.run_mse_kernel(jp, 12, interpret=True)
    want = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 2e-6
    specs = (("sig",), ("jac", ("magnitude",) + tuple(jp["vars"])))
    tj = tfd.run_mse_jacobian(tp, 12, specs)
    jj = jfd.run_mse_jacobian(jp, 12, specs, interpret=True)
    for a, b in zip(tj, jj):
        b = np.asarray(b["__c_re"]) + 1j * np.asarray(b["__c_im"])
        a = a.numpy()
        assert a.shape == b.shape
        scale = np.abs(b).max(axis=tuple(range(b.ndim - 1))) \
            if a.ndim == 3 else np.abs(b).max()
        assert (np.abs(a - b).max(axis=tuple(range(a.ndim - 1)))
                <= 1e-5 * np.maximum(scale, 1.0)).all()
