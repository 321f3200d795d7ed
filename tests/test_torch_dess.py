"""The DESS family of epgpy_torch vs epgpy_tpu: kernels' plain twins,
dispatch, Jacobian probes and the golden.

* ``dess_dictionary_plain`` / ``dess_jacobian_plain`` (float32) vs the JAX
  Pallas kernels in interpret mode, 8 atoms x 40 TRs at nstate 8 and 15,
  with and without df and demodulation, with a per-TR TE and a B1 batch:
  both echoes to 1e-5 absolute, both echoes' tangent columns to 1e-5 of
  the column's scale (float32 both, a different operation order);
* the float64 paths -- ``simulate(fisp_kernel="force")`` (the twin) and
  ``simulate(fisp_kernel=False)`` (the eager loop) -- vs the golden
  ``dess.npz`` to 1e-10;
* ``match_dess`` returns the JAX matcher's dict, key by key, engages
  ``DISPATCH_COUNTS["dess"]`` / ``["jac:dess"]`` and falls through with a
  logged reason on off-pattern trains and past the Jacobian's
  shared-memory gate;
* Jacobian probes through the DESS Jacobian twin == the port's general
  diff path to 1e-8 in float64, (T1, T2) and B1-tracked, both echoes;
* a JAX match dict carried through ``convert`` runs the port's runners to
  the JAX runners' values;
* the segmented Jacobian kernel's lane map (``epg::seg_shift_blocked``
  replayed in numpy at ``dess_jac_geometry``'s rows per lane) leaves the
  float64 twin exactly as it was, and its launch geometry for every ladder
  the gate admits;
* the same for the primal kernel (``dess_geometry``: one lane of up to 12
  rows, then the fewest lanes), its card edges covering every change of
  rows per lane, its unchanged gate, and the primal twin against the JAX
  kernel on a 33-TR train, past the kernel's 32-TR chunk.
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
from epgpy_torch.models import cuda_dess
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu.models import pallas_dess

from chip_smoke import (DESS_CASES, DESS_PRIMAL_EDGE_CASES,
                        DESS_RAGGED_CASE, DESS_ROW_EDGES, make_dess_case,
                        _tensors)
from epgpy_torch.models import cuda_fisp, planes
from torch_support import (GOLDEN_DIR, composite_claims, cplx,  # noqa: F401
                           port_f32, port_f64, seg_owned_atoms,
                           seg_shift_emulated, to_f64)

B, NTR = 8, 40


def _inputs(case, seed=0):
    return make_dess_case(case, B, NTR, seed=seed)


@pytest.mark.parametrize("case", DESS_CASES, ids=lambda c: c["name"])
def test_dess_twin_matches_jax_kernel(case):
    args, kw = _inputs(case)
    (r1, i1), (r2, i2) = pallas_dess.dess_dictionary_pallas(
        *args, interpret=True, btile=128, **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    (t1, t2) = cuda_dess.dess_dictionary_plain(*targs, **tkw)
    assert t1[0].shape == (B, NTR) and t1[0].dtype == torch.float32
    assert np.abs(cplx(*t1) - cplx(r1, i1)).max() < 1e-5
    assert np.abs(cplx(*t2) - cplx(r2, i2)).max() < 1e-5


@pytest.mark.parametrize("case", DESS_CASES[1::2], ids=lambda c: c["name"])
def test_dess_jacobian_twin_matches_jax_kernel(case):
    args, kw = _inputs(case, seed=1)
    (e1, e2), (j1, j2) = pallas_dess.dess_jacobian_pallas(
        *args, interpret=True, btile=128, **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    (s1, s2), (k1, k2) = cuda_dess.dess_jacobian_plain(*targs, **tkw)
    for got, want in ((s1, e1), (s2, e2)):
        assert np.abs(cplx(*got) - cplx(*want)).max() < 1e-5
    for got, want in ((k1, j1), (k2, j2)):
        got, want = cplx(*got), cplx(*want)
        assert got.shape == want.shape == (B, NTR, 3)
        for c in range(3):
            scale = np.abs(want[..., c]).max()
            assert np.abs(got[..., c] - want[..., c]).max() < 1e-5 * scale


def test_echo_layout_and_launch_counters():
    """The echo-layout wrappers take the twins for CPU tensors and count no
    kernel launch; their rows are the train's ADC order (FISP_0, PSIF_0,
    ...), which the per-echo views split; the Jacobian's signal is the
    primal's; nstate 0 has no PSIF row and raises."""
    args, kw = _tensors(torch, *_inputs(DESS_CASES[-1]), "cpu")
    before = (cuda_dess.LAUNCHES, cuda_dess.JAC_LAUNCHES)
    re, im = cuda_dess.dess_echoes(*args, **kw)
    (f, p) = cuda_dess.dess_dictionary_cuda(*args, **kw)
    (jre, _), (jd, _) = cuda_dess.dess_jacobian_echoes(*args, **kw)
    assert re.shape == (2 * NTR, B)
    assert torch.equal(re[0::2], f[0].T) and torch.equal(im[1::2], p[1].T)
    assert torch.allclose(re, jre, atol=1e-7) and jd.shape == (2 * NTR, B, 3)
    assert (cuda_dess.LAUNCHES, cuda_dess.JAC_LAUNCHES) == before
    with pytest.raises(ValueError):
        cuda_dess.dess_echoes(*args, nstate=0)


# -- float64 paths vs the golden --


def test_float64_paths_match_golden(port_f64):
    golden = np.load(os.path.join(GOLDEN_DIR, "dess.npz"))["signal"]
    seq = tepg.dess_sequence(30, alpha=25.0, TR=20.0, TE=5.0, T1=1000.0,
                             T2=80.0)
    before = tfd.DISPATCH_COUNTS.get("dess", 0)
    forced = tepg.simulate(seq, fisp_kernel="force", max_nstate=15)
    assert tfd.DISPATCH_COUNTS.get("dess", 0) == before + 1
    loop = tepg.simulate(seq, fisp_kernel=False, max_nstate=15)
    assert tfd.DISPATCH_COUNTS.get("dess", 0) == before + 1
    assert forced.dtype == loop.dtype == np.complex128
    assert forced.shape == loop.shape == golden.shape == (60, 1)
    assert np.abs(forced - golden).max() < 1e-10
    assert np.abs(loop - golden).max() < 1e-10


# -- the matcher --


def _train(e, P=8, nb=3, *, df=0.0, b1=None, phases=None, demod=False,
           track=None, b1_track=False, var_te=True, mutate=None):
    """A DESS train in package `e` (tests/test_dess_dispatch.py:17's
    shape); `mutate` makes it off-pattern."""
    rng = np.random.default_rng(5)
    T1 = np.linspace(600, 1500, nb)
    T2 = np.linspace(50, 120, nb)
    okw = {} if track is None else {"order1": list(track)}
    seq = []
    for i in range(P):
        te1 = 4.0 + (i % 3) * 0.5 if var_te else 4.0
        mid = 8.0 + rng.uniform(0, 2)
        ph = 0.0 if phases is None else float(phases[i])
        fa = 20.0 + i
        alpha = fa if b1 is None else fa * b1
        tkw = {"order1": {"B1": {"alpha": fa}}} if b1_track else {}
        seq += [e.T(alpha, ph, **tkw), e.E(te1, T1, T2, df, **okw),
                e.Adc(phase=-ph) if demod else e.ADC,
                e.E(mid, T1, T2, df, **okw), e.S(1),
                e.E(5.0, T1, T2, df, **okw),
                e.Adc(phase=-ph) if demod else e.ADC]
    if mutate == "shift2":
        seq[4] = e.S(2)
    elif mutate == "adc_attr":
        seq[13] = e.Adc(attr="Z0")
    elif mutate == "g_mismatch":
        seq[3] = e.E(seq[3].tau, seq[3].T1, seq[3].T2, 0.03)
    elif mutate == "short":
        seq = seq[:7]
    return seq


PHASES = (117.0 * np.arange(8) * (np.arange(8) + 1) / 2) % 360
TRAINS = {
    "plain": dict(var_te=False),
    "loaded": dict(df=np.linspace(-0.02, 0.02, 3),
                   b1=np.linspace(0.85, 1.15, 3), phases=PHASES, demod=True),
    "tracked": dict(track=("T1", "T2")),
    "b1_tracked": dict(track=("T2",), b1_track=True,
                       b1=np.array([0.9, 1.0, 1.1])),
}
KEYS = ("FA", "phi", "TR", "TE", "T1", "T2", "B1", "TI", "vars", "b1_scale",
        "demod", "shape", "df")


@pytest.mark.parametrize("name", TRAINS)
def test_match_dess_equals_jax(name):
    j = jfd.match_dess(_train(jepg, **TRAINS[name]))
    t = tfd.match_dess(_train(tepg, **TRAINS[name]))
    assert j is not None and t is not None
    assert set(t) == set(KEYS) and set(j) == set(KEYS)
    for k in KEYS:
        a, b = j[k], t[k]
        if a is None or b is None or isinstance(a, (bool, float, tuple)):
            assert a == b or (np.ndim(a) == 0 and np.ndim(b) == 0
                              and float(a) == float(b)), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


OFF_PATTERN = ["shift2", "adc_attr", "g_mismatch", "short"]


@pytest.mark.parametrize("mutate", OFF_PATTERN)
def test_off_pattern_trains_fall_through(port_f64, mutate, caplog):
    assert jfd.match_dess(_train(jepg, mutate=mutate)) is None
    seq = _train(tepg, mutate=mutate)
    tfd.clear_cache()
    before = dict(tfd.DISPATCH_COUNTS)
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        got = tepg.simulate(seq, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS == composite_claims(tfd, jfd, seq, _train(
        jepg, mutate=mutate), before)
    assert any("not a DESS train" in r.getMessage() for r in caplog.records)
    want = np.asarray(jepg.simulate(_train(jepg, mutate=mutate),
                                    fisp_kernel=False))
    assert np.abs(got - want).max() < 1e-10


def test_jacobian_gate_falls_through(port_f64, caplog):
    """A tracked DESS train deeper than the Jacobian kernel's 24 planes fit
    at its smallest block (80 TRs: nstate 80 > 74) takes the general diff
    path, with the reason logged."""
    seq = _train(tepg, P=80, nb=1, track=("T1", "T2"))
    before = tfd.DISPATCH_COUNTS.get("jac:dess", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        sig, jac = tepg.simulate(seq, fisp_kernel="force", asarray=False,
                                 probe=[tepg.ADC, tepg.Jacobian(["T2"])])
    assert tfd.DISPATCH_COUNTS.get("jac:dess", 0) == before
    assert any("DESS Jacobian kernel not used: gate" in r.getMessage()
               for r in caplog.records)
    assert tuple(jac.shape) == (160, 1, 1)


# -- Jacobian probes --


JAC_TRAINS = {
    "t1_t2": (TRAINS["tracked"], ["magnitude", "T1", "T2"]),
    "b1_tracked_df_demod": (dict(track=("T1", "T2"), b1_track=True,
                                 b1=np.array([0.9, 1.0, 1.1]),
                                 df=np.linspace(-0.02, 0.02, 3),
                                 phases=PHASES, demod=True),
                            ["B1", "T1", "magnitude", "T2"]),
}


@pytest.mark.parametrize("name", JAC_TRAINS)
def test_jacobian_probes_match_general_diff_path(port_f64, name):
    kw, names = JAC_TRAINS[name]
    seq = _train(tepg, **kw)
    probes = [tepg.ADC, tepg.Jacobian(names)]
    before = tfd.DISPATCH_COUNTS.get("jac:dess", 0)
    sig_k, jac_k = tepg.simulate(seq, probe=probes, fisp_kernel="force",
                                 max_nstate=6)
    assert tfd.DISPATCH_COUNTS.get("jac:dess", 0) == before + 1
    sig_g, jac_g = tepg.simulate(seq, probe=probes, fisp_kernel=False,
                                 max_nstate=6)
    assert tfd.DISPATCH_COUNTS.get("jac:dess", 0) == before + 1
    assert jac_k.shape == jac_g.shape == sig_k.shape + (len(names),)
    assert np.abs(sig_k - sig_g).max() < 1e-8
    for c in range(len(names)):
        scale = max(np.abs(jac_g[..., c]).max(), 1.0)
        assert np.abs(jac_k[..., c] - jac_g[..., c]).max() < 1e-8 * scale


# -- parameters carried across from the JAX matcher --


@pytest.mark.parametrize("name", ["loaded", "b1_tracked"])
def test_jax_params_through_port_runners(port_f32, name):
    jp = jfd.match_dess(_train(jepg, **TRAINS[name]))
    tp = from_numpy_params(jp, "cpu")
    assert set(tp) - {"_dev"} == set(KEYS)
    got = tfd.run_dess_kernel(tp, 6).numpy()
    want = jfd.run_dess_kernel(jp, 6, interpret=True)
    want = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    if not jp["vars"]:
        return
    specs = (("sig",), ("jac", ("magnitude",) + tuple(jp["vars"])))
    tj = tfd.run_dess_jacobian(tp, 6, specs)
    jj = jfd.run_dess_jacobian(jp, 6, specs, interpret=True)
    for a, b in zip(tj, jj):
        b = np.asarray(b["__c_re"]) + 1j * np.asarray(b["__c_im"])
        a = a.numpy()
        assert a.shape == b.shape
        scale = np.abs(b).max(axis=tuple(range(b.ndim - 1))) \
            if a.ndim == 3 else np.abs(b).max()
        assert (np.abs(a - b).max(axis=tuple(range(a.ndim - 1)))
                <= 1e-5 * np.maximum(scale, 1.0)).all()


# -- the segmented layout of dess_jac.cu: its lane map and geometry --


@pytest.mark.parametrize("H", [2, 3, 9, 16, 64, 65, 75])
def test_dess_jac_lane_map_matches_twin(monkeypatch, H):
    """The float64 Jacobian twin with every folded shift replayed through
    the kernel's lane map at its rows per lane (epg::seg_shift_blocked,
    emulated in numpy with NaN in the idle lanes and padding rows) equals
    the twin exactly, both echoes of every group and pulse: a per-pulse TE, df,
    demodulation and a B1 batch, over more pulses than the ladder has
    rows (the PSIF echo is the row-0 lane's new A(0))."""
    case = dict(name="lane_map", nstate=H - 1, var_te=True, b1=True, df=True,
                demodulate=True)
    args, kw = _tensors(torch, *make_dess_case(case, 37, H + 6, seed=9),
                        "cpu")
    args = to_f64(args)
    want = cuda_dess.dess_jacobian_echoes_plain(*args, **kw)
    R = cuda_dess.dess_jac_geometry(H - 1)["R"]
    monkeypatch.setattr(planes, "shift_fold",
                        lambda x: seg_shift_emulated(x, R,
                                                   blocked=True))
    got = cuda_dess.dess_jacobian_echoes_plain(*args, **kw)
    assert got[0][0].dtype == torch.float64
    assert got[1][0].shape == (2 * (H + 6), 37, 3)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.isfinite(g).all() and torch.equal(g, w)


def test_dess_jac_geometry():
    """For every ladder the gate admits (nstate 1-74): 1 row per lane up
    to 3 rows, 2 up to 6, 3 above, a segment of W = ceil(H / R) <= 32
    lanes, as many ladders per warp as fit, 4 warps per
    block, 1-32 pulses per chunk, the table and both echoes of four groups
    staged within 48 KB, and a grid whose (block, warp, segment) slots
    store each of 1, 2, 3, 33 and 4,097 atoms exactly once."""
    fits = [n for n in range(1, 401) if cuda_fisp.jac_kernel_fits(n)]
    assert fits == list(range(1, 75))
    for n in fits:
        geo = cuda_dess.dess_jac_geometry(n)
        H, R, W, L = n + 1, geo["R"], geo["W"], geo["L"]
        assert R == (1 if H <= 3 else 2 if H <= 6 else 3)
        assert W == -(-H // R) <= 32 and W * R >= H
        assert L == 32 // W and geo["warps"] == 4
        assert geo["atoms"] == 4 * L and 1 <= geo["pulses"] <= 32
        assert geo["smem"] == 4 * geo["pulses"] * (
            cuda_fisp.SEG_TABLE + cuda_dess.DESS_JAC_OUTPUTS * geo["atoms"])
        assert geo["smem"] <= 48 * 1024
        for B_ in (1, 2, 3, 33, 4097):
            owned, grid = seg_owned_atoms(geo, B_)
            assert sorted(owned) == list(range(B_)), (n, B_)
    main = cuda_dess.dess_jac_geometry(8)
    assert (main["R"], main["W"], main["L"]) == (3, 3, 10)


# -- the primal kernel (dess.cu): geometry, lane map, edges, gate --


def test_primal_launch_geometry():
    """For every ladder the gate admits (nstate 1-301): the fewest lanes
    with at most 12 rows each, R = ceil(H / W) (one lane, the instance of
    the ladder's own length, up to nstate 11), at least 7 rows per lane
    across lanes (the kernel's least instance there); 4 warps per block;
    32 TRs per chunk; the block's shared memory the chunk's table alone
    (both echoes are stored directly); and a grid whose slots store each
    of 1, 2, 3, 33 and 4,097 atoms exactly once."""
    for n in range(1, 302):
        geo = cuda_dess.dess_geometry(n)
        H = n + 1
        R, W, L = geo["R"], geo["W"], geo["L"]
        W0 = -(-H // cuda_dess.DESS_MAX_ROWS)
        assert R == cuda_dess.dess_rows(n)
        assert W == W0 and R == -(-H // W) <= cuda_dess.DESS_MAX_ROWS
        assert geo["one"] == (W == 1) == (n <= 11)
        assert W * R >= H > (W - 1) * R and W <= 32 and L == 32 // W
        assert geo["warps"] == cuda_dess.DESS_WARPS == 4
        assert geo["atoms"] == geo["warps"] * L
        assert W == 1 or R >= cuda_dess.DESS_MAX_ROWS // 2 + 1
        assert geo["pulses"] == cuda_dess.DESS_TRS == 32
        assert geo["smem"] == 4 * 32 * cuda_dess.DESS_TABLE <= 48 * 1024
        if n in (1, 8, 12, 301):
            for B_ in (1, 2, 3, 33, 4097):
                owned, grid = seg_owned_atoms(geo, B_)
                assert sorted(owned) == list(range(B_)), (n, B_)
    assert cuda_dess.dess_geometry(8)["R"] == 9      # the mapping train's
    assert cuda_dess.dess_geometry(12)["R"] == 7
    assert cuda_dess.dess_geometry(301)["W"] == 26
    assert -(-4 * 256 * 256 // cuda_dess.dess_geometry(8)["atoms"]) == 2048


@pytest.mark.parametrize("nstate", [1, 8, 11, 12, 15, 23, 24, 36, 60])
def test_primal_lane_map_matches_twin(monkeypatch, nstate):
    """The float64 primal twin with every folded shift replayed through
    the kernel's lane map at its rows per lane (blocked rows, one lane up
    to nstate 11: epg::lane_shift; more: epg::seg_shift_blocked, emulated
    in numpy with NaN in the idle lanes, past the last atom and in the
    padding rows) equals the twin exactly, both echoes of every TR (the
    PSIF echo is the row-0 lane's post-shift A(0)), over 37 atoms and a
    train 11 TRs longer than the ladder with TR and TE runs, a per-TR TE,
    df, demodulation and a B1 batch."""
    case = dict(name="lane_map", nstate=nstate, var_te=True, b1=True,
                df=True, demodulate=True, runs=True)
    npulse = max(80, nstate + 12)
    args, kw = _tensors(torch, *make_dess_case(case, 37, npulse, seed=3),
                        "cpu")
    args = to_f64(args)
    want = cuda_dess.dess_echoes_plain(*args, **kw)
    R = cuda_dess.dess_geometry(nstate)["R"]
    calls = [0]

    def shift(s):
        calls[0] += 1
        return seg_shift_emulated(s, R, blocked=True)

    monkeypatch.setattr(planes, "shift_fold", shift)
    got = cuda_dess.dess_echoes_plain(*args, **kw)
    assert calls[0] == npulse
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == (2 * npulse, 37)
        assert torch.isfinite(g).all() and torch.equal(g, w)


def test_primal_row_edges_cover_every_change():
    """DESS_ROW_EDGES, the nstates of the card's primal edges, holds
    nstate 1-12 (each one-lane instance and the first two-lane one), both
    sides of every change of the rows per lane up to the gate, and the
    gate's deepest ladder, 301."""
    ch = [n for n in range(2, 302)
          if cuda_dess.dess_rows(n) != cuda_dess.dess_rows(n - 1)]
    assert ch and sorted({c - 1 for c in ch} | set(ch) | set(range(1, 13))
                         | {301}) == list(DESS_ROW_EDGES)
    assert {c["nstate"] for c in DESS_PRIMAL_EDGE_CASES} == set(
        DESS_ROW_EDGES)


def test_primal_gate_unchanged():
    """The primal gate (``cuda_fisp.kernel_fits``, which ``_launch`` asks)
    answers as the thread-per-atom layout set it for nstate 0-400: nstate
    <= 301; nstate 0 (no PSIF row) raises before any launch, on either
    route."""
    fits = [n for n in range(0, 401) if cuda_fisp.kernel_fits(n)]
    assert fits == list(range(0, 302))
    args, kw = _tensors(torch, *_inputs(DESS_CASES[0]), "cpu")
    for n in (0, -1):
        with pytest.raises(ValueError, match="nstate >= 1"):
            cuda_dess.dess_echoes_plain(*args, nstate=n)


@pytest.mark.parametrize("case", DESS_CASES + [DESS_RAGGED_CASE | dict(
    nstate=12)], ids=lambda c: c["name"])
def test_dess_twin_matches_jax_kernel_33_trs(case):
    """The primal twin vs the JAX kernel in interpret mode on a 33-TR train
    (the kernel's table holds 32 TRs a chunk), 8 atoms: both echoes to
    1e-5, as the option cases; the ragged case with TR and TE runs on two
    lanes."""
    args, kw = make_dess_case(case, B, 33, seed=2)
    (r1, i1), (r2, i2) = pallas_dess.dess_dictionary_pallas(
        *args, interpret=True, btile=128, **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    (t1, t2) = cuda_dess.dess_dictionary_plain(*targs, **tkw)
    assert t1[0].shape == (B, 33)
    assert np.abs(cplx(*t1) - cplx(r1, i1)).max() < 1e-5
    assert np.abs(cplx(*t2) - cplx(r2, i2)).max() < 1e-5
