"""The ME-GRE family of epgpy_torch vs epgpy_tpu: kernels' plain twins,
dispatch, Jacobian probes, the golden and the family table.

* ``megre_dictionary_plain`` / ``megre_jacobian_plain`` (float32) vs the
  JAX Pallas kernels in interpret mode, 8 atoms x 24 TRs at nstate 8 and
  12, m = 2 and 3 echoes, with and without df and demodulation, with a
  per-pulse echo-time matrix and a B1 batch: signals to 1e-5 absolute,
  each of the 4 tangent columns (T1, T2, B1, df) to 1e-5 of the column's
  scale -- the df column at ``dfs=None`` included (float32 both, a
  different operation order);
* the float64 paths -- ``simulate(fisp_kernel="force")`` (the twin) and
  ``simulate(fisp_kernel=False)`` (the eager loop) -- vs the golden
  ``megre.npz`` to 1e-10;
* ``match_megre`` returns the JAX matcher's dict, key by key, engages
  ``DISPATCH_COUNTS["megre"]`` / ``["jac:megre"]`` and falls through with a
  logged reason on off-pattern trains and past the Jacobian's gate;
* Jacobian probes over (T1, T2, g) and a tracked B1 through the ME-GRE
  Jacobian twin == the port's general diff path to 1e-8 in float64;
* a JAX match dict carried through ``convert`` runs the port's runners to
  the JAX runners' values;
* each train of the ported families is claimed by exactly the matcher the
  JAX dispatcher's table gives it (``tests/test_dispatch_fuzz.py:170``).
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
from epgpy_torch.models import cuda_fisp, cuda_megre, planes
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu.models import pallas_megre

from chip_smoke import MEGRE_CASES, make_megre_case, _tensors
from torch_support import (GOLDEN_DIR, cplx, family_train,  # noqa: F401
                           port_f32, port_f64, seg_owned_atoms,
                           seg_shift_emulated)

B, NTR = 8, 24


@pytest.mark.parametrize("case", MEGRE_CASES[1:], ids=lambda c: c["name"])
def test_megre_twin_matches_jax_kernel(case):
    args, kw = make_megre_case(case, B, NTR)
    re, im = pallas_megre.megre_dictionary_pallas(*args, interpret=True,
                                                  btile=128, **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    got = cuda_megre.megre_dictionary_plain(*targs, **tkw)
    assert got[0].shape == (B, NTR, case["m"])
    assert got[0].dtype == torch.float32
    assert np.abs(cplx(*got) - cplx(re, im)).max() < 1e-5


@pytest.mark.parametrize("case", MEGRE_CASES[0::2] + MEGRE_CASES[3:4],
                         ids=lambda c: c["name"])
def test_megre_jacobian_twin_matches_jax_kernel(case):
    args, kw = make_megre_case(case, B, NTR, seed=1)
    (re, im), (jre, jim) = pallas_megre.megre_jacobian_pallas(
        *args, interpret=True, btile=128, **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    (sre, sim), (dre, dim) = cuda_megre.megre_jacobian_plain(*targs, **tkw)
    assert np.abs(cplx(sre, sim) - cplx(re, im)).max() < 1e-5
    got, want = cplx(dre, dim), cplx(jre, jim)
    assert got.shape == want.shape == (B, NTR, case["m"], 4)
    for c in range(4):
        scale = np.abs(want[..., c]).max()
        assert scale > 0
        assert np.abs(got[..., c] - want[..., c]).max() < 1e-5 * scale


def test_echo_layout_and_launch_counters():
    """The echo-layout wrappers take the twins for CPU tensors and count no
    kernel launch; their rows are the train's ADC order (row i m + j),
    which the per-echo views split; the Jacobian's signal is the primal's;
    nstate 0 runs as 1, as in the JAX wrappers; the gates are 6 and 30
    planes at 32 threads."""
    case = MEGRE_CASES[-1]
    args, kw = _tensors(torch, *make_megre_case(case, B, NTR), "cpu")
    before = (cuda_megre.LAUNCHES, cuda_megre.JAC_LAUNCHES)
    re, im = cuda_megre.megre_echoes(*args, **kw)
    d_re, d_im = cuda_megre.megre_dictionary_cuda(*args, **kw)
    (jre, _), (jd, _) = cuda_megre.megre_jacobian_echoes(*args, **kw)
    m = case["m"]
    assert re.shape == (m * NTR, B)
    assert torch.equal(re[1::m], d_re[:, :, 1].T)
    assert torch.equal(im[m - 1::m], d_im[:, :, m - 1].T)
    assert torch.allclose(re, jre, atol=1e-7) and jd.shape == (m * NTR, B, 4)
    assert (cuda_megre.LAUNCHES, cuda_megre.JAC_LAUNCHES) == before
    one = cuda_megre.megre_echoes(*args, **dict(kw, nstate=1))
    zero = cuda_megre.megre_echoes(*args, **dict(kw, nstate=0))
    assert torch.equal(one[0], zero[0])
    assert cuda_megre.megre_kernel_fits(301)
    assert not cuda_megre.megre_kernel_fits(302)
    assert cuda_megre.megre_jac_kernel_fits(59)
    assert not cuda_megre.megre_jac_kernel_fits(60)


# -- float64 paths vs the golden --


def _golden_train(e):
    """tests/test_megre_dispatch.py:220-232's train in package `e`."""
    seq = []
    for i in range(20):
        seq.append(e.T(15 + i, 0))
        prev = 0.0
        for te in (4.0, 9.0, 15.0):
            seq += [e.E(te - prev, 900, 70, 0.02), e.ADC]
            prev = te
        seq += [e.E(22.0 - prev, 900, 70, 0.02), e.S(1)]
    return seq


def test_float64_paths_match_golden(port_f64):
    golden = np.load(os.path.join(GOLDEN_DIR, "megre.npz"))["signal"]
    seq = _golden_train(tepg)
    before = tfd.DISPATCH_COUNTS.get("megre", 0)
    forced = tepg.simulate(seq, fisp_kernel="force", max_nstate=12)
    assert tfd.DISPATCH_COUNTS.get("megre", 0) == before + 1
    loop = tepg.simulate(seq, fisp_kernel=False, max_nstate=12)
    assert tfd.DISPATCH_COUNTS.get("megre", 0) == before + 1
    assert forced.dtype == loop.dtype == np.complex128
    assert forced.shape == loop.shape == golden.shape == (60, 1)
    assert np.abs(forced - golden).max() < 1e-10
    assert np.abs(loop - golden).max() < 1e-10


# -- the matcher --


def _train(e, P=6, nb=3, m=2, *, df=0.0, b1=None, demod=False,
           has_rest=True, vary_te=False, track=None, b1_track=False,
           mutate=None):
    """An ME-GRE train in package `e` (tests/test_megre_dispatch.py:17's
    shape); `mutate` makes it off-pattern."""
    T1 = np.linspace(500, 1600, nb)
    T2 = np.linspace(40, 130, nb)
    okw = {} if track is None else {"order1": list(track)}
    seq = []
    for i in range(P):
        ph = float((117.0 * i * (i + 1) / 2) % 360) if demod else 0.0
        fa = 15.0 + i
        tkw = {"order1": {"B1": {"alpha": fa}}} if b1_track else {}
        seq.append(e.T(fa if b1 is None else fa * b1, ph, **tkw))
        prev = 0.0
        for j in range(m):
            te = 3.0 * (j + 1) + (0.4 * i if vary_te else 0.0)
            seq += [e.E(te - prev, T1, T2, df, **okw),
                    e.Adc(phase=-ph) if demod else e.ADC]
            prev = te
        if has_rest:
            seq.append(e.E(4.0 + (i % 2), T1, T2, df, **okw))
        seq.append(e.S(1))
    L = len(seq) // P
    if mutate == "shift2":
        seq[L - 1] = e.S(2)
    elif mutate == "adc_attr":
        seq[4] = e.Adc(attr="Z0")
    elif mutate == "one_echo":
        seq = _train(e, P, nb, 1, df=df)
    elif mutate == "ragged":
        del seq[L + 3:L + 5]
    elif mutate == "g_mismatch":
        seq[3] = e.E(seq[3].tau, seq[3].T1, seq[3].T2, 0.03)
    return seq


TRAINS = {
    "plain": dict(),
    "loaded": dict(nb=4, m=3, df=np.linspace(-0.03, 0.03, 4),
                   b1=np.linspace(0.85, 1.15, 4), demod=True, vary_te=True),
    "no_rest": dict(m=4, has_rest=False),
    "tracked": dict(track=("T1", "T2", "g")),
    "b1_tracked": dict(track=("T2", "g"), b1_track=True,
                       b1=np.array([0.9, 1.0, 1.1])),
}
KEYS = ("FA", "phi", "TR", "TE", "T1", "T2", "B1", "TI", "vars", "b1_scale",
        "demod", "shape", "nechoes", "df")


def _equal_dicts(j, t, keys):
    assert set(t) == set(keys) and set(j) == set(keys)
    for k in keys:
        a, b = j[k], t[k]
        if a is None or b is None or isinstance(a, (bool, int, float,
                                                    tuple)):
            assert a == b or (np.ndim(a) == 0 and np.ndim(b) == 0
                              and float(a) == float(b)), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


@pytest.mark.parametrize("name", TRAINS)
def test_match_megre_equals_jax(name):
    j = jfd.match_megre(_train(jepg, **TRAINS[name]))
    t = tfd.match_megre(_train(tepg, **TRAINS[name]))
    assert j is not None and t is not None
    _equal_dicts(j, t, KEYS)
    assert t["TE"].shape == (t["nechoes"], len(t["FA"]))


OFF_PATTERN = ["shift2", "adc_attr", "one_echo", "ragged", "g_mismatch"]


@pytest.mark.parametrize("mutate", OFF_PATTERN)
def test_off_pattern_trains_fall_through(port_f64, mutate, caplog):
    assert jfd.match_megre(_train(jepg, mutate=mutate)) is None
    seq = _train(tepg, mutate=mutate)
    tfd.clear_cache()
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        assert tfd.match_megre(seq) is None
    assert any("not an ME-GRE train" in r.getMessage()
               for r in caplog.records)
    before = tfd.DISPATCH_COUNTS.get("megre", 0)
    got = tepg.simulate(seq, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("megre", 0) == before
    want = np.asarray(jepg.simulate(_train(jepg, mutate=mutate),
                                    fisp_kernel=False))
    # a one-echo train is FISP's, whose dispatch computes in float32
    tol = 1e-6 if tfd.match_fisp(seq) is not None else 1e-10
    assert np.abs(got - want).max() < tol


def test_jacobian_gate_falls_through(port_f64, caplog):
    """A tracked ME-GRE train deeper than the Jacobian kernel's 30 planes
    fit at its smallest block (60 TRs: nstate 60 > 59) takes the general
    diff path, with the reason logged."""
    seq = _train(tepg, P=60, nb=1, track=("T2", "g"))
    before = tfd.DISPATCH_COUNTS.get("jac:megre", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        sig, jac = tepg.simulate(seq, fisp_kernel="force", asarray=False,
                                 probe=[tepg.ADC, tepg.Jacobian(["g"])])
    assert tfd.DISPATCH_COUNTS.get("jac:megre", 0) == before
    assert any("ME-GRE Jacobian kernel not used: gate" in r.getMessage()
               for r in caplog.records)
    assert tuple(jac.shape) == (120, 1, 1)


@pytest.mark.parametrize("nstate,m,fits", [(1, 360, True), (1, 361, False),
                                            (8, 952, True), (8, 953, False)])
def test_jacobian_gate_counts_echoes(nstate, m, fits):
    """The Jacobian gate refuses what the kernel's own guard refuses: one
    pulse's staged echoes (``megre_jac_geometry``) past a block's shared
    memory, m = 361 at nstate 1 and m = 953 at nstate 8; the engine's
    ME-GRE gate answers the same."""
    geo = cuda_megre.megre_jac_geometry(nstate, m)
    assert (geo["smem"] <= cuda_fisp.SMEM_PER_BLOCK) == fits
    assert cuda_megre.megre_jac_kernel_fits(nstate, m) == fits
    assert cuda_megre.megre_jac_kernel_fits(nstate)
    assert tepg.engine._megre_jac_fits({"nechoes": m}, nstate) == fits


def test_jacobian_gate_falls_through_on_echo_count(port_f32, caplog):
    """A tracked ME-GRE train of 361 echoes per TR at nstate 1 passes the
    plane gate but not the staged echoes': simulate() takes the general
    diff path with the reason logged and returns its answer."""
    seq = _train(tepg, P=2, nb=1, m=361, track=("T2", "g"))
    assert tfd.match_megre(seq)["nechoes"] == 361
    probes = [tepg.ADC, tepg.Jacobian(["T2", "g"])]
    before = tfd.DISPATCH_COUNTS.get("jac:megre", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        sig, jac = tepg.simulate(seq, fisp_kernel="force", max_nstate=1,
                                 probe=probes)
    assert tfd.DISPATCH_COUNTS.get("jac:megre", 0) == before
    assert any("361 echoes per TR" in r.getMessage() for r in caplog.records)
    want_sig, want_jac = tepg.simulate(seq, fisp_kernel=False, max_nstate=1,
                                       probe=probes)
    assert sig.dtype == np.complex64 and jac.shape == (722, 1, 2)
    assert np.array_equal(sig, want_sig) and np.array_equal(jac, want_jac)
    assert np.abs(jac).max() > 0


def test_jacobian_echo_count_fall_through_matches_jax(port_f64, caplog):
    """The 361-echo train that the gate turns away gives the JAX engine's
    answer in float64: signal and both Jacobian columns, at the general
    path's parity tolerances."""
    kw = dict(P=2, nb=1, m=361, track=("T2", "g"))
    probes = [tepg.ADC, tepg.Jacobian(["T2", "g"])]
    before = tfd.DISPATCH_COUNTS.get("jac:megre", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        sig, jac = tepg.simulate(_train(tepg, **kw), fisp_kernel="force",
                                 max_nstate=1, probe=probes)
    assert tfd.DISPATCH_COUNTS.get("jac:megre", 0) == before
    assert any("361 echoes per TR" in r.getMessage() for r in caplog.records)
    want_sig, want_jac = (np.asarray(a) for a in jepg.simulate(
        _train(jepg, **kw), max_nstate=1,
        probe=[jepg.ADC, jepg.Jacobian(["T2", "g"])]))
    assert sig.shape == want_sig.shape and jac.shape == want_jac.shape
    assert np.abs(sig - want_sig).max() < 1e-10
    for c in range(2):
        scale = max(np.abs(want_jac[..., c]).max(), 1.0)
        assert np.abs(want_jac[..., c]).max() > 0
        assert np.abs(jac[..., c] - want_jac[..., c]).max() < 1e-8 * scale


# -- Jacobian probes --


JAC_TRAINS = {
    "t1_t2_g": (TRAINS["tracked"], ["magnitude", "T1", "T2", "g"]),
    "g_at_df0": (dict(track=("T2", "g")), ["g", "T2"]),
    "b1_tracked_df_demod": (dict(nb=4, m=3, track=("T1", "T2", "g"),
                                 b1_track=True,
                                 b1=np.linspace(0.85, 1.15, 4),
                                 df=np.linspace(-0.03, 0.03, 4),
                                 demod=True, vary_te=True),
                            ["B1", "g", "magnitude", "T1", "T2"]),
}


@pytest.mark.parametrize("name", JAC_TRAINS)
def test_jacobian_probes_match_general_diff_path(port_f64, name):
    kw, names = JAC_TRAINS[name]
    seq = _train(tepg, **kw)
    probes = [tepg.ADC, tepg.Jacobian(names)]
    before = tfd.DISPATCH_COUNTS.get("jac:megre", 0)
    sig_k, jac_k = tepg.simulate(seq, probe=probes, fisp_kernel="force",
                                 max_nstate=6)
    assert tfd.DISPATCH_COUNTS.get("jac:megre", 0) == before + 1
    sig_g, jac_g = tepg.simulate(seq, probe=probes, fisp_kernel=False,
                                 max_nstate=6)
    assert tfd.DISPATCH_COUNTS.get("jac:megre", 0) == before + 1
    assert jac_k.shape == jac_g.shape == sig_k.shape + (len(names),)
    assert np.abs(sig_k - sig_g).max() < 1e-8
    for c in range(len(names)):
        scale = max(np.abs(jac_g[..., c]).max(), 1.0)
        assert np.abs(jac_g[..., c]).max() > 0
        assert np.abs(jac_k[..., c] - jac_g[..., c]).max() < 1e-8 * scale


# -- parameters carried across from the JAX matcher --


@pytest.mark.parametrize("name", ["loaded", "b1_tracked"])
def test_jax_params_through_port_runners(port_f32, name):
    jp = jfd.match_megre(_train(jepg, **TRAINS[name]))
    tp = from_numpy_params(jp, "cpu")
    assert set(tp) - {"_dev"} == set(KEYS)
    got = tfd.run_megre_kernel(tp, 6).numpy()
    want = jfd.run_megre_kernel(jp, 6, interpret=True)
    want = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    if not jp["vars"]:
        return
    specs = (("sig",), ("jac", ("magnitude",) + tuple(jp["vars"])))
    tj = tfd.run_megre_jacobian(tp, 6, specs)
    jj = jfd.run_megre_jacobian(jp, 6, specs, interpret=True)
    for a, b in zip(tj, jj):
        b = np.asarray(b["__c_re"]) + 1j * np.asarray(b["__c_im"])
        a = a.numpy()
        assert a.shape == b.shape
        scale = np.abs(b).max(axis=tuple(range(b.ndim - 1))) \
            if a.ndim == 3 else np.abs(b).max()
        assert (np.abs(a - b).max(axis=tuple(range(a.ndim - 1)))
                <= 1e-5 * np.maximum(scale, 1.0)).all()


# -- the family table: every ported family claims its own trains only --


FAMILIES = {"fisp": "fisp", "mse": "mse", "bssfp": "bssfp", "dess": "dess",
            "megre": "megre", "megre_m1": "fisp", "dw": "dw"}


def _matchers(fd):
    return {"fisp": fd.match_fisp, "mse": lambda s: fd.match_mse(s, 1.0),
            "bssfp": fd.match_bssfp, "dess": fd.match_dess,
            "megre": fd.match_megre,
            "dw": lambda s: fd.match_dwfisp(s, 1.0)}


@pytest.mark.parametrize("fam", FAMILIES)
def test_families_are_disjoint(fam):
    claims = {pkg: {tag for tag, m in _matchers(fd).items()
                    if m(family_train(e, fam)) is not None}
              for pkg, (e, fd) in {"jax": (jepg, jfd),
                                   "torch": (tepg, tfd)}.items()}
    assert claims["torch"] == claims["jax"] == {FAMILIES[fam]}


# -- the segmented layout of megre_jac.cu: its lane map, geometry and gate --


@pytest.mark.parametrize("H", [2, 9, 32, 33, 60])
def test_segmented_lane_map_matches_twin(port_f64, monkeypatch, H):
    """The float64 Jacobian twin with every folded shift replayed through
    the segmented layout's lane map (epg::seg_shift, emulated in numpy with
    NaN in the idle lanes and padding rows) equals the twin exactly: three
    echoes with a per-pulse echo-time matrix, df, a B1 batch and
    demodulation, the train longer than the ladder (H = 60: the gate's)."""
    case = dict(name="lane_map", m=3, nstate=H - 1, var_te=True, b1=True,
                df=True, demodulate=True)
    args, kw = make_megre_case(case, 29, H + 5, seed=3)
    t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    targs = tuple(t(a) for a in args)
    want = cuda_megre.megre_jacobian_echoes_plain(*targs, **kw)
    monkeypatch.setattr(planes, "shift_fold", seg_shift_emulated)
    got = cuda_megre.megre_jacobian_echoes_plain(*targs, **kw)
    assert got[0][0].dtype == torch.float64
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.isfinite(g).all() and torch.equal(g, w)


@pytest.mark.parametrize("m", [1, 2, 3, 12, 40])
def test_segmented_launch_geometry(m):
    """For every ladder the gate admits and m echoes per TR: 1 or 2 rows
    per lane, a segment of W = ceil(H / R) lanes holding the H rows, as
    many ladders per warp as fit its 32 lanes, 1-4 warps per block (fewer
    only where one pulse's staged echoes would pass 48 KB), the table
    (with the m echo times) and a chunk's staged echoes within
    SMEM_PER_BLOCK, and a grid whose slots store each of 1, 2, 3, 33 and
    4,097 atoms exactly once."""
    for n in range(0, 60):
        geo = cuda_megre.megre_jac_geometry(n, m)
        H = max(n, 1) + 1
        R, W, L, warps = geo["R"], geo["W"], geo["L"], geo["warps"]
        assert R == (1 if H <= 3 else 2)
        assert W == -(-H // R) <= 32 and W * R >= H
        assert 1 <= L and L * W <= 32 < (L + 1) * W
        assert 1 <= warps <= cuda_fisp.SEG_WARPS
        assert geo["atoms"] == warps * L
        assert 1 <= geo["pulses"] <= cuda_fisp.SEG_PULSES
        table = cuda_fisp.SEG_TABLE + m          # with the echo times
        per = table + 10 * m * geo["atoms"]
        assert geo["smem"] == 4 * geo["pulses"] * per
        assert geo["smem"] <= cuda_fisp.SMEM_PER_BLOCK
        assert (warps == cuda_fisp.SEG_WARPS
                or table + 20 * m * geo["atoms"] > cuda_fisp.SEG_CHUNK_FLOATS)
        for B in (1, 2, 3, 33, 4097):
            owned, grid = seg_owned_atoms(geo, B)
            assert sorted(owned) == list(range(B)), (n, m, B)
            assert (grid - 1) * geo["atoms"] < B <= grid * geo["atoms"]


def test_jacobian_gate_unchanged():
    """The Jacobian gate answers as the thread-per-atom layout set it, for
    nstate 0-400 (0 runs as 1): nstate <= 59; the segmented kernel keeps
    it, so no train changes route."""
    fits = [n for n in range(0, 401) if cuda_megre.megre_jac_kernel_fits(n)]
    assert fits == list(range(0, 60))
    assert fits == [n for n in range(0, 401)
                    if cuda_fisp.jac_kernel_fits(max(n, 1), True)]
