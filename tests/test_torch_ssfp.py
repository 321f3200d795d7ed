"""The balanced-SSFP family of epgpy_torch vs epgpy_tpu, and the
steady-state sequences (models/ssfp.py) through both packages.

* ``bssfp_dictionary_plain`` / ``bssfp_jacobian_plain`` (float32) vs the
  JAX Pallas kernels in interpret mode, 8 atoms x 48 pulses, over the
  options (inversion with and without df, df with demodulation, per-pulse
  TE, a B1 batch; the Jacobian with and without the ddf group): signals to
  1e-5 absolute, tangent columns to 1e-5 of the column's scale (float32
  both, a different operation order);
* the float64 paths -- ``simulate(fisp_kernel="force")`` (the twin) and
  ``simulate(fisp_kernel=False)`` (the eager loop at nstate 0) -- vs the
  golden ``bssfp.npz`` to 1e-10;
* ``match_bssfp`` returns the JAX matcher's dict, key by key, engages
  ``DISPATCH_COUNTS["bssfp"]`` / ``["jac:bssfp"]``, stays disjoint from the
  FISP and DESS families and falls through with a logged reason on
  off-pattern trains;
* Jacobian probes through the bSSFP Jacobian twin == the port's general
  diff path to 1e-8 in float64, (T1, T2), g-tracked and B1-tracked;
* a JAX match dict carried through ``convert`` runs the port's runners to
  the JAX runners' values.
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
from epgpy_torch.models import cuda_bssfp, planes
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu.models import pallas_bssfp
from epgpy_tpu.models import ssfp as jssfp

from chip_smoke import (BSSFP_CASES, BSSFP_EDGE_CASES, bssfp_atoms,
                        bssfp_bench_sequence, make_bssfp_case, _tensors)
from torch_support import (GOLDEN_DIR, composite_claims, cplx,  # noqa: F401
                           port_f32, port_f64)

B, NPULSE = 8, 48


def _inputs(case, seed=0):
    return make_bssfp_case(case, B, NPULSE, seed=seed)


@pytest.mark.parametrize("case", BSSFP_CASES, ids=lambda c: c["name"])
def test_bssfp_twin_matches_jax_kernel(case):
    args, kw = _inputs(case)
    jre, jim = pallas_bssfp.bssfp_dictionary_pallas(*args, interpret=True,
                                                    **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    tre, tim = cuda_bssfp.bssfp_dictionary_plain(*targs, **tkw)
    assert tre.shape == (B, NPULSE) and tre.dtype == torch.float32
    assert np.abs(cplx(tre, tim) - cplx(jre, jim)).max() < 1e-5


@pytest.mark.parametrize("case", BSSFP_CASES, ids=lambda c: c["name"])
def test_bssfp_jacobian_twin_matches_jax_kernel(case):
    """The ddf group alternates over the cases (on with df, inversion or
    both, off otherwise), so both layouts meet the JAX kernel."""
    args, kw = _inputs(case, seed=1)
    kw.pop("normalize")
    track_df = bool(case.get("df") or case.get("inversion"))
    (jre, jim), (jdre, jdim) = pallas_bssfp.bssfp_jacobian_pallas(
        *args, interpret=True, track_df=track_df, **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    (tre, tim), (tdre, tdim) = cuda_bssfp.bssfp_jacobian_plain(
        *targs, track_df=track_df, **tkw)
    G = 4 if track_df else 3
    assert tdre.shape == (B, NPULSE, G)
    assert np.abs(cplx(tre, tim) - cplx(jre, jim)).max() < 1e-5
    want, got = cplx(jdre, jdim), cplx(tdre, tdim)
    for c in range(G):
        scale = np.abs(want[..., c]).max()
        assert np.abs(got[..., c] - want[..., c]).max() < 1e-5 * scale, c


def test_echo_layout_and_launch_counters():
    """The echo-layout wrappers take the twins for CPU tensors and count no
    kernel launch; the dictionary is the transposed echo train.  The
    Jacobian's signal is the primal's recurrence: in float64, where the
    primal twin's half-turn angles and exp2 decays and the Jacobian twin's
    radians and exp agree to rounding, within 1e-12 of it; in float32
    within 2e-6."""
    args, kw = _tensors(torch, *_inputs(BSSFP_CASES[-1]), "cpu")
    kw.pop("normalize")
    before = (cuda_bssfp.LAUNCHES, cuda_bssfp.JAC_LAUNCHES)
    re, im = cuda_bssfp.bssfp_echoes(*args, **kw)
    dre, dim = cuda_bssfp.bssfp_dictionary_cuda(*args, **kw)
    (jre, jim), (jd, _) = cuda_bssfp.bssfp_jacobian_echoes(
        *args, track_df=True, **kw)
    nre, nim = cuda_bssfp.bssfp_dictionary_cuda(*args, normalize=True, **kw)
    args64 = tuple(a.double() if isinstance(a, torch.Tensor) else a
                   for a in args)
    re64, im64 = cuda_bssfp.bssfp_echoes(*args64, **kw)
    (jre64, jim64), _ = cuda_bssfp.bssfp_jacobian_echoes(
        *args64, track_df=True, **kw)
    assert re64.dtype == jre64.dtype == torch.float64
    assert torch.equal(re, dre.T) and torch.equal(im, dim.T)
    assert float((re64 - jre64).abs().max()) < 1e-12
    assert float((im64 - jim64).abs().max()) < 1e-12
    assert torch.allclose(re, jre, rtol=0.0, atol=2e-6)
    assert torch.allclose(im, jim, rtol=0.0, atol=2e-6)
    assert jd.shape == (NPULSE, B, 4)
    assert torch.allclose((nre ** 2 + nim ** 2).sum(-1), torch.ones(B))
    assert (cuda_bssfp.LAUNCHES, cuda_bssfp.JAC_LAUNCHES) == before
    with pytest.raises(TypeError):
        cuda_bssfp.bssfp_echoes(*args[:4], np.ones(B), *args[5:], **kw)


_EDGES = [c for c in BSSFP_EDGE_CASES if not c.get("big_df")]
_BIG_DF = [c for c in BSSFP_EDGE_CASES if c.get("big_df")]


@pytest.mark.parametrize("case", _EDGES + BSSFP_CASES[-1:],
                         ids=lambda c: c["name"])
def test_bssfp_edge_twin_matches_jax_kernel(case):
    """The primal twin (the kernel's half-turn angles and exp2 decays of
    per-atom factors) vs the JAX kernel in interpret mode on the card's
    primal edge cases (TR and TE runs across the 32-pulse chunks,
    inversion with and without df) and the case with every option, 8
    atoms x 80 pulses: 1e-5 absolute."""
    args, kw = make_bssfp_case(case, B, 80)
    jre, jim = pallas_bssfp.bssfp_dictionary_pallas(*args, interpret=True,
                                                    **kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    tre, tim = cuda_bssfp.bssfp_dictionary_plain(*targs, **tkw)
    assert tre.shape == (B, 80) and tre.dtype == torch.float32
    assert np.abs(cplx(tre, tim) - cplx(jre, jim)).max() < 1e-5


@pytest.mark.parametrize("case", _BIG_DF, ids=lambda c: c["name"])
def test_bssfp_big_df_twin_matches_float64(case):
    """A large df t (df 0.5 kHz over TRs of 1,000 ms: 1,000 half turns a
    TR): the float32 twin, whose phasors take sincospi of 2 df t as the
    kernel's sincospif does, within 1e-4 of the float64 twin on the same
    float32 inputs (the float32 product 2 df TR near 1,000 carries an ulp
    of 6.1e-5 half turns)."""
    args, kw = make_bssfp_case(case, B, 60)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    got = cuda_bssfp.bssfp_dictionary_plain(*targs, **tkw)
    ref = cuda_bssfp.bssfp_dictionary_plain(
        *(a.double() if isinstance(a, torch.Tensor) else a for a in targs),
        **tkw)
    assert max(float((g.double() - r).abs().max())
               for g, r in zip(got, ref)) < 1e-4


def test_sincospi_exact_at_large_arguments():
    """planes.sincospi (the twins' sincospif) reduces half turns exactly:
    in float32 at 1,000-50,000 half turns it stays within 4e-7 of the
    float64 cosine and sine of the same float32 arguments, where cos(2 pi
    df t) of a float32 product is off by up to 1e-2."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(1e3, 5e4, 4096), dtype=torch.float32)
    c, s_ = planes.sincospi(x)
    x64 = x.double()
    r = x64 - 2.0 * torch.round(x64 / 2.0)
    assert float((c.double() - torch.cos(np.pi * r)).abs().max()) < 4e-7
    assert float((s_.double() - torch.sin(np.pi * r)).abs().max()) < 4e-7
    naive = torch.cos(np.pi * x)
    assert float((naive.double() - torch.cos(np.pi * r)).abs().max()) > 1e-3


@pytest.mark.parametrize("max_nstate", [0, 301, 302, 5000])
def test_bssfp_primal_always_admitted(port_f64, max_nstate):
    """bSSFP keeps no gate (three floats per atom in registers, whatever
    the ladder cap): a matched train is dispatched at any max_nstate, the
    FISP-family gate's edge 301 / 302 included."""
    seq, golden = _golden_train(tepg)
    before = tfd.DISPATCH_COUNTS.get("bssfp", 0)
    got = tepg.simulate(seq, fisp_kernel="force", max_nstate=max_nstate)
    assert tfd.DISPATCH_COUNTS.get("bssfp", 0) == before + 1
    assert np.abs(got - golden).max() < 1e-10


# -- float64 paths vs the golden --


def _golden():
    return np.load(os.path.join(GOLDEN_DIR, "bssfp.npz"))


def _golden_train(e):
    g = _golden()
    T1s, T2s, dfs, B1s = g["T1s"], g["T2s"], g["dfs"], g["B1s"]
    seq = [e.T(180 * B1s, 0), e.E(18.0, T1s, T2s, dfs)]
    for i in range(len(g["FAs"])):
        te = g["TRs"][i] / 2
        seq += [e.T(g["FAs"][i] * B1s, g["phases"][i]),
                e.E(te, T1s, T2s, dfs), e.Adc(phase=-g["phases"][i]),
                e.E(g["TRs"][i] - te, T1s, T2s, dfs)]
    return seq, g["signal"]


def test_float64_paths_match_golden(port_f64):
    seq, golden = _golden_train(tepg)
    before = tfd.DISPATCH_COUNTS.get("bssfp", 0)
    forced = tepg.simulate(seq, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("bssfp", 0) == before + 1
    loop = tepg.simulate(seq, fisp_kernel=False)
    assert tfd.DISPATCH_COUNTS.get("bssfp", 0) == before + 1
    assert tepg.getnshift(seq) == 0        # the general path at nstate 0
    assert forced.dtype == loop.dtype == np.complex128
    assert forced.shape == loop.shape == golden.shape
    assert np.abs(forced - golden).max() < 1e-10
    assert np.abs(loop - golden).max() < 1e-10


def test_simulate_force_float32_matches_jax_forced(port_f32):
    seq, golden = _golden_train(tepg)
    got = tepg.simulate(seq, fisp_kernel="force")
    want = np.asarray(jepg.simulate(_golden_train(jepg)[0],
                                    fisp_kernel="force"))
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(got - golden).max() < 2e-5


def test_float32_drift_flat_over_train_length(port_f32):
    """The f32 error of the benchmark's IR-prepped bSSFP train (8 atoms)
    against the float64 general path does not grow from 48 to 500 pulses,
    for the port's twin and for the JAX kernel in interpret mode alike:
    both stay below 2e-6 over every prefix, a tenth of BENCH_r05's 1.92e-5
    at 48 pulses, so that figure is not the recurrence's."""
    T1, T2, DF = bssfp_atoms(8)
    got = tepg.simulate(bssfp_bench_sequence(tepg, T1, T2, DF, npulse=500),
                        fisp_kernel="force")
    jax_f32 = np.asarray(jepg.simulate(
        bssfp_bench_sequence(jepg, T1, T2, DF, npulse=500),
        fisp_kernel="force"))
    tepg.config.set_precision("float64")
    ref = tepg.simulate(bssfp_bench_sequence(tepg, T1, T2, DF, npulse=500),
                        fisp_kernel=False)
    assert got.dtype == jax_f32.dtype == np.complex64
    for x in (got, jax_f32):
        err = np.abs(x - ref)
        drift = [float(err[:n].max()) for n in (48, 100, 200, 500)]
        print(drift)
        assert max(drift) < 2e-6


# -- the matcher --


def _train(e, P=12, nb=3, *, df=None, b1=None, inversion=None, te=None,
           phase_cycle=180.0, demodulate=True, order1=None, b1_track=False,
           mutate=None):
    """A bSSFP train in package `e` (tests/test_bssfp_dispatch.py:18's
    shape); `mutate` makes it off-pattern."""
    rng = np.random.default_rng(7)
    FA = 10 + 50 * np.abs(np.sin(np.arange(P) / 5.0)) + rng.uniform(0, 2, P)
    TR = rng.uniform(11, 14, P)
    T1 = np.linspace(300, 1500, nb)
    T2 = np.linspace(30, 120, nb)
    seq = (jssfp if e is jepg else e).bssfp_sequence(
        FA, TR, te, T1=T1, T2=T2, df=df, phase_cycle=phase_cycle,
        demodulate=demodulate, inversion=inversion, order1=order1)
    if b1 is not None or b1_track:
        # rank-1 outer(FA, B1) flips (the prep as 180 * B1), B1-tracked
        # with d(alpha)/dB1 = FA when asked
        att = np.ones(1) if b1 is None else b1
        out = []
        for op in seq:
            if type(op) is e.T:
                a = float(np.asarray(op.alpha))
                tkw = {"order1": {"B1": {"alpha": a}}} if b1_track else {}
                op = e.T(a * att, op.phi, **tkw)
            out.append(op)
        seq = out
    if mutate == "adc_phase":
        i = next(j for j, op in enumerate(seq) if type(op) is e.Adc)
        seq[i] = e.Adc(phase=33.0)
    elif mutate == "g_mismatch":
        i = next(j for j, op in enumerate(seq[3:], 3) if type(op) is e.E)
        seq[i] = e.E(seq[i].tau, seq[i].T1, seq[i].T2, 0.5)
    elif mutate == "prep_g":
        seq[1] = e.E(seq[1].tau, seq[1].T1, seq[1].T2, 0.99)
    elif mutate == "shifted":
        seq.insert(5, e.S(1))
        seq.insert(9, e.S(-1))
    elif mutate == "short":
        seq = seq[:6]
    return seq


TRAINS = {
    "plain": dict(),
    "offres_prep": dict(df=np.linspace(-0.04, 0.04, 3), inversion=18.0),
    "b1_batch": dict(b1=np.linspace(0.8, 1.2, 3), df=0.01, inversion=15.0),
    "no_demod_te": dict(demodulate=False, te=3.0, phase_cycle=117.0),
    "tracked_g": dict(df=np.linspace(-0.03, 0.03, 3), inversion=16.0,
                      order1=["T1", "T2", "g"]),
    "b1_tracked": dict(b1=np.array([0.8, 1.0, 1.1]), inversion=12.0,
                       order1=["T2"], b1_track=True),
}
KEYS = ("FA", "phi", "TR", "TE", "T1", "T2", "B1", "TI", "inv_df", "vars",
        "b1_scale", "d_var", "demod", "shape", "df", "diffusion")


def _same_params(j, t):
    for k in KEYS:
        a, b = j[k], t[k]
        if a is None or b is None or isinstance(a, (bool, float, tuple)):
            assert a == b or (np.ndim(a) == 0 and np.ndim(b) == 0
                              and float(a) == float(b)), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


@pytest.mark.parametrize("name", TRAINS)
def test_match_bssfp_equals_jax(name):
    j = jfd.match_bssfp(_train(jepg, **TRAINS[name]))
    t = tfd.match_bssfp(_train(tepg, **TRAINS[name]))
    assert j is not None and t is not None
    _same_params(j, t)


OFF_PATTERN = ["adc_phase", "g_mismatch", "prep_g", "shifted", "short"]


@pytest.mark.parametrize("mutate", OFF_PATTERN)
def test_off_pattern_trains_fall_through(port_f64, mutate, caplog):
    kw = dict(df=0.01, inversion=12.0, mutate=mutate)
    assert jfd.match_bssfp(_train(jepg, **kw)) is None
    seq = _train(tepg, **kw)
    tfd.clear_cache()
    before = dict(tfd.DISPATCH_COUNTS)
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        got = tepg.simulate(seq, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS == composite_claims(tfd, jfd, seq, _train(
        jepg, **kw), before)
    assert any("not a bSSFP train" in r.getMessage() for r in caplog.records)
    want = np.asarray(jepg.simulate(_train(jepg, **kw), fisp_kernel=False))
    assert np.abs(got - want).max() < 1e-10


def test_families_disjoint():
    """A balanced train is no FISP or DESS train and vice versa."""
    bseq = _train(tepg)
    assert tfd.match_fisp(bseq) is None and tfd.match_dess(bseq) is None
    assert tfd.match_bssfp(bseq) is not None
    T1, T2 = np.array([800.0]), np.array([80.0])
    fseq = []
    for _ in range(10):
        fseq += [tepg.T(30, 0), tepg.E(4.0, T1, T2), tepg.ADC,
                 tepg.E(8.0, T1, T2), tepg.S(1)]
    assert tfd.match_bssfp(fseq) is None and tfd.match_fisp(fseq) is not None
    dseq = tepg.dess_sequence(4)
    assert tfd.match_bssfp(dseq) is None and tfd.match_dess(dseq) is not None


def test_nd_batch_grid_restores_shape(port_f32):
    """Outer T1 x T2 grids flatten to the kernel's atom axis and come back
    in the append-broadcast shape."""
    FA = 10 + 40 * np.abs(np.sin(np.arange(16) / 4.0))
    T1, T2 = np.linspace(400, 1400, 3)[:, None], np.linspace(40, 110, 4)[None]
    seq = tepg.bssfp_sequence(FA, 12.0, T1=T1, T2=T2)
    got = tepg.simulate(seq, fisp_kernel="force")
    want = tepg.simulate(seq, fisp_kernel=False)
    assert got.shape == want.shape == (16, 3, 4)
    assert np.abs(got - want).max() < 1e-5


# -- Jacobian probes --


JAC_TRAINS = {
    "t1_t2": (dict(df=np.linspace(-0.03, 0.03, 3), inversion=16.0,
                   order1=["T1", "T2"]), ["magnitude", "T1", "T2"]),
    "g_tracked": (TRAINS["tracked_g"], ["g", "magnitude", "T1", "T2"]),
    "g_tracked_no_df": (dict(inversion=12.0, order1=["T1", "T2", "g"]),
                        ["T2", "g"]),
    "b1_tracked": (dict(b1=np.array([0.8, 1.0, 1.1]), inversion=12.0,
                        df=0.02, order1=["T1", "T2"], b1_track=True),
                   ["magnitude", "T1", "T2", "B1"]),
}


@pytest.mark.parametrize("name", JAC_TRAINS)
def test_jacobian_probes_match_general_diff_path(port_f64, name):
    kw, names = JAC_TRAINS[name]
    seq = _train(tepg, **kw)
    probes = [tepg.ADC, tepg.Jacobian(names)]
    before = tfd.DISPATCH_COUNTS.get("jac:bssfp", 0)
    sig_k, jac_k = tepg.simulate(seq, probe=probes, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("jac:bssfp", 0) == before + 1
    sig_g, jac_g = tepg.simulate(seq, probe=probes, fisp_kernel=False)
    assert tfd.DISPATCH_COUNTS.get("jac:bssfp", 0) == before + 1
    assert jac_k.shape == jac_g.shape == sig_k.shape + (len(names),)
    assert np.abs(sig_k - sig_g).max() < 1e-8
    for c in range(len(names)):
        scale = max(np.abs(jac_g[..., c]).max(), 1.0)
        assert np.abs(jac_k[..., c] - jac_g[..., c]).max() < 1e-8 * scale


def test_untracked_prep_with_b1_tracking_falls_through(port_f64, caplog):
    """A B1-tracked train whose inversion prep is untracked cannot use the
    kernel's dB1 (it includes the prep's 180 * B1): general diff path."""
    seq = _train(tepg, **JAC_TRAINS["b1_tracked"][0])
    seq[0] = tepg.T(seq[0].alpha, 0.0)
    probes = [tepg.Jacobian(["B1"])]
    before = tfd.DISPATCH_COUNTS.get("jac:bssfp", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        got = tepg.simulate(seq, probe=probes, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("jac:bssfp", 0) == before
    assert any("untracked prep" in r.getMessage() for r in caplog.records)
    assert got.shape == (12, 3, 1)


# -- parameters carried across from the JAX matcher --


@pytest.mark.parametrize("name", ["offres_prep", "tracked_g", "b1_tracked"])
def test_jax_params_through_port_runners(port_f32, name):
    jp = jfd.match_bssfp(_train(jepg, **TRAINS[name]))
    tp = from_numpy_params(jp, "cpu")
    got = tfd.run_bssfp_kernel(tp).numpy()
    want = jfd.run_bssfp_kernel(jp, interpret=True)
    want = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    if not jp["vars"]:
        return
    specs = (("sig",), ("jac", ("magnitude",) + tuple(jp["vars"])))
    tj = tfd.run_bssfp_jacobian(tp, 0, specs)
    jj = jfd.run_bssfp_jacobian(jp, 0, specs, interpret=True)
    for a, b in zip(tj, jj):
        b = np.asarray(b["__c_re"]) + 1j * np.asarray(b["__c_im"])
        a = a.numpy()
        assert a.shape == b.shape
        scale = np.abs(b).max(axis=tuple(range(b.ndim - 1))) \
            if a.ndim == 3 else np.abs(b).max()
        assert (np.abs(a - b).max(axis=tuple(range(a.ndim - 1)))
                <= 1e-5 * np.maximum(scale, 1.0)).all()


# -- the steady-state sequences of both packages --


SEQUENCES = {
    "spgr": lambda m: m.spgr_sequence(20, alpha=12.0, T1=[600.0, 1200.0],
                                      T2=[50.0, 90.0]),
    "bssfp": lambda m: m.bssfp_sequence(
        10 + 30 * np.abs(np.sin(np.arange(20) / 3.0)), 11.0,
        T1=[600.0, 1200.0], T2=[50.0, 90.0], df=[0.01, -0.02],
        inversion=15.0),
    "dess": lambda m: m.dess_sequence(16, alpha=20.0, T1=[600.0, 1200.0],
                                      T2=[50.0, 90.0]),
}


@pytest.mark.parametrize("name", SEQUENCES)
def test_sequences_through_both_packages(port_f64, name):
    """models.ssfp's sequences of each package through its own
    simulate(): the port's general path and (bSSFP, DESS) kernel twin vs
    the JAX planner, float64."""
    seq = SEQUENCES[name](tepg.models)
    want = np.asarray(jepg.simulate(SEQUENCES[name](jssfp),
                                    fisp_kernel=False))
    # the FISP runner computes in float32 whatever the precision, so the
    # SPGR train meets the float64 bound on the general path only
    for mode in (False,) if name == "spgr" else (False, "force"):
        got = tepg.simulate(seq, fisp_kernel=mode)
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-10, mode
