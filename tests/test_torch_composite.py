"""The composite-GRE family of epgpy_torch vs epgpy_tpu: kernels' plain
twins, dispatch, Jacobian probes, the goldens and the family table.

* ``composite_plain`` / ``composite_jacobian_plain`` (float32) vs the JAX
  Pallas kernels in interpret mode over the option cases of
  ``chip_smoke.COMP_CASES`` (shifts up, down and mixed, ADC phases, b1u
  stages, df, D stages with ramps -1/0/+1, stages without a readout and
  neutral stages, nstate 1), 8 atoms x 60 stages: signals to 1e-5
  absolute, each tangent column to 1e-5 of the column's scale, over every
  group set (none, each alone, all four);
* the float64 paths -- ``simulate(fisp_kernel="force")`` (the twin) and
  ``simulate(fisp_kernel=False)`` (the eager loop) -- vs the goldens
  ``mprage.npz`` and ``cardiac_mrf.npz`` to 1e-10;
* ``match_composite`` returns the JAX matcher's dict, key by key, and falls
  through with a logged reason on the JAX tests' off-pattern trains;
* Jacobian probes over (magnitude, T1, T2, B1, g) through the float64
  Jacobian twin == the port's general diff path to 1e-8;
* a JAX match dict carried through ``convert`` runs the port's runners to
  the JAX runners' values;
* the exact-pattern families keep their trains: composite comes last in
  the table;
* the CUDA kernels' lane maps: the float64 twins with every shift
  replayed through the segmented layouts (the Jacobian's cyclic rows, the
  primal's blocked rows, ``torch_support.seg_shift_emulated``) equal the
  twins; the launch geometries and the gates are pinned.
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
from epgpy_torch.models import cuda_composite
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu.models import pallas_composite

from chip_smoke import (COMP_CASES, COMP_EDGE_CASES, COMP_GROUP_SETS,
                        COMP_PRIMAL_EDGE_CASES, comp_golden_sequence,
                        comp_tensors, make_comp_case)
from epgpy_torch.models import cuda_fisp, planes
from torch_support import (GOLDEN_DIR, cplx, family_train,  # noqa: F401
                           port_f32, port_f64, seg_owned_atoms,
                           seg_shift_emulated)

B, NSTAGE = 8, 60
KV = 2 * np.pi / 1e-3          # 1 mm voxel: rad/m per state index


def _twin_case(case, groups=None):
    """The JAX kernel (interpret mode) and the twin on one option case:
    ((want_re, want_im), got) for the primal, or ((signals), (tangents))
    pairs of both for the Jacobian with `groups`."""
    args, kw = make_comp_case(case, B, NSTAGE)
    targs, tkw = comp_tensors(torch, args, kw, "cpu")
    if groups is None:
        want = pallas_composite.composite_pallas(*args, interpret=True,
                                                 btile=128, **kw)
        return want, cuda_composite.composite_plain(*targs, **tkw)
    want = pallas_composite.composite_jacobian_pallas(
        *args, groups=groups, interpret=True, btile=128, **kw)
    return want, cuda_composite.composite_jacobian_plain(*targs,
                                                         groups=groups, **tkw)


@pytest.mark.parametrize("case", COMP_CASES, ids=lambda c: c["name"])
def test_composite_twin_matches_jax_kernel(case):
    want, got = _twin_case(case)
    assert got[0].shape == (make_comp_case(case, B, NSTAGE)[1]["nadc"], B)
    assert got[0].dtype == torch.float32
    assert np.abs(cplx(*got) - cplx(*want)).max() < 1e-5


@pytest.mark.parametrize("case", COMP_CASES, ids=lambda c: c["name"])
def test_composite_jacobian_twin_matches_jax_kernel(case):
    _jacobian_case(case, COMP_GROUP_SETS[-1])


@pytest.mark.parametrize("groups", COMP_GROUP_SETS[:-1], ids=str)
def test_composite_jacobian_group_sets(groups):
    """Each group alone and none (magnitude only: a zero-width tangent
    axis) on the case with every option."""
    _jacobian_case(COMP_CASES[-1], groups)


def _jacobian_case(case, groups):
    (wsig, wtan), (gsig, gtan) = _twin_case(case, groups)
    assert np.abs(cplx(*gsig) - cplx(*wsig)).max() < 1e-5
    got, want = cplx(*gtan), cplx(*wtan)
    assert got.shape == want.shape == gsig[0].shape + (len(groups),)
    for c in range(len(groups)):
        scale = np.abs(want[..., c]).max()
        assert scale > 0
        assert np.abs(got[..., c] - want[..., c]).max() < 1e-5 * scale


def test_echo_layout_and_launch_counters():
    """The echo-layout wrappers take the twins for CPU tensors and count no
    kernel launch, the CUDA entry points raise on CPU tensors; the
    Jacobian's signal is the primal's; the gates are 6 and 6 (1 + ng)
    planes at 32 threads."""
    args, kw = comp_tensors(torch, *make_comp_case(COMP_CASES[-1], B, 40),
                            "cpu")
    before = (cuda_composite.LAUNCHES, cuda_composite.JAC_LAUNCHES)
    re, im = cuda_composite.composite_echoes(*args, **kw)
    (jre, jim), (dre, _) = cuda_composite.composite_jacobian_echoes(*args,
                                                                    **kw)
    assert (cuda_composite.LAUNCHES, cuda_composite.JAC_LAUNCHES) == before
    assert torch.allclose(re, jre, atol=1e-7)
    assert torch.allclose(im, jim, atol=1e-7)
    assert dre.shape == re.shape + (4,)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_composite.composite_cuda(*args, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_composite.composite_jacobian_cuda(*args, **kw)
    assert cuda_composite.composite_kernel_fits(301)
    assert not cuda_composite.composite_kernel_fits(302)
    for ng, deepest in ((4, 59), (3, 74), (2, 99), (1, 150)):
        assert cuda_composite.composite_jac_kernel_fits(deepest, ng)
        assert not cuda_composite.composite_jac_kernel_fits(deepest + 1, ng)


# -- float64 paths vs the goldens --


@pytest.mark.parametrize("name", ["mprage", "cardiac_mrf"])
def test_float64_paths_match_golden(port_f64, name):
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    seq = comp_golden_sequence(tepg, name, g)
    before = tfd.DISPATCH_COUNTS.get("comp", 0)
    forced = tepg.simulate(seq, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("comp", 0) == before + 1
    loop = tepg.simulate(seq, fisp_kernel=False)
    assert tfd.DISPATCH_COUNTS.get("comp", 0) == before + 1
    assert forced.dtype == loop.dtype == np.complex128
    assert forced.shape == loop.shape == g["signal"].shape
    assert np.abs(forced - g["signal"]).max() < 1e-10
    assert np.abs(loop - g["signal"]).max() < 1e-10


# -- the matcher: the JAX tests' trains --


_T1 = np.array([500.0, 1000.0, 1500.0])
_T2 = np.array([50.0, 80.0, 120.0])


def _mprage(e, nseg=3, nread=6, TI=120.0, TD=300.0):
    """tests/test_composite_dispatch.py:38's segmented MPRAGE train."""
    seq = []
    for seg in range(nseg):
        seq += [e.T(180.0, 0.0), e.E(TI, _T1, _T2)]
        for i in range(nread):
            seq += [e.T(9.0 + seg + 0.5 * i, 50.0 * i), e.E(3.0, _T1, _T2),
                    e.Adc(), e.E(5.0, _T1, _T2), e.S(1)]
        seq += [e.E(TD, _T1, _T2)]
    return seq


def _mprage_ops(e, nseg=3, nread=6, *, nb=4, track=None, track_b1=False,
                seed=11, df=None, adiabatic=True):
    """tests/test_composite_jacobian.py:20's MPRAGE train (tracked)."""
    rng = np.random.default_rng(seed)
    T1 = rng.uniform(400, 1800, nb)
    T2 = rng.uniform(30, 150, nb)
    B1 = rng.uniform(0.85, 1.15, nb)
    g = 0.0 if df is None else df
    o1 = {"order1": list(track)} if track else {}
    seq = []
    for s in range(nseg):
        inv = e.T(180.0, 0.0) if adiabatic else e.T(180.0 * B1, 0.0)
        seq += [inv, e.E(12.0 + s, T1, T2, g, **o1)]
        for i in range(nread):
            fa = float(rng.uniform(6, 14))
            t_kw = ({"order1": {"B1": {"alpha": fa}}} if track_b1 else {})
            seq += [e.T(fa * B1, 0.0, **t_kw), e.E(2.2, T1, T2, g, **o1),
                    e.ADC, e.E(3.8, T1, T2, g, **o1), e.S(1)]
        seq += [e.E(80.0 + 5 * s, T1, T2, g, **o1)]
    return seq


def _cardiac(e):
    g = np.load(os.path.join(GOLDEN_DIR, "cardiac_mrf.npz"))
    return comp_golden_sequence(e, "cardiac_mrf", g)


def _mixed_shifts(e):
    seq = []
    for i in range(12):
        s = e.S(1) if i % 3 == 0 else (e.S(-1) if i % 3 == 1 else e.S(2))
        seq += [e.T(25.0 + i, 7.0 * i), e.E(4.0, _T1, _T2), e.Adc(),
                e.E(4.5, _T1, _T2), s]
    return seq


def _adc_phases(e):
    seq = []
    for i in range(8):
        seq += [e.T(20.0, 58.5 * i * i), e.E(3.0, _T1, _T2),
                e.Adc(phase=-58.5 * i * i + 13.0), e.E(2.0, _T1, _T2),
                e.Adc(phase=7.0 * i), e.E(5.0, _T1, _T2), e.S(1)]
    return seq


def _balanced_df(e):
    df = np.array([0.0, 0.01, -0.02])
    seq = [e.T(30.0, 0.0), e.E(40.0, _T1, _T2, df)]
    for i in range(9):
        seq += [e.T(35.0, 180.0 * (i % 2)), e.E(2.0, _T1, _T2, df), e.Adc(),
                e.E(2.0, _T1, _T2, df)]
    return seq


def _wait_skipped(e):
    seq = []
    for i in range(8):
        seq += [e.T(15.0, 0.0), e.E(2.0, _T1, _T2), e.Adc(), e.Wait(1.0),
                e.E(4.0, _T1, _T2), e.S(1)]
    return seq


def _saturation_recovery(e):
    seq = []
    for blk in range(3):
        seq += [e.T(90.0, 0.0), e.S(1), e.E(50.0 + 20 * blk, _T1, _T2)]
        for i in range(5):
            seq += [e.T(10.0, 0.0), e.E(2.0, _T1, _T2), e.Adc(),
                    e.E(4.0, _T1, _T2), e.S(1)]
    return seq


def _dw_mprage(e, nb=3, track=None, *, Dc=1.2e-3, dkw=None, shared_d=True,
               down=False, seed=3):
    """tests/test_composite_jacobian.py:245's DW train: a crusher D(6, k=1)
    after every readout's shift and a constant-k D inside each recovery;
    with `down` the readouts shift by S(-1) under a D(6, k=-1)."""
    rng = np.random.default_rng(seed)
    T1 = rng.uniform(500, 1700, nb)
    T2 = rng.uniform(40, 150, nb)
    o1 = {"order1": list(track)} if track else {}
    dkw = ({"k": -1 if down else 1} if dkw is None else dkw)
    d_cr = e.D(6.0, Dc, **dkw)
    d_free = e.D(30.0, Dc)
    seq = []
    for s in range(2):
        seq += [e.T(180.0, 0.0), e.E(14.0, T1, T2, **o1)]
        for i in range(4):
            seq += [e.T(float(rng.uniform(6, 14)), 0.0),
                    e.E(2.2, T1, T2, **o1), e.ADC, e.E(3.8, T1, T2, **o1),
                    e.S(-1 if down else 1),
                    d_cr if shared_d else e.D(6.0, Dc, **dkw)]
        seq += [e.E(40.0, T1, T2, **o1), d_free, e.E(40.0, T1, T2, **o1)]
    return seq


def _t2prep(e, track=("T1", "T2")):
    """tests/test_composite_jacobian.py:135's T2prep + FISP blocks."""
    rng = np.random.default_rng(5)
    T1 = rng.uniform(400, 1600, 3)
    T2 = rng.uniform(30, 150, 3)
    o1 = {"order1": list(track)} if track else {}
    seq = []
    for blk in range(2):
        seq += [e.T(90.0, 0.0), e.E(15.0, T1, T2, **o1), e.T(180.0, 90.0),
                e.E(15.0, T1, T2, **o1), e.T(90.0, 180.0)]
        for i in range(5):
            seq += [e.T(10.0 + i + 3 * blk, 0.0), e.E(2.0, T1, T2, **o1),
                    e.ADC, e.E(4.0, T1, T2, **o1), e.S(1)]
        seq += [e.E(50.0, T1, T2, **o1)]
    return seq


def _demodulated(e):
    """tests/test_composite_jacobian.py:209's RF-spoiled train."""
    rng = np.random.default_rng(9)
    T1 = rng.uniform(400, 1600, 3)
    T2 = rng.uniform(30, 150, 3)
    o1 = ["T1", "T2"]
    ph = np.cumsum(np.arange(8) * 117.0) % 360.0
    seq = []
    j = 0
    for s in range(2):
        seq += [e.T(180.0, 0.0), e.E(12.0, T1, T2, order1=o1)]
        for i in range(4):
            seq += [e.T(9.0, float(ph[j])), e.E(2.2, T1, T2, order1=o1),
                    e.Adc(phase=-float(ph[j])), e.E(3.8, T1, T2, order1=o1),
                    e.S(1)]
            j += 1
        seq += [e.E(60.0, T1, T2, order1=o1)]
    return seq


TRAINS = {
    "mprage": (_mprage, 1.0),
    "cardiac": (_cardiac, 1.0),
    "mixed_shifts": (_mixed_shifts, 1.0),
    "adc_phases_multiecho": (_adc_phases, 1.0),
    "balanced_df": (_balanced_df, 1.0),
    "wait_skipped": (_wait_skipped, 1.0),
    "saturation_recovery": (_saturation_recovery, 1.0),
    "dw_ramp_up": (_dw_mprage, KV),
    "dw_ramp_down": (lambda e: _dw_mprage(e, down=True), KV),
    "dw_distinct_instances": (lambda e: _dw_mprage(e, shared_d=False), KV),
    "b1_tracked_df": (lambda e: _mprage_ops(
        e, 2, 5, track=("T1", "T2", "g"), track_b1=True,
        df=np.linspace(-0.02, 0.02, 4)), 1.0),
    "t2prep_tracked": (_t2prep, 1.0),
    "demodulated": (_demodulated, 1.0),
}
KEYS = ("FA", "phi", "ta", "tb", "adci", "shift", "aph", "b1u", "T1", "T2",
        "B1", "df", "nadc", "shape", "vars", "b1_scale", "diffusion")


def _equal_dicts(j, t):
    assert set(t) == set(KEYS) and set(j) == set(KEYS)
    for k in KEYS:
        a, b = j[k], t[k]
        if k == "diffusion" and a is not None:
            assert set(a) == set(b) == {"btd", "rdir", "Dc"}
            for d in a:
                assert np.array_equal(np.asarray(a[d]), np.asarray(b[d])), d
        elif a is None or b is None or isinstance(a, (bool, int, float,
                                                      tuple)):
            assert a == b or (np.ndim(a) == 0 and np.ndim(b) == 0
                              and float(a) == float(b)), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


@pytest.mark.parametrize("name", TRAINS)
def test_match_composite_equals_jax(name):
    train, kv = TRAINS[name]
    j = jfd.match_composite(train(jepg), kv)
    t = tfd.match_composite(train(tepg), kv)
    assert j is not None and t is not None
    _equal_dicts(j, t)
    if name.startswith("dw_ramp"):
        rd = -1.0 if name.endswith("down") else 1.0
        assert set(t["diffusion"]["rdir"].tolist()) == {0.0, rd}


def _off_pattern(e, mutate):
    """The JAX tests' off-pattern mutations (test_composite_dispatch.py:184,
    test_composite_jacobian.py:173, :310) in package `e`; (seq, kvalue)."""
    if mutate in ("hessian", "alias", "mixed"):
        seq = _mprage_ops(e, 2, 4, nb=2,
                          track=None if mutate != "mixed" else ("T1", "T2"))
        if mutate == "mixed":
            i = next(j for j, op in enumerate(seq) if type(op) is e.E)
            seq[i] = e.E(seq[i].tau, seq[i].T1, seq[i].T2, seq[i].g,
                         order1=["T1"])
            return seq, 1.0
        o = ({"order1": ["T1", "T2"], "order2": [("T1", "T1")]}
             if mutate == "hessian" else {"order1": {"R2": {"T2": 2.0}}})
        return [e.E(op.tau, op.T1, op.T2, op.g, **o) if type(op) is e.E
                else op for op in seq], 1.0
    if mutate in ("tensor", "ramp_noshift", "dc_vary"):
        if mutate == "tensor":
            return _dw_mprage(e, 2, Dc=np.diag([1e-3, 1e-3, 1e-3])), KV
        seq = _dw_mprage(e, 2, shared_d=mutate == "ramp_noshift")
        if mutate == "ramp_noshift":
            i = next(j for j, op in enumerate(seq)
                     if type(op) is e.D and op.kshift is None)
            seq[i] = e.D(30.0, 1.2e-3, k=1)
        else:
            i = next(j for j, op in enumerate(seq) if type(op) is e.D)
            seq[i] = e.D(6.0, 2.5e-3, k=1)
        return seq, KV
    seq = _mprage(e, nseg=2, nread=4)
    if mutate == "probe":
        # the port's Probe takes a callable (expression strings are JAX's)
        seq[4] = e.Probe("F0") if e is jepg else e.Probe(lambda sm: sm.F0)
    elif mutate == "g_mismatch":
        op = seq[3]
        seq[3] = e.E(op.tau, op.T1, op.T2, 0.03)
    elif mutate == "t2_change":
        op = seq[3]
        seq[3] = e.E(op.tau, op.T1, np.asarray(op.T2) + 1.0)
    elif mutate == "big_shift":
        i = next(j for j, op in enumerate(seq) if type(op) is e.S)
        seq[i] = e.S(9)
    elif mutate == "diff_t":
        op = seq[0]
        seq[0] = e.T(op.alpha, op.phi, order1=["alpha"])
    elif mutate == "short":
        seq = seq[:7]
    return seq, 1.0


OFF_PATTERN = ["probe", "g_mismatch", "t2_change", "big_shift", "diff_t",
               "short", "hessian", "alias", "mixed", "tensor",
               "ramp_noshift", "dc_vary"]


@pytest.mark.parametrize("mutate", OFF_PATTERN)
def test_off_pattern_trains_fall_through(port_f64, mutate, caplog):
    jseq, kv = _off_pattern(jepg, mutate)
    assert jfd.match_composite(jseq, kv) is None
    seq, _ = _off_pattern(tepg, mutate)
    tfd.clear_cache()
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        assert tfd.match_composite(seq, kv) is None
    assert any("not a composite-GRE stage train" in r.getMessage()
               for r in caplog.records)
    if mutate in ("probe", "hessian", "alias", "mixed", "diff_t"):
        return
    before = tfd.DISPATCH_COUNTS.get("comp", 0)
    got = tepg.simulate(seq, fisp_kernel="force", max_nstate=6, kvalue=kv)
    assert tfd.DISPATCH_COUNTS.get("comp", 0) == before
    want = np.asarray(jepg.simulate(jseq, fisp_kernel=False, max_nstate=6,
                                    kvalue=kv))
    assert np.abs(got - want).max() < 1e-10


def test_adc_weights_are_not_ported():
    """The JAX mutation "adc_weights" falls through there, and the port's
    matcher leaves a weighted ADC to the general path too: the composite
    kernel does not port weighted readouts."""
    seq = _mprage(jepg, nseg=2, nread=4)
    i = next(j for j, op in enumerate(seq) if type(op) is jepg.Adc)
    seq[i] = jepg.Adc(weights=[1.0, 2.0, 3.0])
    assert jfd.match_composite(seq) is None
    tseq = _mprage(tepg, nseg=2, nread=4)
    assert tfd.match_composite(tseq) is not None
    tseq[i] = tepg.Adc(weights=[1.0, 2.0, 3.0])
    assert tfd.match_composite(tseq) is None


def test_device_tensor_disqualifies(port_f64):
    """A flip that requires grad (the JAX matcher's tracer check) leaves
    the train to the general path."""
    seq = _mprage(tepg)
    seq[0] = tepg.T(torch.tensor(180.0, dtype=torch.float64,
                                 requires_grad=True), 0.0)
    assert tfd.match_composite(seq) is None


# -- Jacobian probes --


JAC_TRAINS = {
    "all_groups": (lambda e: _mprage_ops(
        e, 2, 5, track=("T1", "T2", "g"), track_b1=True,
        df=np.linspace(-0.02, 0.02, 4)), 1.0,
        ["magnitude", "T1", "T2", "B1", "g"], 10),
    "g_at_df0": (lambda e: _mprage_ops(e, 2, 4, nb=3,
                                       track=("T1", "T2", "g")), 1.0,
                 ["g", "T2"], 8),
    "t2prep": (_t2prep, 1.0, ["T1", "T2"], 8),
    "demodulated": (_demodulated, 1.0, ["magnitude", "T1", "T2"], 8),
    "dw": (lambda e: _dw_mprage(e, 3, track=("T1", "T2")), KV,
           ["magnitude", "T1", "T2"], 8),
    "magnitude_only": (lambda e: _mprage_ops(e, 2, 4, nb=2,
                                             track=("T1", "T2")), 1.0,
                       ["magnitude"], 8),
}


@pytest.mark.parametrize("name", JAC_TRAINS)
def test_jacobian_probes_match_general_diff_path(port_f64, name):
    train, kv, names, ns = JAC_TRAINS[name]
    seq = train(tepg)
    probes = [tepg.ADC, tepg.Jacobian(names)]
    kw = dict(probe=probes, max_nstate=ns, kvalue=kv)
    before = tfd.DISPATCH_COUNTS.get("jac:comp", 0)
    sig_k, jac_k = tepg.simulate(seq, fisp_kernel="force", **kw)
    assert tfd.DISPATCH_COUNTS.get("jac:comp", 0) == before + 1
    sig_g, jac_g = tepg.simulate(seq, fisp_kernel=False, **kw)
    assert jac_k.shape == jac_g.shape == sig_k.shape + (len(names),)
    assert np.abs(sig_k - sig_g).max() < 1e-8
    for c in range(len(names)):
        scale = max(np.abs(jac_g[..., c]).max(), 1.0)
        assert np.abs(jac_g[..., c]).max() > 0
        assert np.abs(jac_k[..., c] - jac_g[..., c]).max() < 1e-8 * scale


def test_jacobian_groups_of_probes():
    specs = (("sig",), ("jac", ("magnitude", "g", "T1")))
    assert tfd.composite_jac_groups(specs) == ("T1", "df")
    assert tfd.composite_jac_groups((("jac", ("magnitude",)),)) == ()
    assert tfd.composite_jac_groups(specs) == jfd.composite_jac_groups(specs)


# -- parameters carried across from the JAX matcher --


@pytest.mark.parametrize("name", ["b1_tracked_df", "dw_ramp_down",
                                  "cardiac"])
def test_jax_params_through_port_runners(port_f32, name):
    train, kv = TRAINS[name]
    jp = jfd.match_composite(train(jepg), kv)
    tp = from_numpy_params(jp, "cpu")
    assert set(tp) - {"_dev"} == set(KEYS)
    got = tfd.run_composite_kernel(tp, 6).numpy()
    want = jfd.run_composite_kernel(jp, 6, interpret=True)
    want = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    names = ("magnitude",) + tuple(jp["vars"] or ("T1", "T2"))
    specs = (("sig",), ("jac", names))
    tj = tfd.run_composite_jacobian(tp, 6, specs)
    jj = jfd.run_composite_jacobian(jp, 6, specs, interpret=True)
    for a, b in zip(tj, jj):
        b = np.asarray(b["__c_re"]) + 1j * np.asarray(b["__c_im"])
        a = a.numpy()
        assert a.shape == b.shape
        scale = np.abs(b).max(axis=tuple(range(b.ndim - 1))) \
            if a.ndim == 3 else np.abs(b).max()
        assert (np.abs(a - b).max(axis=tuple(range(a.ndim - 1)))
                <= 1e-5 * np.maximum(scale, 1.0)).all()


# -- the family table: composite comes last --


FAMILIES = ["fisp", "mse", "bssfp", "dess", "megre", "dw", "comp"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_exact_families_keep_their_trains(port_f64, fam):
    """simulate() dispatches each family's train to its own kernel (the
    first match of the table wins); whether composite could also claim it
    is the JAX matcher's answer."""
    kv = 1.0
    jcomp = jfd.match_composite(family_train(jepg, fam), kv) is not None
    seq = family_train(tepg, fam)
    assert (tfd.match_composite(seq, kv) is not None) == jcomp
    tfd.DISPATCH_COUNTS.clear()
    tepg.simulate(seq, fisp_kernel="force", kvalue=kv)
    assert dict(tfd.DISPATCH_COUNTS) == {fam: 1}


def test_group_order_is_jax():
    assert cuda_composite.COMP_JAC_GROUPS == pallas_composite.COMP_JAC_GROUPS


# -- the segmented layout of composite_jac.cu: its down shift, lane map,
# geometry and gate --


def test_seg_shift_down_emulation():
    """epg::seg_shift_down, replayed in numpy (NaN in the idle lanes, past
    the last atom and in the padding rows), equals planes.shift_down
    exactly for every H from 2 to 151 and every R from 1 to 5 that the
    layout takes (2 <= W = ceil(H / R) <= 32), and leaves the padding rows
    zero; so does epg::seg_shift with planes.shift_fold."""
    rng = np.random.default_rng(5)
    ran = 0
    for H in range(2, 152):
        s = tuple(torch.as_tensor(rng.normal(size=(H, 7))) for _ in range(6))
        for R in range(1, 6):
            if not 2 <= -(-H // R) <= 32:
                continue
            for down, ref in ((True, planes.shift_down),
                              (False, planes.shift_fold)):
                got, pad = seg_shift_emulated(s, R, down=down, padding=True)
                for g, w in zip(got, ref(s)):
                    assert torch.equal(g, w), (H, R, down)
                assert (pad == 0.0).all(), (H, R, down)
            ran += 1
    assert ran > 300


@pytest.mark.parametrize("case,groups", COMP_EDGE_CASES,
                         ids=lambda c: c["name"] if isinstance(c, dict)
                         else ",".join(c))
def test_segmented_lane_map_matches_twin(monkeypatch, case, groups):
    """The float64 Jacobian twin with every shift -- up and down -- replayed
    through the kernel's lane map at its rows per lane (comp_jac_geometry:
    the gate's deepest ladders with 4 / 3 / 2 / 1 groups take 2 / 3 / 4 / 5
    rows) equals the twin exactly, with every option (mixed shifts, D with
    ramps, df, ADC phases, b1u, sparse readouts), over more stages than the
    ladder has rows."""
    args, kw = make_comp_case(case, 5, case["nstate"] + 12, seed=2)
    targs, tkw = comp_tensors(torch, args, kw, "cpu")
    targs = tuple(t.double() if isinstance(t, torch.Tensor)
                  and t.is_floating_point() else t for t in targs)
    if tkw.get("diffusion") is not None:
        tkw["diffusion"] = tuple(d.double() for d in tkw["diffusion"])
    want = cuda_composite.composite_jacobian_plain(*targs, groups=groups,
                                                   **tkw)
    R = cuda_composite.comp_jac_geometry(case["nstate"], len(groups))["R"]
    monkeypatch.setattr(planes, "shift_fold",
                        lambda x: seg_shift_emulated(x, R))
    monkeypatch.setattr(planes, "shift_down",
                        lambda x: seg_shift_emulated(x, R, down=True))
    got = cuda_composite.composite_jacobian_plain(*targs, groups=groups,
                                                  **tkw)
    assert got[0][0].dtype == torch.float64
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.isfinite(g).all() and torch.equal(g, w)


def test_comp_jac_geometry_and_gate():
    """The gate answers as the thread-per-atom layout set it (nstate <= 59,
    74, 99, 150, 301 with 4, 3, 2, 1, 0 groups); for every ladder it admits
    the segmented kernel takes 2 rows per lane (1 for H <= 3, ceil(H / 32)
    past 64 rows, 10 past 160) -- at most 6 (1 + ng) R = 72 floats of state
    per lane with groups -- a segment of 2 <= W <= 32 lanes, as many ladders
    per warp as fit, 4 warps per block and a chunk within 48 KB."""
    for ng, top in ((4, 59), (3, 74), (2, 99), (1, 150), (0, 301)):
        assert cuda_composite.composite_jac_kernel_fits(top, ng)
        assert not cuda_composite.composite_jac_kernel_fits(top + 1, ng)
        for n in range(1, top + 1):
            geo = cuda_composite.comp_jac_geometry(n, ng)
            H, R, W, L = n + 1, geo["R"], geo["W"], geo["L"]
            assert R == (1 if H <= 3 else 2 if H <= 64
                         else -(-H // 32) if H <= 160 else 10)
            assert ng == 0 or 6 * (1 + ng) * R <= 72
            assert 2 <= W <= 32 and W == -(-H // R)
            assert L == 32 // W and geo["warps"] == cuda_fisp.SEG_WARPS
            per = cuda_composite.COMP_JAC_TABLE + (2 + 2 * ng) * 4 * L
            assert geo["smem"] == 4 * geo["pulses"] * per <= 48 * 1024


# -- the segmented layout of composite.cu (blocked rows): lane map,
# geometry and gate --


@pytest.mark.parametrize("case", COMP_CASES + COMP_PRIMAL_EDGE_CASES,
                         ids=lambda c: c["name"])
def test_comp_lane_map_matches_twin(monkeypatch, case):
    """The float64 primal twin with every shift -- up and down -- replayed
    through the kernel's lane map at its rows per lane (comp_geometry;
    blocked rows, epg::seg_shift_blocked and epg::seg_shift_blocked_down
    emulated in numpy with NaN in the idle lanes, past the last atom and in
    the padding rows) equals the twin, over every option case and the
    kernel's edges (nstate 301 with mixed shifts and with every stage
    shifting up, both sides of every change of the rows per lane), each
    over 20 stages more than the ladder has rows (60 at least)."""
    nstage = max(60, case.get("nstate", 10) + 21)
    args, kw = make_comp_case(case, 5, nstage, seed=2)
    targs, tkw = comp_tensors(torch, args, kw, "cpu")
    targs = tuple(t.double() if isinstance(t, torch.Tensor)
                  and t.is_floating_point() else t for t in targs)
    if tkw.get("diffusion") is not None:
        tkw["diffusion"] = tuple(d.double() for d in tkw["diffusion"])
    want = cuda_composite.composite_plain(*targs, **tkw)
    R = cuda_composite.comp_geometry(tkw["nstate"])["R"]
    calls = [0]

    def shift(down):
        def run(x):
            calls[0] += 1
            return seg_shift_emulated(x, R, down=down, blocked=True)
        return run

    monkeypatch.setattr(planes, "shift_fold", shift(False))
    monkeypatch.setattr(planes, "shift_down", shift(True))
    got = cuda_composite.composite_plain(*targs, **tkw)
    assert calls[0] == int((np.asarray(args[5]) != 0).sum())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and torch.isfinite(g).all()
        assert torch.equal(g, w)


def test_comp_geometry():
    """For every ladder the gate admits (nstate 0-301): R rows per lane in
    the kernel's instances (1, 2, 4, ..., 12), as cuda_fisp.half_rows
    gives them, W = ceil(H / R) <= 32 lanes per ladder, L = 32 // W
    ladders per warp, 4 warps and 32 stages per chunk, the table (16 floats
    per stage) and the staged echoes within 48 KB; a grid whose (block,
    warp, segment) slots store each of 1, 33 and 4,097 atoms exactly once;
    one ladder per lane at the cardiac MRF's nstate 10 (12 rows) and at
    MPRAGE's nstate 8 (10 rows), 12 rows on 26 lanes at nstate 301."""
    for n in range(0, 302):
        geo = cuda_composite.comp_geometry(n)
        H, R, W, L = n + 1, geo["R"], geo["W"], geo["L"]
        assert R in cuda_fisp.HALF_ROWS and R == cuda_fisp.half_rows(n)
        assert W == -(-H // R) <= 32 and L == 32 // W
        assert (geo["warps"], geo["pulses"]) == (4, 32)
        assert geo["atoms"] == 4 * L
        assert geo["smem"] == 4 * 32 * (cuda_composite.COMP_TABLE
                                         + 2 * geo["atoms"]) <= 48 * 1024
        for B_ in (1, 33, 4097):
            owned, _ = seg_owned_atoms(geo, B_)
            assert sorted(owned) == list(range(B_)), (n, B_)
    assert [(g["R"], g["W"]) for g in map(cuda_composite.comp_geometry,
                                           (10, 8, 301))] == [
        (12, 1), (10, 1), (12, 26)]


def test_comp_gate_unchanged():
    """composite_kernel_fits over nstate 0-400 answers as the
    thread-per-atom layout set it (6 planes of nstate + 1 rows of 32 atoms
    in 232,448 bytes): nstate <= 301."""
    for n in range(401):
        assert cuda_composite.composite_kernel_fits(n) == (n <= 301), n
