"""The port's planned general path against JAX's and its own eager loop.

The scan planner (``epgpy_torch.engine._build_plan`` / ``_stack_block`` /
``_execute_plan``) must find the plans ``epgpy_tpu.engine._build_plan``
finds on the same operator lists, and the planned program must give what
the plain eager loop (``simulate_simple``) and the JAX package's
``simulate`` give, in float64 to 1e-12.  On the CPU the plan runs eagerly;
on the card the same program is one CUDA graph replay
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import logging

import numpy as np
import pytest
import torch

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_tpu import engine as jengine
from epgpy_torch import engine as tengine
from epgpy_torch import fisp_dispatch as tfd

from torch_support import family_train, port_f64  # noqa: F401

TOL = 1e-12
T2S = [30.0, 60.0]


def _cpmg(e, necho=10):
    return [e.T(90, 90)] + [
        e.E(4.5, 1400, list(T2S)), e.S(1), e.T(150, 0),
        e.E(4.5, 1400, list(T2S)), e.S(1), e.ADC] * necho


def _spgr(e, n=24):
    phases = np.cumsum(np.arange(n) * 117.0) % 360.0
    seq = []
    for i in range(n):
        seq += [e.T(15, phases[i]), e.E(3, 1000, 80),
                e.Adc(phase=-phases[i]), e.E(7, 1000, 80), e.S(1)]
    return seq


def _fisp_varying(e, n=12):
    FA = 10 + 50 * np.abs(np.sin(np.arange(n) * 0.3))
    B1 = np.array([0.8, 1.0, 1.2])
    seq = []
    for fa in FA:
        seq += [e.T(fa * B1, 90), e.E(5, [700.0, 1200.0, 900.0], 60.0),
                e.ADC, e.E(7, [700.0, 1200.0, 900.0], 60.0), e.S(1)]
    return seq


def _pd_spoiler_reset(e):
    # tests/test_engine.py:411
    return [e.T(50, 0), e.E(5, 800, 80), e.SPOILER, e.ADC,
            e.PD(0.7), e.T(30, 0), e.ADC,
            e.RESET, e.T(10, 0), e.ADC] * 3


def _two_probes(e, n=8):
    seq = [e.T(90, 90)]
    for i in range(n):
        seq += [e.S(1), e.T(120 + i, 0), e.E(5, 900, [40.0, 80.0]), e.ADC,
                e.S(1), e.E(3, 900, [40.0, 80.0]), e.ADC]
    return seq


def _exchange(e, n=6):
    khi = e.exchange_matrix(0.01, axis=-1, ncomp=2, densities=[0.8, 0.2])
    X = e.X(10.0, khi, axis=-1, T1=[1000.0, 800.0], T2=[80.0, 20.0])
    seq = []
    for i in range(n):
        seq += [e.T(30 + i, 0), e.ADC, X, e.S(1)]
    return seq


PLAN_CASES = {
    "cpmg": lambda e: _cpmg(e),
    "no_false_positive": lambda e: [e.T(90, 90), e.S(1), e.ADC],
    "spgr": lambda e: _spgr(e),
    "fisp_varying": lambda e: _fisp_varying(e),
    "pd_spoiler_reset": _pd_spoiler_reset,
    "two_probes": lambda e: _two_probes(e),
    "exchange": lambda e: _exchange(e),
}


def _kinds(plan, block_type):
    return [("scan", p.period, p.reps) if isinstance(p, block_type)
            else ("unroll", len(p)) for p in plan]


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_jax(port_f64, case):
    """Kinds, periods and repetitions as ``epgpy_tpu.engine._build_plan``
    finds them (tests/test_engine.py test_plan_detects_period,
    test_plan_no_false_positive, test_spgr_scan_groups)."""
    jplan = jengine._build_plan(jengine.flatten_sequence(
        PLAN_CASES[case](jepg)))
    tplan = tengine._build_plan(tengine.flatten_sequence(
        PLAN_CASES[case](tepg)))
    assert _kinds(tplan, tengine._ScanBlock) == _kinds(jplan,
                                                       jengine._ScanBlock)
    if case == "cpmg":
        assert _kinds(tplan, tengine._ScanBlock)[1] == ("scan", 6, 10)
    if case == "spgr":
        assert _kinds(tplan, tengine._ScanBlock) == [("scan", 5, 24)]


def _simple(seq, sm, probes=None):
    """The eager loop's values on the sequence's batch shape."""
    vals, _ = tepg.simulate_simple(sm.broadcast(tengine.getshape(seq)), seq,
                                   probes=probes)
    return [np.stack([v[i].numpy() for v in vals])
            for i in range(len(vals[0]))]


def _init_sm(e):
    return e.StateMatrix([0, 0, 0.9], density=0.9, max_nstate=4)


_X_INIT = np.array([0, 0, 1.0]) * np.array([0.8, 0.2])[:, None, None]

SIM_CASES = {
    # name: (the train, simulate()'s keyword arguments, the eager loop's
    # initial state and probes)
    "fisp_varying": (lambda e: _fisp_varying(e), lambda e: {},
                     lambda: (tepg.StateMatrix(), None)),
    "pd_spoiler_reset": (_pd_spoiler_reset, lambda e: {},
                         lambda: (tepg.StateMatrix(), None)),
    "two_probes": (lambda e: _two_probes(e),
                   lambda e: {"probe": ["F0", "Z0"]},
                   lambda: (tepg.StateMatrix(),
                            [tepg.Probe("F0"), tepg.Probe("Z0")])),
    "exchange": (lambda e: _exchange(e), lambda e: {
        "max_nstate": 8, "density": [0.8, 0.2], "init": _X_INIT},
        lambda: (tepg.StateMatrix(_X_INIT, density=[0.8, 0.2],
                                  max_nstate=8), None)),
    "init_statematrix": (lambda e: _cpmg(e, 6),
                         lambda e: {"init": _init_sm(e)},
                         lambda: (_init_sm(tepg), None)),
    "nstate_floor": (lambda e: _cpmg(e, 4), lambda e: {"nstate": 32},
                     lambda: (tepg.StateMatrix(nstate=32), None)),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_planned_matches_simple_and_jax(port_f64, case):
    build, kwargs, eager = SIM_CASES[case]
    tseq = build(tepg)
    got = tepg.simulate(tseq, fisp_kernel=False, **kwargs(tepg))
    want = jepg.simulate(build(jepg), **kwargs(jepg))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        assert np.abs(g - np.asarray(w)).max() < TOL
    for g, s in zip(got, _simple(tseq, *eager())):
        assert np.abs(g - s).max() < TOL


def test_callback_runs_eagerly(port_f64):
    """A callback sees every non-probe op (tests/test_engine.py:245), the
    plan is not scanned, and simulate() says why it ran eagerly only on
    the card (on the CPU every plan runs eagerly)."""
    norms, jnorms = [], []

    def train(e):
        return [e.T(90, 90)] + [e.S(1), e.T(120, 0), e.E(5, 900, 60),
                                e.S(1), e.ADC] * 4

    seq = train(tepg)
    got = tepg.simulate(seq, callback=lambda sm: norms.append(
        float(sm.norm[0])))
    want = jepg.simulate(train(jepg), jit=False, callback=lambda sm:
                         jnorms.append(float(np.asarray(sm.norm)[0])))
    assert len(norms) == len(jnorms) == 17
    assert np.allclose(norms, jnorms, rtol=0, atol=TOL)
    assert np.abs(got - np.asarray(want)).max() < TOL
    assert tengine._plan_and_payload(seq, scan=False).kinds == (("unroll",),)
    assert tengine._host_work(len, False, None, seq) is not None
    assert tengine._host_work(None, True, None, seq) is not None
    assert tengine._host_work(None, False, (tepg.Probe(lambda sm: sm.F0),),
                              seq) is not None
    assert tengine._host_work(None, False, (tepg.Probe("F0"), tepg.ADC),
                              seq) is None


def test_stack_block_slots(port_f64):
    """Invariant E slots are precomputed once, varying T slots stack their
    angles, varying E slots become precomputed coefficients over the
    repetition axis, and every payload tensor sits on the working device
    (tests/test_engine.py:367)."""
    from epgpy_torch.ops.scalarop import PrecomputedDiagonal

    seq = _fisp_varying(tepg)
    entry = tengine._plan_and_payload(seq, cache=False)
    assert entry.kinds == (("scan", 12),)
    template, slots = entry.payload[0]
    assert [s[0] for s in slots] == ["stack", "const", "const", "const",
                                     "const"]
    assert isinstance(slots[1][1], PrecomputedDiagonal)
    alpha, phi = slots[0][2]
    assert tuple(alpha.shape) == (12, 3) and tuple(phi.shape) == (12,)
    varying = []
    for i in range(6):
        varying += [tepg.T(30, 90), tepg.E(5.0 + i, 900.0, [50.0, 70.0]),
                    tepg.ADC, tepg.S(1)]
    slots = tengine._plan_and_payload(varying, cache=False).payload[0][1]
    assert slots[0][0] == "const" and slots[1][0] == "stack"
    assert isinstance(slots[1][1], PrecomputedDiagonal)
    assert tuple(slots[1][2][0].shape) == (6, 2)
    for slot in slots:
        leaves = slot[2] if slot[0] == "stack" else slot[1].leaves()
        assert all(x is None or isinstance(x, torch.Tensor) for x in leaves)


def test_plan_cache_keeps_bytes_budget(port_f64, monkeypatch):
    """The plan cache evicts its oldest entries past its byte budget, and
    an entry pins its operator list."""
    tengine._PLAN_CACHE.clear()
    seqs = [_fisp_varying(tepg, 8) for _ in range(3)]
    for s in seqs:
        tepg.simulate(s, fisp_kernel=False)
    assert len(tengine._PLAN_CACHE) == 3
    one = next(iter(tengine._PLAN_CACHE.values())).nbytes
    assert one > 0
    monkeypatch.setattr(tengine, "_PLAN_CACHE_MAX_BYTES", 2 * one)
    tepg.simulate(_fisp_varying(tepg, 8), fisp_kernel=False)
    assert len(tengine._PLAN_CACHE) == 2
    assert all(len(e.ops) == len(seqs[0])
               for e in tengine._PLAN_CACHE.values())
    tengine.clear_caches()
    assert not tengine._PLAN_CACHE


@pytest.mark.parametrize("case", ["cpmg", "tracked"])
def test_squeeze_matches_jax(port_f64, case):
    """squeeze_sequence merges what JAX merges and keeps tracked ops
    (tests/test_engine.py:311, :482)."""
    def build(e):
        if case == "cpmg":
            return _cpmg(e, 6)
        return [e.T(90, 90), e.E(5, 1000, 50, order1=["T2"]),
                e.E(3, 1000, 50), e.ADC]

    tsq = tengine.squeeze_sequence(build(tepg))
    jsq = jengine.squeeze_sequence(build(jepg))
    assert [type(op).__name__ for op in tsq] == \
        [type(op).__name__ for op in jsq]
    assert sum(bool(op.order1) for op in tsq) == \
        sum(bool(op.order1) for op in jsq)
    got = tepg.simulate(build(tepg), squeeze=True, fisp_kernel=False)
    want = np.asarray(jepg.simulate(build(jepg), squeeze=True))
    assert np.abs(got - want).max() < TOL


#: every family's representative train (torch_support.family_train) and
#: the dispatch count it takes with the kernels forced (fisp_kernel=
#: "force"), as before the ops became ScalarOp/MatrixOp subclasses
FAMILY_COUNTS = {"fisp": "fisp", "mse": "mse", "bssfp": "bssfp",
                 "dess": "dess", "megre": "megre", "megre_m1": "fisp",
                 "dw": "dw", "comp": "comp"}


def test_family_dispatch_unchanged(port_f64):
    counts = {}
    for fam, tag in FAMILY_COUNTS.items():
        tfd.DISPATCH_COUNTS.clear()
        tepg.simulate(family_train(tepg, fam), fisp_kernel="force",
                      kvalue=74900.0 if fam == "dw" else 1.0)
        counts[fam] = dict(tfd.DISPATCH_COUNTS)
    assert counts == {fam: {tag: 1} for fam, tag in FAMILY_COUNTS.items()}


def test_squeezed_fisp_takes_general_path(port_f64, caplog):
    """With squeeze=True a FISP train's T and E merge into CombinedOps: no
    longer an exact FISP train, it takes the general path, as in JAX."""
    seq = family_train(tepg, "fisp")
    tfd.DISPATCH_COUNTS.clear()
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        got = tepg.simulate(seq, squeeze=True, fisp_kernel="force")
    assert not tfd.DISPATCH_COUNTS
    from epgpy_tpu import fisp_dispatch as jfd

    jfd_counts = dict(jfd.DISPATCH_COUNTS)
    want = np.asarray(jepg.simulate(family_train(jepg, "fisp"),
                                    squeeze=True, fisp_kernel="force"))
    assert dict(jfd.DISPATCH_COUNTS) == jfd_counts
    assert np.abs(got - want).max() < TOL
    ref = tepg.simulate(seq, fisp_kernel=False)
    assert np.abs(got - ref).max() < TOL


@pytest.mark.parametrize("name", ["ops", "exchange"])
def test_operator_zoo_planned_matches_simple(port_f64, name):
    """Every planned operator class (chip_smoke.op_zoo_trains: T, E, P,
    R, Phi, S, D, ScalarOp, MatrixOp, CombinedOp, Adc phases, Offset,
    Wait, NULL, System, SPOILER, PD, RESET, expression probes; an X
    train) planned against the eager loop, with every payload parameter
    on the device (what a CUDA graph capture needs)."""
    import chip_smoke

    _, seq, kw = dict((z[0], z) for z in
                      chip_smoke.op_zoo_trains(tepg, natoms=4, ntr=4))[name]
    got = tepg.simulate(seq, **kw)
    got = got if isinstance(got, tuple) else (got,)
    probes = ([tepg.Probe(p) for p in kw["probe"]] if "probe" in kw
              else None)
    init = ({"density": kw["density"], "nstate": kw["max_nstate"]}
            if "density" in kw else {})
    want = chip_smoke._eager(torch, tepg, seq, probes, **init)
    for g, w in zip(got, want):
        assert np.abs(g - w.numpy()).max() < TOL
    entry = tengine._plan_and_payload(tengine.flatten_sequence(seq))
    for kind, pl in zip(entry.kinds, entry.payload):
        ops = pl if kind[0] == "unroll" else [
            s[1] for s in pl[1] if s[0] == "const"]
        for op in ops:
            for sub in getattr(op, "ops", [op]):
                assert all(x is None or isinstance(x, torch.Tensor)
                           for x in sub.leaves()), sub
