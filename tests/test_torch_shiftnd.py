"""The port's coordinate-table path against the JAX package, in float64.

``epgpy_torch/ops/shiftnd.py`` (the sort merge of shared and per-atom
tables), ``ops/shiftdense.py`` (the dense rows-are-cells merges), the
engine's capacity and dense-grid gates, n-D diffusion and the planned
table train: the same numpy inputs (made from a seed) through both
packages, at the limits of ``tests/test_shiftnd.py`` (1e-12 between
engines, 1e-10 on signals).  JAX's own table merge runs its sort engine
here (``method="sort"``), so rows come out in the same order.
"""

import math

import numpy as np
import pytest
import torch

import epgpy_torch as epg
import epgpy_tpu as jepg
from epgpy_torch import engine
from epgpy_torch.ops import shiftdense, shiftnd
from epgpy_tpu import engine as jengine
from epgpy_tpu.ops import shiftdense as jdense, shiftnd as jnd

from torch_support import port_f64, random_ladder  # noqa: F401

TOL = 1e-12


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the merges, function against function --


@pytest.mark.parametrize("d, batch", [(1, (3,)), (2, (2, 2)), (3, ())])
def test_shiftnd_table_matches_jax(port_f64, d, batch):
    rng = np.random.default_rng(d)
    C = 9
    states = random_ladder(rng, batch or (1,), (C - 1) // 2)
    if not batch:
        states = states[0]
    coords = np.zeros((C, d), np.int64)
    coords[:, 0] = np.arange(C) - C // 2
    delta = rng.integers(-2, 3, size=d)
    delta[0] = 1
    got = shiftnd.shiftnd_table(torch.as_tensor(states), coords, delta)
    want = jnd.shiftnd_table(states, coords, delta, method="sort")
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        assert np.abs(_np(g) - np.asarray(w)).max() < TOL


@pytest.mark.parametrize("d, grid", [(1, 0.5), (2, 0.25), (3, [0.5, 0.3, 1.0])])
def test_shiftmerge_table_matches_jax(port_f64, d, grid):
    rng = np.random.default_rng(10 + d)
    C = 11
    states = random_ladder(rng, (4,), (C - 1) // 2)
    wav = np.zeros((C, d))
    wav[:, 0] = (np.arange(C) - C // 2) * 0.7
    if d > 1:
        wav[:, 1:] = rng.normal(size=(C, d - 1))
        wav = 0.5 * (wav - wav[::-1])           # a symmetric table
    delta = rng.uniform(0.3, 1.5, size=d)
    got = shiftnd.shiftmerge_table(torch.as_tensor(states), wav, delta, grid)
    want = jnd.shiftmerge_table(states, wav, delta, np.asarray(grid),
                                method="sort")
    for g, w in zip(got, want):
        assert np.abs(_np(g) - np.asarray(w)).max() < TOL


def test_shiftmerge_batched_matches_vmapped_jax(port_f64):
    """The per-atom merge (one batched sort over (B, 3C) keys) against
    JAX's merge run atom by atom (what its vmap computes)."""
    rng = np.random.default_rng(4)
    B, C, d = 5, 9, 2
    states = random_ladder(rng, (B,), (C - 1) // 2)
    wav = rng.normal(size=(B, C, d))
    wav = 0.5 * (wav - wav[:, ::-1])
    delta = rng.uniform(-1.5, 1.5, size=(B, d))
    got_s, got_k = shiftnd.shiftmerge_table_batched(
        torch.as_tensor(states), torch.as_tensor(wav),
        torch.as_tensor(delta), 0.25)
    for b in range(B):
        ws, wk = jnd.shiftmerge_table(states[b], wav[b], delta[b], 0.25,
                                      method="sort")
        assert np.abs(got_s[b].numpy() - np.asarray(ws)).max() < TOL
        assert np.abs(got_k[b].numpy() - np.asarray(wk)).max() < TOL


def test_shiftmerge_dense_matches_jax(port_f64):
    rng = np.random.default_rng(5)
    D, grid = 21, 0.5
    states = random_ladder(rng, (3,), D // 2)
    wav = (np.arange(D) - D // 2) * grid + rng.uniform(-0.2, 0.2, D) * grid
    wav = 0.5 * (wav - wav[::-1])
    for delta in (0.8, -1.7, 2.26):
        got = shiftdense.shiftmerge_dense(
            torch.as_tensor(states), torch.as_tensor(wav),
            torch.tensor(delta, dtype=torch.float64), grid)
        want = jdense.shiftmerge_dense(states, wav, delta, grid)
        for g, w in zip(got, want):
            assert np.abs(_np(g) - np.asarray(w)).max() < TOL


@pytest.mark.parametrize("kernel, dmax", [("rolls", 1.0), ("gather", 1.0),
                                          ("gather", 4.0)])
def test_shiftmerge_dense_varying_matches_jax(port_f64, kernel, dmax,
                                              monkeypatch):
    """The batch-varying dense merge against JAX's lanes kernel, with its
    masked rolls and with its gathers; shifts up to 4 (16 rows) move rows
    past the ladder's edge, and back in by their correction."""
    monkeypatch.setattr(jdense, "_VARYING_ROLL_MAX_WINDOW",
                        99 if kernel == "rolls" else 0)
    rng = np.random.default_rng(6)
    B, D, grid = 4, 25, 0.25
    fp = rng.normal(size=(B, D)) + 1j * rng.normal(size=(B, D))
    z = rng.normal(size=(B, D)) + 1j * rng.normal(size=(B, D))
    z = 0.5 * (z + np.conj(z[:, ::-1]))
    wav = ((np.arange(D) - D // 2) * grid)[None] + rng.uniform(
        -0.3, 0.3, (B, D)) * grid
    wav = 0.5 * (wav - wav[:, ::-1])
    delta = rng.uniform(-dmax, dmax, B)
    Fp, Z, k = shiftdense.shiftmerge_dense_varying(
        torch.as_tensor(fp), torch.as_tensor(z), torch.as_tensor(wav),
        torch.as_tensor(delta), grid)
    (jFp, jZ), jk = jdense.shiftmerge_dense_varying_lanes(
        (fp.T, z.T), wav.T, delta, grid, 20)
    for g, w in ((Fp, jFp), (Z, jZ), (k, jk)):
        assert np.abs(g.numpy().T - np.asarray(w)).max() < TOL


# -- trains: engines against each other and against JAX --


def test_shiftnd_matches_shift1d(port_f64):
    """A one-column integer table shift equals the plain 1-D shift."""
    seq1 = [epg.T(90, 90), epg.S(1), epg.T(120, 0), epg.S(1),
            epg.T(45, 45), epg.S(-1), epg.ADC]
    seqn = [epg.T(90, 90), epg.S(np.array([[1]])), epg.T(120, 0),
            epg.S(np.array([[1]])), epg.T(45, 45), epg.S(np.array([[-1]])),
            epg.ADC]
    s1 = np.asarray(epg.simulate(seq1, probe=["F0", "Z0"]))
    sn = np.asarray(epg.simulate(seqn, probe=["F0", "Z0"]))
    assert np.abs(s1 - sn).max() < TOL


def test_merge_matches_int_on_integer_floats(port_f64):
    seqf = [epg.T(90, 90), epg.S(np.array([[1.0]]), kgrid=1.0),
            epg.T(120, 0), epg.S(np.array([[1.0]]), kgrid=1.0), epg.ADC]
    seqi = [epg.T(90, 90), epg.S(1), epg.T(120, 0), epg.S(1), epg.ADC]
    sf = np.asarray(epg.simulate(seqf, max_nstate=10, probe=["F0", "Z0"]))
    si = np.asarray(epg.simulate(seqi, probe=["F0", "Z0"]))
    assert np.abs(sf - si).max() < 1e-10


def test_hyperecho_3d(port_f64):
    ks = [np.array([[1, 0, 0]]), np.array([[0, 1, 0]]),
          np.array([[1, 1, -1]]), np.array([[0, -1, 1]])]
    alphas = [20, 40, 60, 80]
    seq = [epg.T(90, 90)]
    for k, a in zip(ks, alphas):
        seq += [epg.S(k), epg.T(a, 0)]
    seq += [epg.S(np.array([[1, 1, 1]])), epg.T(180, 0),
            epg.S(np.array([[1, 1, 1]]))]
    for k, a in zip(reversed(ks), reversed(alphas)):
        seq += [epg.T(-a, 0), epg.S(k)]
    seq += [epg.ADC]
    assert np.allclose(np.abs(epg.simulate(seq)), 1.0, atol=1e-8)


def test_ladder_symmetry_after_nd_shift(port_f64):
    sm = epg.StateMatrix(nstate=4)
    sm = epg.T(70, 25)(sm)
    sm = epg.S(np.array([[1, -1]]))(sm)
    sm = epg.T(50, 10)(sm)
    sm = epg.S(np.array([[0, 1]]))(sm)
    assert sm.check()
    s = sm.states.numpy()
    # the kept set is exactly symmetric: F-(k) = conj(F+(-k)) to the bit
    assert np.array_equal(s[..., ::-1, 1], np.conj(s[..., 0]))


def test_D_preserves_ladder_symmetry(port_f64):
    sm = epg.StateMatrix(nstate=3, kvalue=1e4)
    sm = epg.T(60, 30)(sm)
    sm = epg.S(np.array([[1, 2]]))(sm)
    sm = epg.D(1.0, np.diag([1.0, 3.0]))(sm)
    s = sm.states.numpy()
    assert np.allclose(s, s[..., ::-1, :][..., (1, 0, 2)].conj())


def _jax_and_port(train, **kw):
    got = np.asarray(epg.simulate(train(epg), **kw))
    want = np.asarray(jepg.simulate(train(jepg), **kw))
    return got, want


@pytest.mark.parametrize("case", ["nd", "diffusion3d", "prune", "time",
                                  "int_vary"])
def test_table_trains_match_jax(port_f64, case):
    """Table trains through simulate() against JAX: n-D float shifts,
    3-D tensor diffusion during the shifts, batch-varying float shifts,
    the C operator with shifts, batch-varying integer shifts."""
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    T2 = np.linspace(40.0, 120.0, 3)
    ks = [np.round(rng.uniform(-3, 3, size=(1, 3)), 2) for _ in range(5)]
    kv = rng.uniform(0.5, 2.5, size=(3, 1))

    def train(e):
        seq = [e.T(90, 90)]
        for i, k in enumerate(ks):
            if case == "nd":
                seq += [e.S(k), e.T(40, 10 * i), e.E(5.0, 1000.0, T2), e.ADC]
            elif case == "diffusion3d":
                seq += [e.S(k), e.D(5.0, np.diag([2e-3, 1e-3, 5e-4]), k=k),
                        e.T(40, 0), e.E(5.0, 1000.0, T2), e.ADC]
            elif case == "prune":
                seq += [e.S(kv * (1 + 0.1 * i)), e.T(50, 20 * i),
                        e.E(6.0, 900.0, 75.0), e.ADC]
            elif case == "time":
                seq += [e.C(1.5, 0.2), e.S(1), e.T(60, 0),
                        e.E(2.0, 1000.0, T2), e.ADC]
            else:
                seq += [e.T(30, 90), e.E(5.0, 800.0, 80.0),
                        e.S(np.array([[1], [2], [3]])), e.ADC]
        return seq

    kw = dict(max_nstate=64, kgrid={"time": 0.1, "prune": 0.25}.get(case, 1.0))
    got, want = _jax_and_port(train, **kw)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-10


def _fail_if_called(*a, **k):
    raise AssertionError("dense engine ran while forced off")


def test_dense_engine_matches_table_engine(port_f64, monkeypatch):
    rng = np.random.default_rng(11)
    for trial in range(3):
        n = int(rng.integers(4, 8))
        seq = [epg.T(90, 90)]
        for i in range(n):
            seq += [epg.S(float(rng.uniform(0.5, 5.0))),
                    epg.T(float(rng.uniform(20, 70)), float(30 * i)),
                    epg.E(5.0, 1000.0, np.linspace(50.0, 120.0, 3)),
                    epg.ADC]
        flat = engine.flatten_sequence(seq)
        assert engine._dense_bound(flat, 0.5, 4096, 1.0) is not None
        engine.clear_caches()
        a = np.asarray(epg.simulate(seq, kgrid=0.5, max_nstate=4096))
        with monkeypatch.context() as mp:
            mp.setattr(engine, "_dense_bound", lambda *a_, **k: None)
            mp.setattr(shiftdense, "shiftmerge_dense", _fail_if_called)
            engine.clear_caches()
            b = np.asarray(epg.simulate(seq, kgrid=0.5, max_nstate=4096))
        engine.clear_caches()
        assert np.abs(a - b).max() < TOL


def test_dense_varying_matches_table_engine(port_f64, monkeypatch):
    """The batch-varying dense merge against the per-atom sort merge, a
    1-D batch and a 2-D one (per-atom shifts x an appended T2 sweep)."""
    rng = np.random.default_rng(21)
    for shape in ((4, 1), (3, 1, 1)):
        ks = rng.uniform(0.5, 3.0, size=shape)
        T2 = np.linspace(50.0, 110.0, 4)[None, :] if len(shape) == 3 \
            else 75.0
        seq = [epg.T(90, 90)]
        for i in range(5):
            seq += [epg.S(ks * (1 + 0.1 * i)), epg.T(50, 20 * i),
                    epg.E(6.0, 900.0, T2), epg.ADC]
        flat = engine.flatten_sequence(seq)
        assert engine._dense_varying_bound(flat, 0.25, 4096, 1.0) \
            is not None
        engine.clear_caches()
        a = np.asarray(epg.simulate(seq, kgrid=0.25, max_nstate=4096))
        with monkeypatch.context() as mp:
            mp.setattr(engine, "_dense_varying_bound", lambda *a_, **k: None)
            mp.setattr(shiftdense, "shiftmerge_dense_varying",
                       _fail_if_called)
            engine.clear_caches()
            b = np.asarray(epg.simulate(seq, kgrid=0.25, max_nstate=4096))
        engine.clear_caches()
        assert a.shape == b.shape
        assert np.abs(a - b).max() < TOL
        assert engine._dense_varying_bound(flat, 0.25, 8, 1.0) is None


@pytest.mark.parametrize("case", ["kvalue2", "kvalue03", "mixed", "gtrain"])
def test_dense_engine_kvalue_mixed_gtrain(port_f64, case, monkeypatch):
    """Dense against table engine across kvalue scaling, mixed int/float
    shift trains and gradient (G) trains; the port against JAX."""
    rng = np.random.default_rng(3)
    opts = {"max_nstate": 4096}
    if case in ("kvalue2", "kvalue03"):
        items = [(float(rng.uniform(1, 4)), i) for i in range(6)]
        opts["kgrid"] = 0.5 if case == "kvalue2" else 0.25
        opts["kvalue"] = 2.0 if case == "kvalue2" else 0.3

        def train(e):
            seq = [e.T(90, 90)]
            for k, i in items:
                seq += [e.S(k), e.T(50, 20 * i), e.E(6.0, 900.0, 75.0),
                        e.ADC]
            return seq
    elif case == "mixed":
        items = [int(rng.integers(1, 4)) if i % 2 else
                 float(rng.uniform(0.5, 3)) for i in range(6)]
        opts["kgrid"] = 0.5

        def train(e):
            seq = [e.T(90, 90)]
            for i, k in enumerate(items):
                seq += [e.S(k), e.T(45, 10 * i), e.E(5.0, 1000.0, 80.0),
                        e.ADC]
            return seq
    else:
        opts["kgrid"] = 50.0

        def train(e):
            seq = [e.T(90, 90)]
            for i in range(5):
                seq += [e.G(1.0 + 0.2 * i, 5.0), e.T(40, 0),
                        e.E(5.0, 1000.0, 80.0), e.ADC]
            return seq
    kv = opts.get("kvalue", 1.0)
    assert engine._dense_bound(engine.flatten_sequence(train(epg)),
                               opts["kgrid"], 4096, kv) is not None
    engine.clear_caches()
    a, want = _jax_and_port(train, **opts)
    with monkeypatch.context() as mp:
        mp.setattr(engine, "_dense_bound", lambda *a_, **k: None)
        engine.clear_caches()
        b = np.asarray(epg.simulate(train(epg), **opts))
    engine.clear_caches()
    assert np.abs(a - b).max() < TOL
    assert np.abs(a - want).max() < 1e-10


def test_dense_engine_gating(port_f64):
    """Ineligible trains stay on the table engines: a cap below the range
    (a trim is possible), no kgrid, batch-varying shifts (shared gate),
    n-D shifts, integer-only tables, an array kvalue -- the same answers
    as JAX's gates."""
    F = engine.flatten_sequence

    def cases(e):
        base = [e.T(90, 90), e.S(3.7), e.E(5, 1000, 80), e.ADC]
        return [
            (base, 0.5, 4096, 1.0), (base, 0.5, 4, 1.0),
            (base, None, 4096, 1.0),
            ([e.T(90, 90), e.S(np.array([[0.7], [1.3]])), e.ADC], 0.5, 4096,
             1.0),
            ([e.T(90, 90), e.S(np.array([[1.2, 0.7]])), e.ADC], 0.5, 4096,
             1.0),
            ([e.T(90, 90), e.S(np.array([[2]])), e.ADC], 0.5, 4096, 1.0),
            (base, 0.5, 4096, np.array([1.0, 2.0])),
        ]

    want = [True, False, False, False, False, False, False]
    for (seq, kg, cap, kv), (jseq, *_), w in zip(cases(epg), cases(jepg),
                                                 want):
        got = engine._dense_bound(F(seq), kg, cap, kv)
        assert (got is not None) == w
        assert got == jengine._dense_bound(jengine.flatten_sequence(jseq),
                                           kg, cap, kv)
    vary = [epg.T(90, 90), epg.S(np.array([[0.7], [1.3]])), epg.ADC]
    jvary = [jepg.T(90, 90), jepg.S(np.array([[0.7], [1.3]])), jepg.ADC]
    assert engine._dense_varying_bound(F(vary), 0.25, 4096, 1.0) == \
        jengine._dense_varying_bound(jengine.flatten_sequence(jvary), 0.25,
                                     4096, 1.0)


def test_capacity_matches_jax(port_f64):
    """The lattice bound in grid cells of |k| kvalue / kgrid, with the
    time axis scaled by tvalue."""
    def seqs(e):
        return [[e.S(0.5) for _ in range(20)],
                [e.S(np.array([[1, 2, -1]])), e.S(np.array([[0, 1, 1]]))],
                [e.C(2.0, 0.3), e.S(1), e.C(1.0)],
                [e.S(np.array([[0.7], [1.3]])) for _ in range(4)]]

    for s, js in zip(seqs(epg), seqs(jepg)):
        for kw in (dict(kgrid=0.1, kvalue=1.0), dict(kgrid=0.1, kvalue=-10.0),
                   dict(kgrid=0.05, tvalue=2.0), dict()):
            assert engine._capacity(s, 20, 4096, **kw) == \
                jengine._capacity(js, 20, 4096, **kw)


def test_dense_engine_disabled_for_asymmetric_ops(port_f64, monkeypatch):
    """A check=False op that breaks the ladder symmetry keeps a float
    train on the table engines; without it the dense engine runs."""
    calls = {"dense": 0}
    orig = shiftdense.shiftmerge_dense

    def counting(*a, **k):
        calls["dense"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(shiftdense, "shiftmerge_dense", counting)
    asym = epg.ScalarOp(np.array([0.5, 0.25, 1.0]), check=False)
    assert not asym.preserves_ladder_symmetry
    assert not (epg.T(10, 0) @ asym).preserves_ladder_symmetry
    seq = [epg.T(60, 30), epg.S(2.3), asym, epg.E(5.0, 1000, 80),
           epg.S(1.7), epg.ADC]
    engine.clear_caches()
    sig = np.asarray(epg.simulate(seq, kgrid=0.5, max_nstate=512))
    assert calls["dense"] == 0 and np.all(np.isfinite(sig))
    jasym = jepg.ScalarOp(np.array([0.5, 0.25, 1.0]), check=False)
    jseq = [jepg.T(60, 30), jepg.S(2.3), jasym, jepg.E(5.0, 1000, 80),
            jepg.S(1.7), jepg.ADC]
    want = np.asarray(jepg.simulate(jseq, kgrid=0.5, max_nstate=512))
    assert np.abs(sig - want).max() < 1e-10
    epg.simulate([epg.T(60, 30), epg.S(2.3), epg.E(5.0, 1000, 80),
                  epg.S(1.7), epg.ADC], kgrid=0.5, max_nstate=512)
    assert calls["dense"] > 0


def test_dense_engine_diffusion_coords(port_f64, monkeypatch):
    """The weighted-mean wavenumbers feed the diffusion b-factors alike
    through the dense and the table engine."""
    rng = np.random.default_rng(5)
    seq = [epg.T(90, 90)]
    for i in range(5):
        seq += [epg.S(float(rng.uniform(1, 6))), epg.D(5.0, 2e-3),
                epg.T(40, 0), epg.E(5.0, 1000.0, 80.0), epg.ADC]
    engine.clear_caches()
    a = np.asarray(epg.simulate(seq, kgrid=0.5, max_nstate=2048))
    with monkeypatch.context() as mp:
        mp.setattr(engine, "_dense_bound", lambda *a_, **k: None)
        engine.clear_caches()
        b = np.asarray(epg.simulate(seq, kgrid=0.5, max_nstate=2048))
    engine.clear_caches()
    assert np.abs(a - b).max() < TOL


def test_batched_diffusion_tensor(port_f64):
    """A (B, 3, 3) diffusion tensor takes the batch axis (append rule):
    atom b as the train with its own tensor alone."""
    rng = np.random.default_rng(8)
    Ds = np.stack([np.diag(rng.uniform(0.5e-3, 3e-3, 3)) for _ in range(3)])
    ks = [np.round(rng.uniform(-2, 2, size=(1, 3)), 2) for _ in range(3)]

    def train(Dt):
        seq = [epg.T(90, 90)]
        for k in ks:
            seq += [epg.S(k), epg.D(5.0, Dt, k=k), epg.T(40, 0), epg.ADC]
        return seq

    batched = np.asarray(epg.simulate(train(Ds), kgrid=1.0, max_nstate=64))
    assert batched.shape == (3, 3)
    for b in range(3):
        one = np.asarray(epg.simulate(train(Ds[b]), kgrid=1.0,
                                      max_nstate=64))
        assert np.abs(batched[:, b] - one[:, 0]).max() < 1e-10


# -- the planner --


@pytest.mark.parametrize("case", ["dense", "varying", "table3d", "time"])
def test_table_train_planned_equals_eager(port_f64, case):
    """A table train's planned program (stacked table shifts per slot,
    the table carried) gives the eager loop's values to the bit, and
    plans one periodic block."""
    rng = np.random.default_rng(2)
    T2 = np.linspace(40.0, 120.0, 4)
    seq = [epg.T(90, 90)]
    for i in range(6):
        if case == "dense":
            k = epg.S(float(rng.uniform(2, 10)))
        elif case == "varying":
            k = epg.S(rng.uniform(0.5, 3.0, size=(4, 1)))
        elif case == "table3d":
            k = epg.S(np.round(rng.uniform(-3, 3, size=(1, 3)), 2))
        else:
            k = epg.C(1.0 + 0.1 * i, 0.3)
        seq += [k, epg.T(40, 0), epg.E(5.0, 1000.0, T2), epg.ADC]
    kw = dict(kgrid=0.5, max_nstate=64)
    engine.clear_caches()
    planned = epg.simulate(seq, asarray=False, **kw)
    entry = engine._plan_and_payload(engine.flatten_sequence(seq))
    assert [k[0] for k in entry.kinds] == ["unroll", "scan"]
    sm = epg.StateMatrix(kgrid=0.5, max_nstate=64)
    vals, _ = epg.simulate_simple(sm.broadcast(engine.getshape(seq)), seq)
    eager = torch.stack([v[0] for v in vals])
    assert planned.shape == eager.shape
    assert torch.equal(planned, eager)


def test_kgrid_or_table_init_keeps_kernels_off(port_f64):
    """simulate(kgrid=) or a StateMatrix init holding a coordinate table
    keeps every kernel family off, even with fisp_kernel="force"."""
    from epgpy_torch import fisp_dispatch
    from torch_support import family_train

    seq = family_train(epg, "fisp")
    fisp_dispatch.DISPATCH_COUNTS.clear()
    ref = epg.simulate(seq, fisp_kernel=False)
    got = epg.simulate(seq, fisp_kernel="force", kgrid=0.5)
    init = epg.StateMatrix(nstate=4, kgrid=1.0).setup_coords(1)
    got2 = epg.simulate(seq, fisp_kernel="force", init=init)
    assert dict(fisp_dispatch.DISPATCH_COUNTS) == {}
    assert np.abs(got - ref).max() < 1e-10
    assert np.abs(got2 - ref).max() < 1e-10
    epg.simulate(seq, fisp_kernel="force")
    assert dict(fisp_dispatch.DISPATCH_COUNTS) == {"fisp": 1}
    fisp_dispatch.DISPATCH_COUNTS.clear()


_FAMILIES = ["fisp", "mse", "bssfp", "dess", "megre", "dw", "comp", "xgre",
             "xcomp"]


def _weighted(seq, e):
    """The train with every plain ADC replaced by a weighted one."""
    w = e.Adc(weights=[1.0], reduce=False)
    return [w if isinstance(op, e.Adc) else op for op in seq]


def _x_train(e, fam):
    khi = e.exchange_matrix(0.01, axis=-1, ncomp=2, densities=[0.8, 0.2])
    X = e.X(10.0, khi, axis=-1, T1=[1000.0, 800.0], T2=[80.0, 20.0])
    if fam == "xgre":
        return [op for i in range(6) for op in (e.T(20.0 + i, 0.0), e.ADC,
                                                X, e.S(1))]
    Xr = e.X(300.0, khi, axis=-1, T1=[1000.0, 800.0], T2=[80.0, 20.0])
    return [e.T(180.0, 0.0), Xr] + [op for i in range(6) for op in (
        e.T(20.0 + i, 0.0), X, e.ADC, X, e.S(1))] + [Xr]


@pytest.mark.parametrize("fam", _FAMILIES)
def test_weighted_adc_takes_general_path(port_f64, fam):
    """Every kernel family's matcher refuses a weighted ADC (JAX
    ``fisp_dispatch.py:446-451``): the train runs the general path, and
    the plain train still dispatches."""
    from epgpy_torch import fisp_dispatch
    from torch_support import family_train

    if fam in ("xgre", "xcomp"):
        seq = _x_train(epg, fam)
        kw = dict(max_nstate=6, density=[0.8, 0.2])
    else:
        seq = family_train(epg, fam)
        kw = dict(max_nstate=6)
    if fam in ("mse", "dw"):
        kw["kvalue"] = 1.0
    fisp_dispatch.clear_cache()
    fisp_dispatch.DISPATCH_COUNTS.clear()
    plain = epg.simulate(seq, fisp_kernel="force", **kw)
    assert sum(fisp_dispatch.DISPATCH_COUNTS.values()) == 1
    fisp_dispatch.DISPATCH_COUNTS.clear()
    got = epg.simulate(_weighted(seq, epg), fisp_kernel="force", **kw)
    assert dict(fisp_dispatch.DISPATCH_COUNTS) == {}
    # the kernels' twins compute in float32
    assert np.abs(got - plain).max() < 1e-6
    assert math.isfinite(float(np.abs(got).max()))
