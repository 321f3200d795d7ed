"""epgpy_torch operators and StateMatrix vs their epgpy_tpu counterparts.

Random conjugate-symmetric states (numpy, seeded) go through both
packages' operators in float64; the results agree to atol 1e-12 (both
compute in float64 with a different operation order).
"""

import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch.ops import transition as ttr
from epgpy_tpu.ops import transition as jtr

from torch_support import port_f64, random_ladder  # noqa: F401

ATOL = 1e-12


def _pair(states):
    return jepg.StateMatrix(states), tepg.StateMatrix(states)


def _close(jsm, tsm):
    j = np.asarray(jsm.states)
    t = tsm.states.numpy()
    assert j.shape == t.shape
    assert np.abs(j - t).max() < ATOL


@pytest.mark.parametrize("alpha, phi", [
    (35.0, 20.0),
    (np.linspace(10, 170, 5), 90.0),
    (np.linspace(10, 170, 4), np.linspace(-40, 200, 4)),
    (np.linspace(10, 90, 3)[:, None], np.linspace(0, 180, 2)[None, :]),
])
def test_rotation_operator(port_f64, alpha, phi):
    j = np.asarray(jtr.rotation_operator(alpha, phi))
    t = ttr.rotation_operator(alpha, phi).numpy()
    assert j.shape == t.shape
    assert np.abs(j - t).max() < ATOL
    je = [np.asarray(x) for x in jtr.rotation_elements(alpha, phi)]
    te = [x.numpy() for x in ttr.rotation_elements(alpha, phi)]
    for a, b in zip(je, te):
        assert np.abs(a - b).max() < ATOL


def test_apply_matrices_equals_T(port_f64):
    """The generic per-batch 3x3 apply with the Weigel matrix == T, and
    == the JAX MatrixOp application."""
    from epgpy_torch.ops.matrixop import apply_matrices
    from epgpy_tpu.ops.matrixop import apply_matrices as japply

    alpha, phi = np.linspace(10, 170, 4), np.linspace(0, 90, 4)
    states = random_ladder(np.random.default_rng(7), (4,), 3)
    jsm, tsm = _pair(states)
    got = apply_matrices(tsm, ttr.rotation_operator(alpha, phi))
    assert np.abs(got.states.numpy()
                  - tepg.T(alpha, phi)(tsm).states.numpy()).max() < ATOL
    _close(japply(jsm, jtr.rotation_operator(alpha, phi), None), got)


@pytest.mark.parametrize("batch, alpha, phi", [
    ((1,), 47.0, 33.0),
    ((4,), np.linspace(10, 170, 4), 90.0),
    ((3, 2), np.linspace(20, 60, 3), np.asarray([[0.0, 45.0]])),
])
def test_T(port_f64, batch, alpha, phi):
    states = random_ladder(np.random.default_rng(1), batch, 4)
    jsm, tsm = _pair(states)
    _close(jepg.T(alpha, phi)(jsm), tepg.T(alpha, phi)(tsm))
    _close(jepg.Tx(alpha)(jsm), tepg.Tx(alpha)(tsm))
    _close(jepg.Ty(alpha)(jsm), tepg.Ty(alpha)(tsm))
    _close(jepg.Phi(phi)(jsm), tepg.Phi(phi)(tsm))


@pytest.mark.parametrize("T1, T2, g", [
    (900.0, 70.0, 0.0),
    (np.linspace(300, 1500, 4), np.linspace(30, 120, 4), 0.03),
    (1200.0, np.linspace(30, 120, 4), np.linspace(-0.05, 0.05, 4)),
])
def test_E_and_P(port_f64, T1, T2, g):
    states = random_ladder(np.random.default_rng(2), (4,), 3)
    jsm, tsm = _pair(states)
    _close(jepg.E(4.5, T1, T2, g)(jsm), tepg.E(4.5, T1, T2, g)(tsm))
    _close(jepg.E(4.5, T1, T2, g=g)(jepg.E(2.0, T1, T2)(jsm)),
           tepg.E(4.5, T1, T2, g=g)(tepg.E(2.0, T1, T2)(tsm)))
    _close(jepg.P(3.0, g)(jsm), tepg.P(3.0, g)(tsm))


@pytest.mark.parametrize("k", [1, -1, 2])
def test_S(port_f64, k):
    states = random_ladder(np.random.default_rng(3), (3,), 4)
    jsm, tsm = _pair(states)
    j, t = jepg.S(k)(jsm), tepg.S(k)(tsm)
    _close(j, t)
    assert t.check()
    assert tepg.S(k).nshift == abs(k)


def _table_rows(states, coords):
    """The occupied rows of a coordinate table, (coords, states) sorted by
    coordinates: the row order of a table is internal state (JAX's matmul
    engine keeps key order, the sort engine magnitude order)."""
    states, coords = np.asarray(states), np.asarray(coords, dtype=float)
    states = states.reshape(-1, *states.shape[-2:])
    coords = np.broadcast_to(coords, states.shape[:-1] + coords.shape[-1:])
    out = []
    for s, c in zip(states, coords):
        keep = np.abs(s).sum(-1) > 0
        order = np.lexsort(np.round(c[keep], 9).T[::-1])
        out.append((c[keep][order], s[keep][order]))
    return out


@pytest.mark.parametrize("make", [
    lambda e: e.S(0.5, kgrid=0.25),
    lambda e: e.S(np.array([[1.3, -0.4]]), kgrid=0.5),
    lambda e: e.S(np.array([[1, 2, -1]])),
    lambda e: e.G(1.0, [10.0, 0.0, 5.0], kgrid=50.0),
    lambda e: e.C(2.0, 0.3, kgrid=0.1),
])
def test_S_table_shifts(port_f64, make):
    """A float, vector, gradient (G) or time (C) shift on a ladder with no
    table attaches one and merges, as in JAX (compared row set by row
    set); a second shift merges on the table."""
    states = random_ladder(np.random.default_rng(3), (3,), 4)
    jsm, tsm = _pair(states)
    jop, top = make(jepg), make(tepg)
    assert top.kdim == jop.kdim and top.shape == jop.shape
    j = jop(jepg.T(40.0, 10.0)(jop(jsm)))
    t = top(tepg.T(40.0, 10.0)(top(tsm)))
    assert t.kdim == j.kdim and t.coords.shape == j.coords.shape
    for (jc, js), (tc, ts) in zip(_table_rows(j.states, j.coords),
                                  _table_rows(t.states.numpy(),
                                              t.coords.numpy())):
        assert jc.shape == tc.shape
        assert np.abs(jc - tc).max() < 1e-9
        assert np.abs(js - ts).max() < ATOL
    assert np.abs(np.asarray(j.F0) - t.F0.numpy()).max() < ATOL
    assert t.check()


@pytest.mark.parametrize("attr, phase", [
    ("F0", None), ("F0", 37.0), ("Z0", None), ("F0", [10.0, 20.0, 30.0])])
def test_adc(port_f64, attr, phase):
    states = random_ladder(np.random.default_rng(4), (3,), 2)
    jsm, tsm = _pair(states)
    jadc = jepg.Adc(attr, phase=phase)
    tadc = tepg.Adc(attr, phase=phase)
    j = np.asarray(jadc.acquire(jsm))
    t = tadc.acquire(tsm).numpy()
    assert j.shape == t.shape
    assert np.abs(j - t).max() < ATOL


def test_statematrix(port_f64):
    rng = np.random.default_rng(5)
    states = random_ladder(rng, (2, 3), 3)
    jsm, tsm = _pair(states)
    _close(jsm, tsm)
    assert tsm.shape == tuple(jsm.shape) and tsm.nstate == jsm.nstate
    for attr in ("F0", "Z0", "F", "Z"):
        assert np.abs(np.asarray(getattr(jsm, attr))
                      - getattr(tsm, attr).numpy()).max() < ATOL
    _close(jsm.resize(5), tsm.resize(5))
    _close(jsm.resize(2), tsm.resize(2))
    assert tsm.check() and tsm.resize(6).check()
    j1, t1 = jepg.StateMatrix(nstate=2), tepg.StateMatrix(nstate=2)
    _close(j1, t1)
    _close(j1.broadcast((4,)), t1.broadcast((4,)))
    jd = jepg.StateMatrix(density=[0.5, 2.0], nstate=1)
    td = tepg.StateMatrix(density=[0.5, 2.0], nstate=1)
    _close(jd, td)
    assert np.abs(np.asarray(jd.equilibrium)
                  - td.equilibrium.numpy()).max() < ATOL
    bad = states.copy()
    bad[..., 0, 0] += 1j
    with pytest.raises(ValueError, match="F-state"):
        tepg.StateMatrix(bad)


def test_convert_states(port_f64):
    from epgpy_torch.convert import from_numpy_states

    states = random_ladder(np.random.default_rng(6), (5,), 3)
    jsm = jepg.T(30, 10)(jepg.StateMatrix(states))
    tsm = from_numpy_states(np.asarray(jsm.states))
    _close(jsm, tsm)


def _modified_pair(mod_kw, expand=True):
    seq = [None, None]
    for i, e in enumerate((jepg, tepg)):
        base = [e.T(90, 90)] + [e.S(1, duration=4.5), e.T(150, 0),
                                e.S(1, duration=4.5), e.ADC] * 6
        seq[i] = e.modify(base, expand=expand, **mod_kw)
    return seq


@pytest.mark.parametrize("mod_kw", [
    dict(T1=1400.0, T2=np.linspace(20, 100, 5)),
    dict(T1=np.linspace(500, 1500, 3), T2=80.0, att=0.9),
    dict(g=0.02),
    dict(T2=[40.0, 60.0], att=np.asarray([0.8, 1.0, 1.1])[None]),
])
def test_modify(port_f64, mod_kw):
    jseq, tseq = _modified_pair(mod_kw)
    j = np.asarray(jepg.simulate(jseq))
    t = tepg.simulate(tseq)
    assert j.shape == t.shape
    assert np.abs(j - t).max() < ATOL
    assert np.allclose(jepg.get_adc_times(jseq), tepg.get_adc_times(tseq))
