"""The port's operator core against the JAX package's, in float64.

ScalarOp, MatrixOp, CombinedOp (``combine``, ``@``), the utility operators
(SPOILER, RESET, PD, System, Offset, NULL), expression probes, the
StateMatrix's options, ``stack``/``unstack`` and the helpers: the same
numpy inputs (made from a seed) through both packages, to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg

from torch_support import port_f64, random_ladder  # noqa: F401

TOL = 1e-12


def _pair(states):
    return jepg.StateMatrix(states), tepg.StateMatrix(states)


def _close(jsm, tsm):
    j, t = np.asarray(jsm.states), tsm.states.numpy()
    assert j.shape == t.shape
    assert np.abs(j - t).max() < TOL


def _sym_triplet(rng, shape):
    """Random (*shape, 3) coefficients with arr == conj(arr[(1, 0, 2)])."""
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    z = rng.normal(size=shape)
    return np.stack([a, np.conj(a), z + 0j], axis=-1)


def _sym_matrix(rng, shape):
    """Random (*shape, 3, 3) matrices with the ladder symmetry."""
    m = rng.normal(size=shape + (3, 3)) + 1j * rng.normal(size=shape
                                                           + (3, 3))
    perm = (1, 0, 2)
    return 0.5 * (m + np.conj(m[..., perm, :][..., :, perm]))


def _ops(e, rng_seed, kind):
    """One operator of `kind` in package `e` from a seeded draw."""
    rng = np.random.default_rng(rng_seed)
    if kind == "scalar":
        return e.ScalarOp(_sym_triplet(rng, (4,)), _sym_triplet(rng, (4,)))
    if kind == "matrix":
        return e.MatrixOp(_sym_matrix(rng, (4,)), _sym_matrix(rng, (1,)))
    if kind == "E":
        return e.E(5.0, 800.0, [40.0, 60.0, 80.0, 100.0], g=0.05)
    if kind == "P":
        return e.P(3.0, [0.01, 0.02, 0.03, 0.04])
    if kind == "R":
        return e.R(0.1 + 0.2j, 0.05, r0=0.05)
    if kind == "T":
        return e.T(np.linspace(20, 160, 4), 35.0)
    if kind == "Phi":
        return e.Phi(np.linspace(0, 90, 4))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["scalar", "matrix"])
def test_user_ops_match_jax(port_f64, kind):
    states = random_ladder(np.random.default_rng(3), (4,), 3)
    jsm, tsm = _pair(states)
    _close(_ops(jepg, 1, kind)(jsm), _ops(tepg, 1, kind)(tsm))


@pytest.mark.parametrize("chain", [
    ("E", "T"), ("E", "P"), ("scalar", "E", "R"), ("T", "matrix", "Phi"),
    ("Phi", "E"), ("R", "T", "E", "scalar"),
])
def test_combine_matches_jax_and_sequential(port_f64, chain):
    """``a @ b @ ...`` and ``combine(a, b, ...)`` apply a, then b, ...:
    equal to the sequential application and to JAX's CombinedOp."""
    states = random_ladder(np.random.default_rng(5), (4,), 3)
    jsm, tsm = _pair(states)
    tops = [_ops(tepg, i, k) for i, k in enumerate(chain)]
    jops = [_ops(jepg, i, k) for i, k in enumerate(chain)]
    comb = tepg.combine(*tops)
    assert isinstance(comb, tepg.CombinedOp)
    matmul = tops[0]
    for op in tops[1:]:
        matmul = matmul @ op
    seq_sm = tsm
    for op in tops:
        seq_sm = op(seq_sm)
    _close(jepg.combine(*jops)(jsm), comb(tsm))
    _close(jepg.combine(*jops)(jsm), matmul(tsm))
    assert np.abs(comb(tsm).states.numpy()
                  - seq_sm.states.numpy()).max() < TOL
    assert comb.diagonal == jepg.combine(*jops).diagonal


def test_combine_duration_and_name_overrides(port_f64):
    """tests/test_ops_core.py:30"""
    c = tepg.E(np.array([1.0, 2.0, 3.0]), 800, 80, duration=True) \
        @ tepg.E(5, 500, 50)
    assert np.asarray(c.duration).shape == (3,)
    e1 = tepg.E(5, 800, 80)
    assert tepg.combine(e1, name="foo").name == "foo"
    assert float(tepg.combine(e1, duration=2.5).duration) == 2.5
    assert tepg.combine(e1, e1, name="bar").name == "bar"
    assert float(tepg.combine(e1, e1, duration=7.0).duration) == 7.0


@pytest.mark.parametrize("op", ["SPOILER", "RESET", "PD", "PD_keep",
                                "NULL", "Offset"])
def test_utility_ops_match_jax(port_f64, op):
    states = random_ladder(np.random.default_rng(9), (3,), 2)

    def build(e):
        return {"SPOILER": e.SPOILER, "RESET": e.RESET,
                "PD": e.PD([0.5, 0.7, 0.9]),
                "PD_keep": e.PD([0.5, 0.7, 0.9], reset=False),
                "NULL": e.NULL, "Offset": e.Offset(-2.0)}[op]

    # device states: JAX's Spoiler indexes with .at (no host arrays)
    jsm = jepg.StateMatrix(jnp.asarray(states), density=[1.0, 0.8, 0.6])
    tsm = tepg.StateMatrix(states, density=[1.0, 0.8, 0.6])
    jo, to = build(jepg)(jsm), build(tepg)(tsm)
    _close(jo, to)
    assert np.abs(np.asarray(jo.equilibrium)
                  - to.equilibrium.numpy()).max() < TOL


def test_reset_grows_to_equilibrium_batch(port_f64):
    """PD(batch, reset=False) then RESET: the states grow to the wider
    equilibrium (tests/test_ops_core.py:39)."""
    pd = np.array([0.5, 0.8, 1.0])

    def train(e):
        return [e.T(90, 90), e.PD(pd, reset=False), e.RESET,
                e.E(5.0, 800.0, 80.0), e.T(30, 0), e.ADC]

    out = tepg.simulate(train(tepg))
    want = np.asarray(jepg.simulate(train(jepg)))
    assert out.shape == want.shape == (1, 3)
    assert np.abs(out - want).max() < TOL
    ratio = np.abs(out[0]) / np.abs(out[0, -1])
    assert np.allclose(ratio, pd / pd[-1], atol=1e-10)


def test_system_kvalue_and_probe_k(port_f64):
    """System sets kvalue mid-sequence; the "k" probe reads it
    (tests/test_engine.py:446)."""
    seq = [tepg.System(kvalue=123.0), tepg.T(90, 90), tepg.S(1),
           tepg.Probe("k")]
    k = tepg.simulate(seq)
    assert np.allclose(np.asarray(k)[0, ..., 0], 123.0 * np.arange(-1, 2))
    sm = tepg.System(coords=[1.0, 2.0])(tepg.StateMatrix())
    assert list(sm.system) == ["coords"]


@pytest.mark.parametrize("probe, want", [
    ("Z0", 0.0), ("F0", 1.0), (["F0", "Z0"], None),
    ("(real(F0), imag(F0))", None), ("abs(F0) ** 2", 1.0),
])
def test_expression_probes_match_jax(port_f64, probe, want):
    def train(e):
        return [e.T(90, 90), e.ADC, e.T(30, 0), e.ADC]

    got = tepg.simulate(train(tepg), probe=probe)
    ref = jepg.simulate(train(jepg), probe=probe)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert np.shape(g) == np.shape(r)
        assert np.abs(g - np.asarray(r)).max() < TOL
    if want is not None:
        assert np.allclose(got[0][0], want)


def test_adc_attr_and_phase(port_f64):
    seq = [tepg.T(90, 0), tepg.Adc(phase=90), tepg.Adc("Z0")]
    out = tepg.simulate(seq)
    assert np.allclose(out, [[1.0], [0.0]])
    # weighted and reduced readouts, DFT and Imaging probes, against JAX
    pos = np.array([[0.0], [0.004], [-0.01]])

    def train(e):
        return [e.T(np.array([60.0, 90.0]), 90), e.S(1, duration=1.0),
                e.T(30, 0), e.S(1, duration=1.0),
                e.Adc(weights=[0.25, 0.75]), e.Adc(weights=[[1.0, 2.0]],
                                                   reduce=1),
                e.Adc("Z0", reduce=True), e.DFT(pos),
                e.Imaging(pos, voxel_size=2e-3, reduce=False)]

    got = tepg.simulate(train(tepg), kvalue=300.0, probe=[
        tepg.Adc(weights=[0.25, 0.75]), tepg.DFT(pos),
        tepg.Imaging(pos, voxel_size=2e-3, reduce=(0, 1))])
    want = jepg.simulate(train(jepg), kvalue=300.0, probe=[
        jepg.Adc(weights=[0.25, 0.75]), jepg.DFT(pos),
        jepg.Imaging(pos, voxel_size=2e-3, reduce=(0, 1))])
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w)
        assert np.abs(g - np.asarray(w)).max() < TOL
    with pytest.raises(ValueError, match="reduce"):
        tepg.Adc(weights=[0.5, 0.5], reduce=3)


def test_scalarop_darrs_jacobian_matches_jax(port_f64):
    """A ScalarOp with custom derivative arrays tracked through order1:
    the general diff path's Jacobian against JAX's."""
    rng = np.random.default_rng(11)
    arr, darr = _sym_triplet(rng, (2,)), _sym_triplet(rng, (2,))

    def train(e):
        op = e.ScalarOp(arr, darrs={"x": darr}, order1="x")
        return [e.T(60, 90), op, e.S(1), e.T(40, 0), e.S(-1), e.ADC]

    tsig, tjac = tepg.simulate(train(tepg),
                               probe=[tepg.ADC, tepg.Jacobian(["x"])])
    jsig, jjac = jepg.simulate(train(jepg),
                               probe=[jepg.ADC, jepg.Jacobian(["x"])])
    assert np.abs(tsig - np.asarray(jsig)).max() < TOL
    assert np.abs(tjac - np.asarray(jjac)).max() < TOL
    assert np.abs(tjac).max() > 0


def test_scalar_and_matrix_checks():
    with pytest.raises(ValueError, match="symmetry"):
        tepg.ScalarOp([1.0, 2.0, 1.0])
    with pytest.raises(ValueError, match="symmetry"):
        tepg.MatrixOp(np.arange(9.0).reshape(3, 3))
    op = tepg.ScalarOp([1.0, 2.0, 1.0], check=False)
    assert op.shape == (1,)


def test_statematrix_options_match_jax(port_f64):
    """equilibrium=, shape=, nstate=, check=, system=, tvalue= and the
    options dict, stack/unstack and check(), as in JAX."""
    eq = np.array([[0, 0, 0.5]])
    kw = dict(equilibrium=eq, shape=(3,), nstate=2, tvalue=2.0,
              system={"a": 1}, foo="bar")
    j, t = jepg.StateMatrix(**kw), tepg.StateMatrix(**kw)
    _close(j, t)
    assert t.shape == j.shape == (3,) and t.nstate == 2
    assert t.options["foo"] == "bar" and t.system == {"a": 1}
    assert t.tvalue == 2.0 and t.check()
    bad = np.array([[1.0, 2.0, 0.0]])
    with pytest.raises(ValueError):
        tepg.StateMatrix(bad)
    tepg.StateMatrix(bad, check=False)
    states = random_ladder(np.random.default_rng(2), (2,), 1)
    jsm, tsm = _pair(states)
    jst, tst = jsm.stack([jsm]), tsm.stack([tsm])
    _close(jst, tst)
    assert [s.shape for s in tst.unstack()] == [(2,), (2,)]
    for a, b in zip(jst.unstack(axis=1), tst.unstack(axis=1)):
        _close(a, b)


def test_statematrix_init_merges_options(port_f64):
    """A StateMatrix init's options merge under simulate()'s, its
    max_nstate caps the ladder (JAX engine.py:948-970)."""
    seq = [tepg.T(90, 90)] + [tepg.S(1), tepg.T(150, 0), tepg.S(1),
                              tepg.ADC] * 4
    init = tepg.StateMatrix(max_nstate=2)
    capped = tepg.simulate(seq, init=init)
    assert np.abs(capped - tepg.simulate(seq, max_nstate=2,
                                         fisp_kernel=False)).max() < TOL
    jinit = jepg.StateMatrix(max_nstate=2)
    jseq = [jepg.T(90, 90)] + [jepg.S(1), jepg.T(150, 0), jepg.S(1),
                               jepg.ADC] * 4
    assert np.abs(capped - np.asarray(jepg.simulate(jseq, init=jinit))
                  ).max() < TOL


def test_unknown_option_is_logged(port_f64, caplog):
    import logging

    with caplog.at_level(logging.WARNING, logger="epgpy_torch.engine"):
        tepg.simulate([tepg.T(90, 90), tepg.ADC], frobnicate=1)
    assert "frobnicate" in caplog.text
    # kgrid, prune and coords are known options: a float-shift train
    # through them against JAX
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="epgpy_torch.engine"):
        got = tepg.simulate([tepg.T(90, 90), tepg.S(0.35), tepg.T(60, 0),
                             tepg.S(0.35), tepg.ADC], kgrid=0.1, prune=1e-6)
    assert "unrecognized" not in caplog.text
    want = jepg.simulate([jepg.T(90, 90), jepg.S(0.35), jepg.T(60, 0),
                          jepg.S(0.35), jepg.ADC], kgrid=0.1, prune=1e-6)
    assert np.abs(got - np.asarray(want)).max() < TOL
    coords = np.arange(-4, 5, dtype=float)[:, None]    # the 9-row ladder
    got = tepg.simulate([tepg.T(90, 90), tepg.S(1), tepg.T(50, 0),
                         tepg.S(0.5), tepg.ADC], coords=coords,
                        kgrid=0.5)
    want = jepg.simulate([jepg.T(90, 90), jepg.S(1), jepg.T(50, 0),
                          jepg.S(0.5), jepg.ADC], coords=coords,
                         kgrid=0.5)
    assert np.abs(got - np.asarray(want)).max() < TOL


def test_helpers_match_jax(port_f64):
    from epgpy_tpu.utils import helpers as jh
    from epgpy_torch.utils import helpers as th

    x = np.linspace(-2, 2, 7)
    assert np.abs(th.cexp(x).numpy() - np.asarray(jh.cexp(x))).max() < TOL
    states = random_ladder(np.random.default_rng(4), (2,), 2)
    assert np.abs(th.get_norm(states).numpy()
                  - np.asarray(jh.get_norm(states))).max() < TOL
    for name in ("get_wavenumber", "space_to_freq", "freq_to_space"):
        assert np.allclose(getattr(th, name)(10.0, x),
                           getattr(jh, name)(10.0, x), rtol=1e-14)
    assert np.allclose(th.spatial_range(4.0, 5), jh.spatial_range(4.0, 5))
    ax = th.Axes("T1", "T2")
    assert ax.T2 == 1
    assert list(th.progressbar(range(3), out=open("/dev/null", "w"))) == \
        [0, 1, 2]


def test_flat_namespace():
    from epgpy_torch import epg

    for name in ("SPOILER", "RESET", "PD", "System", "Offset", "NULL",
                 "ScalarOp", "MatrixOp", "CombinedOp", "combine",
                 "PrecomputedDiagonal", "squeeze_sequence", "getkdim",
                 "Pair", "check_states", "NAX", "cexp", "progressbar",
                 "simulate", "StateMatrix", "Jacobian", "crlb"):
        assert hasattr(tepg, name) or name == "crlb", name
        assert hasattr(epg, name), name
    assert tepg.check_states(random_ladder(np.random.default_rng(1), (2,), 2))
    assert tepg.getkdim([tepg.T(90, 90), tepg.S(1)]) == 1
    assert tepg.Pair("b", "a") == ("a", "b")
