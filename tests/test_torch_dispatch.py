"""The FISP dispatch and the general engine of epgpy_torch vs epgpy_tpu.

* ``match_fisp`` returns the JAX matcher's dict (every key, the
  derivative keys ``vars``/``b1_scale``/``d_var``/``diffusion`` included)
  on equivalent sequences and None (with a logged reason) off-pattern;
* ``simulate(fisp_kernel="force")`` (the kernel's plain twin on the CPU,
  float32) equals the port's general path and JAX's forced dispatch to
  atol 1e-5 (float32 both, different operation order);
* the general path in float64 equals JAX ``simulate`` to 1e-10 and the
  reference goldens to 1e-10.
"""

import logging
import os

import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch.convert import from_numpy_params
from epgpy_tpu import fisp_dispatch as jfd

from torch_support import GOLDEN_DIR, port_f32, port_f64  # noqa: F401

KEYS = ("FA", "phi", "TR", "TE", "T1", "T2", "B1", "TI", "inv_df", "vars",
        "b1_scale", "d_var", "demod", "shape", "df", "diffusion")


def fisp_train(e, P=12, *, B=5, prep=False, var_te=False, demod=False,
               batch2d=False, df=False, extra=None, seed=0):
    """A FISP train in package `e` (epgpy_tpu or epgpy_torch)."""
    rng = np.random.default_rng(seed)
    FA = 10 + 50 * np.abs(np.sin(np.arange(P) / 4.0)) + rng.uniform(0, 2, P)
    phi = rng.uniform(0, 180, P) if demod else np.full(P, 90.0)
    TEs = rng.uniform(2.0, 5.0, P) if var_te else np.full(P, 5.0)
    TRs = rng.uniform(11.0, 15.0, P)
    if batch2d:
        T1 = np.linspace(300.0, 1500.0, 3)
        T2 = np.linspace(30.0, 110.0, 4)[None, :]
        B1 = 1.0
    else:
        T1 = rng.uniform(300.0, 1500.0, B)
        T2 = rng.uniform(30.0, 110.0, B)
        B1 = rng.uniform(0.8, 1.2, B)
    g = rng.uniform(-0.04, 0.04, B) if df else 0.0
    seq = []
    if prep:
        seq += [e.T(180.0 * B1, 0), e.E(20.0, T1, T2, g)]
    for i in range(P):
        adc = e.Adc(phase=-phi[i]) if demod else e.ADC
        seq += [e.T(FA[i] * B1, phi[i]), e.E(TEs[i], T1, T2, g), adc,
                e.E(TRs[i] - TEs[i], T1, T2, g), e.S(1)]
    if extra is not None:
        seq.insert(7, extra(e))
    return seq


TRAINS = {
    "b1": dict(),
    "inversion": dict(prep=True),
    "var_te": dict(var_te=True),
    "demod": dict(demod=True),
    "batch2d": dict(batch2d=True),
    "inversion_df": dict(prep=True, df=True, demod=True),
}


def _same_params(j, t):
    for k in KEYS:
        a, b = j[k], t[k]
        if a is None or b is None or isinstance(a, (bool, float, tuple)):
            assert a == b or (np.ndim(a) == 0 and np.ndim(b) == 0
                              and float(a) == float(b)), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


@pytest.mark.parametrize("name", TRAINS)
def test_match_fisp_equals_jax(name):
    j = jfd.match_fisp(fisp_train(jepg, **TRAINS[name]))
    t = tfd.match_fisp(fisp_train(tepg, **TRAINS[name]))
    assert j is not None and t is not None
    _same_params(j, t)


OFF_PATTERN = {
    "cpmg": lambda e: [e.T(90, 90)] + [e.E(4.5, 1400, 60.0), e.S(1),
                                       e.T(150, 0), e.E(4.5, 1400, 60.0),
                                       e.S(1), e.ADC] * 5,
    "extra_op": lambda e: fisp_train(e, extra=lambda m: m.T(5.0, 0.0)),
    "shift2": lambda e: [op if not isinstance(op, e.S) else e.S(2)
                         for op in fisp_train(e)],
    "t2_differs": lambda e: fisp_train(e, B=1)[:-5] + [
        e.T(20.0, 90.0), e.E(5.0, 900.0, 80.0), e.ADC,
        e.E(7.0, 900.0, 80.0), e.S(1)],
}


@pytest.mark.parametrize("name", OFF_PATTERN)
def test_off_pattern_trains_fall_through(name, caplog):
    assert jfd.match_fisp(OFF_PATTERN[name](jepg)) is None
    with caplog.at_level(logging.INFO, logger="epgpy_torch.fisp_dispatch"):
        assert tfd.match_fisp(OFF_PATTERN[name](tepg)) is None
    assert any("not a FISP train" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("name", ["b1", "inversion_df", "batch2d"])
def test_simulate_force_equals_op_loop_and_jax(port_f32, name):
    kw = TRAINS[name]
    tseq = fisp_train(tepg, **kw)
    before = tfd.DISPATCH_COUNTS.get("fisp", 0)
    forced = tepg.simulate(tseq, max_nstate=8, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("fisp", 0) == before + 1
    loop = tepg.simulate(tseq, max_nstate=8, fisp_kernel=False)
    assert tfd.DISPATCH_COUNTS.get("fisp", 0) == before + 1
    jax_forced = np.asarray(jepg.simulate(fisp_train(jepg, **kw),
                                          max_nstate=8, fisp_kernel="force"))
    assert forced.shape == loop.shape == jax_forced.shape
    assert forced.dtype == np.complex64
    assert np.abs(forced - loop).max() < 1e-5
    assert np.abs(forced - jax_forced).max() < 1e-5


def test_auto_on_cpu_takes_the_general_path(port_f32, caplog):
    seq = fisp_train(tepg)
    before = tfd.DISPATCH_COUNTS.get("fisp", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        t, sig = tepg.simulate(seq, max_nstate=8, adc_time=True)
    assert tfd.DISPATCH_COUNTS.get("fisp", 0) == before
    assert any("device is cpu" in r.getMessage() for r in caplog.records)
    assert sig.shape == (12, 5) and len(t) == 12


def test_shared_memory_gate_falls_through(port_f32, caplog):
    """A ladder too tall for one block's shared memory (no max_nstate on
    a 310-pulse train) takes the general path, with the reason logged."""
    seq = [tepg.T(30.0, 90.0), tepg.E(5.0, 900.0, 70.0), tepg.ADC,
           tepg.E(7.0, 900.0, 70.0), tepg.S(1)] * 310
    before = tfd.DISPATCH_COUNTS.get("fisp", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        out = tepg.simulate(seq, fisp_kernel="force", asarray=False)
    assert tfd.DISPATCH_COUNTS.get("fisp", 0) == before
    assert any("gate" in r.getMessage() for r in caplog.records)
    assert tuple(out.shape) == (310, 1)


@pytest.mark.parametrize("name", ["b1", "inversion_df", "var_te"])
def test_jax_params_through_port_runner(port_f32, name):
    jp = jfd.match_fisp(fisp_train(jepg, **TRAINS[name]))
    tp = from_numpy_params(jp, "cpu")
    got = tfd.run_fisp_kernel(tp, 8).numpy()
    want = jfd.run_fisp_kernel(jp, 8, interpret=True)
    want = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


def _cpmg(e):
    g = np.load(os.path.join(GOLDEN_DIR, "cpmg.npz"))
    T2s = list(g["T2s"])
    seq = [e.T(90, 90)] + [e.E(4.5, 1400, T2s), e.S(1), e.T(150, 0),
                           e.E(4.5, 1400, T2s), e.S(1), e.ADC] * 8
    return seq, {}, g["signal"]


def _spgr(e):
    n, TR, TE = 50, 10.0, 3.0
    phases = np.cumsum(np.arange(n) * 117.0)
    seq = []
    for i in range(n):
        seq += [e.T(15, phases[i] % 360), e.E(TE, 1000, 80),
                e.Adc(phase=-(phases[i] % 360)), e.E(TR - TE, 1000, 80),
                e.S(1)]
    return (seq, {"max_nstate": 20},
            np.load(os.path.join(GOLDEN_DIR, "spgr.npz"))["signal"])


def _fisp_extra(e):
    return (fisp_train(e, extra=lambda m: m.T(5.0, 0.0)),
            {"max_nstate": 8}, None)


@pytest.mark.parametrize("build", [_cpmg, _spgr, _fisp_extra],
                         ids=["cpmg", "spgr", "fisp_extra_op"])
def test_general_path_equals_jax_and_golden(port_f64, build):
    tseq, kw, golden = build(tepg)
    jseq, _, _ = build(jepg)
    got = tepg.simulate(tseq, **kw)
    want = np.asarray(jepg.simulate(jseq, fisp_kernel=False, **kw))
    assert got.dtype == np.complex128 and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-10
    if golden is not None:
        assert np.abs(got - golden).max() < 1e-10
    values, times = tepg.simulate_simple(
        tepg.StateMatrix(), tseq, max_nstate=kw.get("max_nstate"))
    assert len(values) == len(times) == got.shape[0]


# -- the per-sequence preamble memo (epgpy_tpu/engine.py:293-338) --


@pytest.fixture
def counted_preamble(monkeypatch):
    """Counts the engine's getnshift/getshape sweeps; the memo starts
    empty."""
    from epgpy_torch import engine

    calls = {"getnshift": 0, "getshape": 0}
    for name in calls:
        fn = getattr(engine, name)

        def wrapped(seq, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(seq)

        monkeypatch.setattr(engine, name, wrapped)
    engine.clear_caches()
    yield calls
    engine.clear_caches()


def test_preamble_memo_skips_the_sweeps(port_f32, counted_preamble):
    seq = fisp_train(tepg, P=4)
    a = tepg.simulate(seq, fisp_kernel=False)
    assert counted_preamble == {"getnshift": 1, "getshape": 1}
    b = tepg.simulate(seq, fisp_kernel=False)
    assert counted_preamble == {"getnshift": 1, "getshape": 1}
    assert np.array_equal(a, b)
    # the same operators in a new list hit; another list misses
    tepg.simulate(list(seq), fisp_kernel=False)
    assert counted_preamble["getshape"] == 1
    tepg.simulate(seq[:-5], fisp_kernel=False)
    assert counted_preamble["getshape"] == 2


def test_preamble_memo_keys_max_nstate_and_kvalue(port_f32,
                                                  counted_preamble):
    seq = fisp_train(tepg, P=4)
    tepg.simulate(seq, fisp_kernel=False)
    tepg.simulate(seq, fisp_kernel=False, max_nstate=2)
    assert counted_preamble["getnshift"] == 2
    tepg.simulate(seq, fisp_kernel=False, max_nstate=2, kvalue=3.0)
    assert counted_preamble["getnshift"] == 3
    tepg.simulate(seq, fisp_kernel=False, max_nstate=2, kvalue=3.0)
    assert counted_preamble["getnshift"] == 3


def test_preamble_memo_evicts_oldest_and_clears(port_f32, counted_preamble):
    from epgpy_torch import engine

    seq = fisp_train(tepg, P=3)
    for n in range(engine._PREAMBLE_CACHE_MAX + 1):
        tepg.simulate(seq, fisp_kernel=False, max_nstate=n + 1)
    assert len(engine._PREAMBLE_CACHE) == engine._PREAMBLE_CACHE_MAX
    assert counted_preamble["getshape"] == engine._PREAMBLE_CACHE_MAX + 1
    # the newest entry is kept, the oldest (max_nstate 1) evicted
    tepg.simulate(seq, fisp_kernel=False,
                  max_nstate=engine._PREAMBLE_CACHE_MAX + 1)
    assert counted_preamble["getshape"] == engine._PREAMBLE_CACHE_MAX + 1
    tepg.simulate(seq, fisp_kernel=False, max_nstate=1)
    assert counted_preamble["getshape"] == engine._PREAMBLE_CACHE_MAX + 2
    # an entry pins its operator list
    assert all(list(map(id, entry[1])) == list(map(id, seq))
               for entry in engine._PREAMBLE_CACHE.values())
    tepg.simulate(seq, fisp_kernel="force")
    assert tfd._MATCH_CACHE
    engine.clear_caches()
    assert not engine._PREAMBLE_CACHE and not tfd._MATCH_CACHE
