"""Derivative specs, Jacobian probes and the Jacobian dispatch of
epgpy_torch vs epgpy_tpu.

* ``parse_order1``/``parse_order2`` normalize a table of specs as JAX's do
  (and reject the same invalid ones);
* ``match_fisp`` on order1/B1-tracked FISP trains returns the JAX
  matcher's dict, ``vars`` and ``b1_scale`` included, and
  ``match_jacobian_probes`` the JAX specs; aliased, chain-rule, order2
  and Hessian trains fall through with an INFO reason (a Hessian then
  comes from the general order-2 path, equal to JAX's at 1e-10);
* ``simulate(probe=[ADC, Jacobian(...)], fisp_kernel="force")`` (the
  kernel's plain twin, float32) equals the general path
  (``fisp_kernel=False``, forward-mode autodiff through the operator
  loop) and JAX's forced dispatch: signal atol 1e-5, Jacobian columns to
  1e-4 of the column's largest magnitude (float32, different operation
  order);
* the general path in float64 matches the reference goldens
  ``fuzz_diff.npz`` to 1e-8 (the JAX package's budget for it) and
  ``fuzz_hessian.npz`` (order 2) to 1e-10, and JAX's general diff path to
  1e-10;
* a JAX Jacobian match dict carried through ``convert.from_numpy_params``
  runs in the port's ``run_fisp_jacobian`` to JAX's result (float32, as
  above).
"""

import json
import logging
import os

import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import diff as tdiff
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch.convert import from_numpy_params
from epgpy_tpu import diff as jdiff
from epgpy_tpu import fisp_dispatch as jfd

from torch_support import GOLDEN_DIR, port_f32, port_f64  # noqa: F401

ORDER1_SPECS = [
    ("str", "T1", ("tau", "T1", "T2", "g")),
    ("list", ["T1", "T2"], ("tau", "T1", "T2", "g")),
    ("true", True, ("alpha", "phi")),
    ("alias", {"a0": "alpha"}, ("alpha", "phi")),
    ("coeffs", {"B1": {"alpha": 35.0}}, ("alpha", "phi")),
    ("empty", [], ("alpha",)),
    ("unknown", ["T3"], ("T1", "T2")),
    ("bad", 3.5, ("T1",)),
]


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("spec", ORDER1_SPECS, ids=lambda s: s[0])
def test_parse_order1_equals_jax(spec):
    _, o1, params = spec
    assert (_outcome(tdiff.parse_order1, o1, params)
            == _outcome(jdiff.parse_order1, o1, params))


ORDER2_SPECS = [
    ("true", True, {"T1": {"T1": 1.0}, "T2": {"T2": 1.0}}),
    ("str", "T1", {"T1": {"T1": 1.0}}),
    ("names", ["T1", "T2"], {"T1": {"T1": 1.0}, "T2": {"T2": 1.0}}),
    ("pairs", [("T2", "T1")], {"T1": {"T1": 1.0}}),
    ("curv", {("a", "a"): {"alpha": 2.0}}, {"a": {"alpha": 1.0}}),
    ("no_order1", True, {}),
    ("missing", [("x", "y")], {"T1": {"T1": 1.0}}),
]


@pytest.mark.parametrize("spec", ORDER2_SPECS, ids=lambda s: s[0])
def test_parse_order2_equals_jax(spec):
    _, o2, o1 = spec
    params = ("T1", "T2", "alpha")
    assert (_outcome(tdiff.parse_order2, o2, o1, params)
            == _outcome(jdiff.parse_order2, o2, o1, params))


def test_operator_specs_and_pairs():
    t = tepg.T(30.0, 90.0, order2="alpha")      # order2 str implies order1
    j = jepg.T(30.0, 90.0, order2="alpha")
    assert t.order1 == j.order1 and t.order2 == j.order2
    assert tdiff.Pair("b", "a") == jdiff.Pair("b", "a") == ("a", "b")
    assert tdiff.get_combinations(["y", "x"]) == jdiff.get_combinations(
        ["y", "x"])
    # R without a recovery term cannot track r0 (evolution.py:99-100)
    assert tepg.R(0.1, 0.2, order1=True).order1.keys() == {"rT", "rL"}
    assert set(tepg.R(0.1, 0.2, r0=0.2, order1=True).order1) == {
        "rT", "rL", "r0"}
    with pytest.raises(ValueError):
        tepg.R(0.1, 0.2, order1="r0")


def fisp_train(e, P=10, *, B=5, prep=False, b1=True, var_te=False, df=False,
               demod=False, e_spec=("T1", "T2"), t_spec=None, seed=0):
    """A FISP train in package `e` with order1 specs: E ops track
    `e_spec`, T ops track B1 with coefficient FA_i (or `t_spec`)."""
    rng = np.random.default_rng(seed)
    FA = 10 + 50 * np.abs(np.sin(np.arange(P) / 4.0)) + rng.uniform(0, 2, P)
    phi = rng.uniform(0, 180, P) if demod else np.full(P, 90.0)
    TEs = rng.uniform(2.0, 5.0, P) if var_te else np.full(P, 5.0)
    TRs = rng.uniform(11.0, 15.0, P)
    T1 = rng.uniform(300.0, 1500.0, B)
    T2 = rng.uniform(30.0, 110.0, B)
    B1 = rng.uniform(0.8, 1.2, B)
    g = rng.uniform(-0.04, 0.04, B) if df else 0.0

    def tspec(c):
        if t_spec is not None:
            return t_spec
        return {"B1": {"alpha": c}} if b1 else False

    o1 = list(e_spec) if isinstance(e_spec, tuple) else e_spec
    seq = []
    if prep:
        seq += [e.T(180.0 * B1, 0, order1=tspec(180.0)),
                e.E(20.0, T1, T2, g, order1=o1)]
    for i in range(P):
        adc = e.Adc(phase=-phi[i]) if demod else e.ADC
        seq += [e.T(FA[i] * B1, phi[i], order1=tspec(FA[i])),
                e.E(TEs[i], T1, T2, g, order1=o1), adc,
                e.E(TRs[i] - TEs[i], T1, T2, g, order1=o1), e.S(1)]
    return seq


TRAINS = {
    "b1": dict(),
    "inversion": dict(prep=True),
    "var_te_df_demod": dict(var_te=True, df=True, demod=True),
    "inversion_df_untracked_b1": dict(prep=True, df=True, b1=False),
    "t1_only": dict(e_spec=("T1",), b1=False),
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
def test_match_fisp_tracked_equals_jax(name):
    j = jfd.match_fisp(fisp_train(jepg, **TRAINS[name]))
    t = tfd.match_fisp(fisp_train(tepg, **TRAINS[name]))
    assert j is not None and t is not None
    _same_params(j, t)


PROBES = {
    "sig_jac": lambda e: [e.ADC, e.Jacobian(["magnitude", "T1", "T2"])],
    "jac_only": lambda e: [e.Jacobian(["B1", "T2"])],
    "untracked": lambda e: [e.ADC, e.Jacobian(["T1", "x"])],
    "no_jac": lambda e: [e.ADC],
    "phase_adc": lambda e: [e.Adc(phase=30.0), e.Jacobian(["T1"])],
    "z0": lambda e: [e.Jacobian(["T1"], probe="Z0")],
    "hessian": lambda e: [e.Hessian(["T1"])],
}


@pytest.mark.parametrize("name", PROBES)
def test_match_jacobian_probes_equals_jax(name):
    tracked = ("B1", "T1", "T2")
    assert (tfd.match_jacobian_probes(PROBES[name](tepg), tracked)
            == jfd.match_jacobian_probes(PROBES[name](jepg), tracked))


FALL_THROUGH = {
    "alias": (dict(e_spec={"x": "T1"}), "derivative spec"),
    "chain_rule": (dict(e_spec={"T1": {"T1": 2.0}}), "derivative spec"),
    "order2": ("order2", "derivative spec"),
    "b1_ratio": (dict(t_spec={"B1": {"alpha": 3.0}}), "one ratio"),
    "hessian": ("hessian", "probes are not"),
}


def _off_spec_train(e, kw):
    if kw == "order2":
        seq = fisp_train(e, P=4, b1=False)
        seq[1] = e.E(5.0, seq[1].T1, seq[1].T2, order1=["T1", "T2"],
                     order2=True)
        return seq
    return fisp_train(e, P=4, **({} if kw == "hessian" else kw))


@pytest.mark.parametrize("name", FALL_THROUGH)
def test_off_spec_trains_fall_through(port_f64, name, caplog):
    kw, reason = FALL_THROUGH[name]
    seq = _off_spec_train(tepg, kw)
    if kw == "hessian":
        probes = [tepg.Hessian(["T1"])]
    else:
        assert jfd.match_fisp(_off_spec_train(jepg, kw)) is None
        var = tdiff.tracked_variables(seq)[0]
        probes = [tepg.ADC, tepg.Jacobian([var])]
    tfd.clear_cache()
    before = tfd.DISPATCH_COUNTS.get("jac:fisp", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        out = tepg.simulate(seq, max_nstate=4, fisp_kernel="force",
                            probe=probes)
    if kw == "hessian":
        # the general order-2 path computes it: == JAX's general path
        want = jepg.simulate(_off_spec_train(jepg, kw), max_nstate=4,
                             fisp_kernel=False, probe=[jepg.Hessian(["T1"])])
        assert out.shape == np.shape(want) == (4, 5, 1, 1)
        assert np.abs(out - np.asarray(want)).max() < 1e-10
    else:
        assert out[1].shape == (4, 5, 1)
    assert tfd.DISPATCH_COUNTS.get("jac:fisp", 0) == before
    assert any(reason in r.getMessage() for r in caplog.records)


def _col_err(got, want):
    return max(np.abs(got[..., c] - want[..., c]).max()
               / np.abs(want[..., c]).max() for c in range(want.shape[-1]))


DISPATCH = ["b1", "inversion", "var_te_df_demod", "inversion_df_untracked_b1"]


@pytest.mark.parametrize("name", DISPATCH)
def test_jacobian_dispatch_equals_general_path_and_jax(port_f32, name):
    kw = TRAINS[name]
    names = ["magnitude", "T1", "T2"] + (["B1"] if kw.get("b1", True)
                                          else [])
    tseq = fisp_train(tepg, **kw)
    before = tfd.DISPATCH_COUNTS.get("jac:fisp", 0)
    fs, fj = tepg.simulate(tseq, max_nstate=8, fisp_kernel="force",
                           probe=[tepg.ADC, tepg.Jacobian(names)])
    assert tfd.DISPATCH_COUNTS.get("jac:fisp", 0) == before + 1
    ls, lj = tepg.simulate(tseq, max_nstate=8, fisp_kernel=False,
                           probe=[tepg.ADC, tepg.Jacobian(names)])
    assert tfd.DISPATCH_COUNTS.get("jac:fisp", 0) == before + 1
    js, jj = jepg.simulate(fisp_train(jepg, **kw), max_nstate=8,
                           fisp_kernel="force",
                           probe=[jepg.ADC, jepg.Jacobian(names)])
    js, jj = np.asarray(js), np.asarray(jj)
    assert fj.shape == lj.shape == jj.shape == (10, 5, len(names))
    assert fj.dtype == np.complex64
    assert np.abs(fs - ls).max() < 1e-5 and np.abs(fs - js).max() < 1e-5
    assert _col_err(fj, lj) < 1e-4 and _col_err(fj, jj) < 1e-4


def test_jacobian_dispatch_keeps_batch_shape_and_tensors(port_f32):
    """An (3, 4) T1 x T2 grid comes back (N, 3, 4[, k]); asarray=False
    returns tensors."""
    T1 = np.linspace(300.0, 1500.0, 3)
    T2 = np.linspace(30.0, 110.0, 4)[None, :]
    seq = []
    for i in range(6):
        seq += [tepg.T(20.0 + i, 90.0),
                tepg.E(5.0, T1, T2, order1=["T1", "T2"]), tepg.ADC,
                tepg.E(7.0, T1, T2, order1=["T1", "T2"]), tepg.S(1)]
    sig, jac = tepg.simulate(seq, max_nstate=6, fisp_kernel="force",
                             asarray=False,
                             probe=[tepg.ADC, tepg.Jacobian(["T2", "T1"])])
    gs, gj = tepg.simulate(seq, max_nstate=6, fisp_kernel=False,
                           probe=[tepg.ADC, tepg.Jacobian(["T2", "T1"])])
    assert tuple(sig.shape) == (6, 3, 4) and tuple(jac.shape) == (6, 3, 4, 2)
    assert _col_err(jac.numpy(), gj) < 1e-4


def test_auto_on_cpu_takes_the_general_diff_path(port_f32, caplog):
    seq = fisp_train(tepg, P=4)
    before = tfd.DISPATCH_COUNTS.get("jac:fisp", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch.engine"):
        jac = tepg.simulate(seq, max_nstate=4,
                            probe=tepg.Jacobian(["T1", "B1"]))
    assert tfd.DISPATCH_COUNTS.get("jac:fisp", 0) == before
    assert any("device is cpu" in r.getMessage() for r in caplog.records)
    assert jac.shape == (4, 5, 2)


_GD = np.load(os.path.join(GOLDEN_DIR, "fuzz_diff.npz"))
_DSPECS = json.loads(bytes(_GD["specs_json"]).decode())


def _diff_train(e, sp):
    seq = []
    for n in range(sp["ntr"]):
        if sp["alias"]:
            o1 = {f"a{n}": "alpha"} if n < 3 else False
        else:
            o1 = "alpha" if n < 3 else False
        seq += [e.T(sp["alphas"][n], sp["phi"], order1=o1),
                e.E(sp["taus"][n], sp["T1"], sp["T2"], order1=["T1", "T2"]),
                e.ADC, e.S(1)]
    return seq


@pytest.mark.parametrize("i", range(len(_DSPECS)))
def test_general_path_matches_fuzz_diff_golden(port_f64, i):
    """Random tracked trains (aliases, chain rules): the port's
    forward-mode Jacobian == the reference's chain rule at 1e-8."""
    sp = _DSPECS[i]
    jac = tepg.simulate(_diff_train(tepg, sp), max_nstate=6,
                        probe=tepg.Jacobian(sp["vars"]))
    ref = _GD[f"jac_re_{i:02d}"] + 1j * _GD[f"jac_im_{i:02d}"]
    assert jac.dtype == np.complex128
    assert np.abs(jac - ref).max() < 1e-8


_GH = np.load(os.path.join(GOLDEN_DIR, "fuzz_hessian.npz"))
_HSPECS = json.loads(bytes(_GH["specs_json"]).decode())


@pytest.mark.parametrize("i", range(len(_HSPECS)))
def test_general_path_matches_fuzz_hessian_golden(port_f64, i):
    """Random order2 trains (alpha aliases with curvature terms, T1/T2
    tracking): the port's restricted (magnitude, T1, T2) x (aliases + T1 +
    T2) Hessian (nested forward mode) == the reference's hand-derived
    second-order chain rule at 1e-10."""
    sp = _HSPECS[i]
    avars = [f"a{n}" for n in range(sp["ntr"])]
    cross = [(a, p) for a in avars for p in ("T1", "T2")]
    seq = []
    for n in range(sp["ntr"]):
        a = avars[n]
        seq += [tepg.T(sp["alphas"][n], sp["phi"], order1={a: "alpha"},
                       order2=[(a, "T1"), (a, "T2"), (a, a)]),
                tepg.E(sp["taus"][n], sp["T1"], sp["T2"],
                       order1=["T1", "T2"],
                       order2=[("T1", "T1"), ("T2", "T2"), ("T1", "T2")]
                       + cross),
                tepg.ADC, tepg.S(1)]
    _, hess = tepg.simulate(seq, max_nstate=6, probe=[
        tepg.Jacobian(["T1"]), tepg.Hessian(sp["vars1"], sp["vars2"])])
    ref = _GH[f"hes_re_{i:02d}"] + 1j * _GH[f"hes_im_{i:02d}"]
    assert hess.dtype == np.complex128 and hess.shape == ref.shape
    assert np.abs(hess - ref).max() < 1e-10


def test_general_path_equals_jax_and_chunks(port_f64):
    """A CPMG train tracking T2 and the refocusing flip (alias), with an R
    op tracking its rates: the port == JAX's general diff path at 1e-10,
    and jacobian_chunk=1 == all columns at once."""
    def seq(e):
        T2s = np.linspace(40.0, 90.0, 3)
        ops = [e.T(90, 90)]
        for n in range(6):
            ops += [e.E(4.5, 1400.0, T2s, order1="T2"), e.S(1),
                    e.T(150.0, 0.0, order1={"fa": "alpha"}),
                    e.E(4.5, 1400.0, T2s, order1="T2"), e.S(1),
                    e.R(0.01, 0.002, r0=0.002, order1={"r": "rL"}), e.ADC]
        return ops

    probes = lambda e: [e.ADC, e.Jacobian(["fa", "T2", "r",  # noqa: E731
                                           "magnitude"])]
    ts, tj = tepg.simulate(seq(tepg), probe=probes(tepg))
    js, jj = jepg.simulate(seq(jepg), probe=probes(jepg), fisp_kernel=False)
    assert tj.shape == np.shape(jj) == (6, 3, 4)
    assert np.abs(ts - np.asarray(js)).max() < 1e-10
    assert np.abs(tj - np.asarray(jj)).max() < 1e-10
    _, cj = tepg.simulate(seq(tepg), probe=probes(tepg), jacobian_chunk=1)
    assert np.abs(cj - tj).max() < 1e-14
    with pytest.raises(ValueError, match="not tracked"):
        tepg.simulate(seq(tepg), probe=tepg.Jacobian(["T1"]))


@pytest.mark.parametrize("name", ["b1", "inversion", "var_te_df_demod"])
def test_jax_jacobian_params_through_port_runner(port_f32, name):
    kw = TRAINS[name]
    names = ["magnitude", "T1", "T2", "B1"]
    jp = jfd.match_fisp(fisp_train(jepg, **kw))
    jprobes = (jepg.ADC, jepg.Jacobian(names))
    jspecs = jfd.match_jacobian_probes(jprobes, jp["vars"])
    want = jfd.run_fisp_jacobian(jp, 8, jspecs, interpret=True)
    tp = from_numpy_params(jp, "cpu")
    assert tp["vars"] == ("B1", "T1", "T2") and tp["b1_scale"] is not None
    tspecs = tfd.match_jacobian_probes((tepg.ADC, tepg.Jacobian(names)),
                                       tp["vars"])
    assert tspecs == jspecs
    got = tfd.run_fisp_jacobian(tp, 8, tspecs)
    for g, w in zip(got, want):
        w = np.asarray(w["__c_re"]) + 1j * np.asarray(w["__c_im"])
        assert g.shape == w.shape
    sig = np.asarray(want[0]["__c_re"]) + 1j * np.asarray(want[0]["__c_im"])
    jac = np.asarray(want[1]["__c_re"]) + 1j * np.asarray(want[1]["__c_im"])
    assert np.abs(got[0].numpy() - sig).max() < 1e-5
    assert _col_err(got[1].numpy(), jac) < 1e-4
