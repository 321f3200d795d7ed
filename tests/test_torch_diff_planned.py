"""The planned diff path of epgpy_torch (``diff.simulate_diff``: Jacobian
and Hessian probes through the planner, on tangent planes) against the
JAX package's ``simulate()`` and the port's eager form
(``diff.simulate_diff_eager``: jvp through ``simulate_simple``), float64
on the CPU.

* every case's outputs equal JAX's to 1e-10 and the eager form's to 1e-12,
  each relative to the output's largest magnitude (at least 1): a FISP
  train with a stacked per-pulse T slot and T1/T2 on E, B1 as a T
  coefficient, the flagship Hessian's alias variables, ScalarOp ``darrs``
  and MatrixOp ``dmats``, CombinedOps, an X train with ``density``, D
  with ``kvalue``, a float-shift table train, an Adc with a per-repetition
  phase, ``jacobian_chunk`` values that do not divide the variable counts
  and ``magnitude`` columns;
* the substituted train's plan (its kinds and its const/stack slot
  pattern) equals JAX's ``_plan_and_payload`` of the same substitution;
* a second call on the same operators plans nothing;
* the goldens ``fuzz_diff.npz`` (1e-8) and ``fuzz_hessian.npz`` (1e-10)
  hold through the planned path.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import diff as tdiff
from epgpy_torch import engine as tengine
from epgpy_tpu import diff as jdiff
from epgpy_tpu import engine as jengine

from torch_support import GOLDEN_DIR, port_f64  # noqa: F401

TOL_JAX, TOL_EAGER = 1e-10, 1e-12


def _fisp(e, P=12, *, b1=False, phase=False, seed=0):
    """A FISP train with per-pulse flips (a stacked T slot), T1/T2 on the
    E ops; B1 on T (coefficient FA_i); an Adc with a per-pulse phase."""
    rng = np.random.default_rng(seed)
    FA = rng.uniform(10, 60, P)
    T1, T2 = rng.uniform(300, 1500, 3), rng.uniform(30, 110, 3)
    B1 = rng.uniform(0.8, 1.2, 3)
    o1 = ["T1", "T2"]
    seq = []
    for i in range(P):
        flip = (e.T(FA[i] * B1, 90, order1={"B1": {"alpha": FA[i]}}) if b1
                else e.T(FA[i], 90))
        adc = e.Adc(phase=float(rng.uniform(0, 90))) if phase else e.ADC
        seq += [flip, e.E(5.0, T1, T2, order1=o1), adc,
                e.E(7.0, T1, T2, order1=o1), e.S(1)]
    return seq


def _flagship(e, N=8, seed=0):
    """The flagship Hessian train: per-pulse alpha_i on T, T1/T2 and tau_i
    on E."""
    rng = np.random.default_rng(seed)
    FA, TAU = rng.uniform(10, 60, N), rng.uniform(11, 16, N)
    al, ta = [f"alpha_{i}" for i in range(N)], [f"tau_{i}" for i in range(N)]
    seq = [op for i in range(N) for op in (
        e.T(FA[i], 90, order1={al[i]: "alpha"}),
        e.E(TAU[i], [800.0, 1400.0], [50.0, 90.0],
            order1={"T1": "T1", "T2": "T2", ta[i]: "tau"}),
        e.ADC, e.S(1))]
    return seq, al + ta


def _sym_triplet(rng):
    z = rng.normal(size=2) + 1j * rng.normal(size=2)
    return np.stack([z, np.conj(z), rng.normal(size=2) + 0j], axis=-1)


def _sym_matrix(rng):
    m = rng.normal(size=(3, 3)) + 1j * rng.normal(size=(3, 3))
    return 0.5 * (m + np.conj(m[(1, 0, 2), :][:, (1, 0, 2)]))


def _arrays(e, seed=1):
    """A ScalarOp with derivative arrays and a MatrixOp with derivative
    matrices, both tracked, in a periodic train."""
    rng = np.random.default_rng(seed)
    arr = 0.9 * np.ones((2, 3)) + 0.05 * _sym_triplet(rng)
    darr, d2arr = _sym_triplet(rng), _sym_triplet(rng)
    mat = np.eye(3) + 0.1 * _sym_matrix(rng)
    dmat = _sym_matrix(rng)
    sc = e.ScalarOp(arr, darrs={"x": darr}, d2arrs={("x", "x"): d2arr},
                    order1="x")
    mo = e.MatrixOp(mat, dmats={"y": dmat}, order1={"y": {"y": 2.0}})
    return [op for _ in range(6) for op in (
        e.T(50, 90), sc, e.S(1), mo, e.E(5.0, 900.0, 70.0), e.ADC)]


def _combined(e):
    """CombinedOps: a diagonal one (tracked E @ P) and a matrix one
    (tracked T @ T)."""
    T1, T2 = np.array([700.0, 1300.0]), np.array([50.0, 110.0])
    diag = e.E(3.0, T1, T2, order1=["T1", "T2"]) @ e.P(2.0, 0.01)
    mat = e.T(30.0, 0.0, order1={"a": "alpha"}) @ e.T(10.0, 90.0)
    return [op for _ in range(8) for op in (mat, diag, e.ADC, e.S(1))]


KRON = np.array([[-0.2, 0.8], [0.2, -0.8]])


def _exchange(e):
    """An X train over two compartments (``density``), the exchange rate
    and the free pool's T2 tracked."""
    T2 = np.stack([np.linspace(40.0, 120.0, 3), np.full(3, 0.012)])
    X = e.X(10.0, 0.005 * KRON, axis=0, T1=np.array([1000.0, 1100.0]),
            T2=T2, order1={"k": {"khi": KRON},
                           "T2f": {"T2": np.array([[1.0], [0.0]])}})
    return [op for _ in range(10) for op in (
        e.T(np.asarray([10.0, 0.0]), 0), e.ADC, X, e.S(1))]


def _diffusion(e):
    """A DW train: D ops with a tracked diffusivity (one during the
    gradient), read at ``kvalue``."""
    d1 = e.D(4.0, 1.2e-3, k=1, order1={"Dc": "Dcoef"})
    d2 = e.D(4.5, 1.2e-3, order1={"Dc": "Dcoef"})
    seq = [e.T(90, 90)]
    for i in range(6):
        seq += [e.E(4.0, [800.0, 1400.0], [60.0, 110.0], order1=["T2"]),
                e.S(1), d1, e.T(100.0 + 8.0 * i, 0.0),
                e.E(4.5, [800.0, 1400.0], [60.0, 110.0], order1=["T2"]),
                e.S(1), d2, e.ADC]
    return seq


def _diffusion_batched(e):
    """D ops with a per-atom gradient moment (a batched kshift), one with
    the diffusivity tracked and one without."""
    kb = np.array([[1.0], [2.5]])
    d1 = e.D(4.0, 1.2e-3, k=kb, order1={"Dc": "Dcoef"})
    d0 = e.D(3.0, 0.8e-3, k=kb)
    seq = [e.T(90, 90)]
    for i in range(5):
        seq += [e.E(4.0, [800.0, 1400.0], [60.0, 110.0], order1=["T2"]),
                e.S(1), d1, e.T(100.0 + 8.0 * i, 0.0), d0, e.S(1), e.ADC]
    return seq


def _varying(e, seed=5):
    """Per-atom float shifts (per-atom tables, trimmed: capacity 40 is
    below the lattice bound) and a D op reading each atom's table."""
    rng = np.random.default_rng(seed)
    T2 = np.linspace(40.0, 120.0, 2)
    return [e.T(90, 90)] + [op for k in rng.uniform(2, 10, 6) for op in [
        e.S(np.array([[k], [0.7 * k]])), e.T(40, 0),
        e.E(5.0, 1000.0, T2, order1=["T2"]), e.D(5.0, 2e-3), e.ADC]]


def _table(e, seed=2, diffusion=False):
    """Float shifts on the coordinate table (kgrid), T2 tracked; with
    `diffusion`, a D op reading the merged mean wavenumbers each TR."""
    rng = np.random.default_rng(seed)
    T2 = np.linspace(40.0, 120.0, 3)
    d = [e.D(5.0, 2e-3)] if diffusion else []
    return [e.T(90, 90)] + [op for k in rng.uniform(2, 10, 8) for op in [
        e.S(float(k)), e.T(40, 0), e.E(5.0, 1000.0, T2, order1=["T2"])]
        + d + [e.ADC]]


def _resets(e):
    """PD per repetition (a stacked slot: the new equilibrium has no
    tangent), RESET and SPOILER between tracked relaxations."""
    T2 = np.array([60.0, 80.0])
    return [op for pd in (0.5, 0.7, 0.9, 1.1) for op in (
        e.PD(pd), e.T(30, 0), e.E(5, 800, T2, order1=["T2", "T1"]), e.ADC,
        e.S(1), e.SPOILER, e.T(20, 90), e.E(5, 800, T2, order1=["T2"]),
        e.ADC, e.RESET)]


def _jac(names):
    return lambda e: [e.ADC, e.Jacobian(names)]


#: name -> (the train, its probes, the simulate() options) of a case
CASES = {
    "fisp_stacked_T": (_fisp, _jac(["T1", "T2"]), {}),
    "b1_on_T": (lambda e: _fisp(e, b1=True), _jac(["B1", "T1", "T2"]), {}),
    "flagship_hessian": (
        lambda e: _flagship(e)[0],
        lambda e: [e.ADC, e.Hessian(["magnitude", "T1", "T2"],
                                    _flagship(e)[1])], {"max_nstate": 6}),
    "darrs_dmats": (_arrays, lambda e: [e.ADC, e.Jacobian(["x", "y"]),
                                        e.Hessian(["x", "y"])], {}),
    "combined": (_combined, _jac(["T1", "a", "T2"]), {}),
    "exchange_density": (_exchange, _jac(["k", "T2f"]),
                         {"max_nstate": 8, "density": [0.8, 0.2]}),
    "diffusion_kvalue": (_diffusion, _jac(["Dc", "T2"]),
                         {"kvalue": 74900.0}),
    "diffusion_batched_kshift": (_diffusion_batched, _jac(["Dc", "T2"]),
                                 {"kvalue": 74900.0}),
    "table_varying_shift": (_varying, _jac(["T2"]),
                            {"kgrid": 0.5, "max_nstate": 40,
                             "kvalue": 3000.0}),
    "table_float_shift": (_table, _jac(["T2"]),
                          {"kgrid": 0.5, "max_nstate": 80}),
    "table_float_shift_diffusion": (
        lambda e: _table(e, diffusion=True), _jac(["T2"]),
        {"kgrid": 0.5, "max_nstate": 80, "kvalue": 3000.0}),
    "adc_phase": (lambda e: _fisp(e, phase=True), _jac(["T1", "T2"]), {}),
    "pd_reset_spoiler": (_resets, lambda e: [e.ADC, e.Hessian(
        ["magnitude", "T2", "T1"])], {}),
    "chunk_padding": (
        lambda e: _fisp(e, b1=True),
        lambda e: [e.ADC, e.Jacobian(["B1", "T1", "T2"]),
                   e.Hessian(["T1", "B1"], ["T2", "B1", "T1"])],
        {"jacobian_chunk": 2}),
    "hessian_chunk_padding": (
        lambda e: _flagship(e, N=5)[0],
        lambda e: [e.Hessian(["magnitude", "T1", "T2"], _flagship(e, N=5)[1]),
                   e.ADC], {"jacobian_chunk": 4, "max_nstate": 6}),
    "magnitude": (_fisp, lambda e: [
        e.Jacobian(["magnitude", "T2", "magnitude"]),
        e.Hessian(["magnitude", "T1"], ["T2", "magnitude"])], {}),
}


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _eager(monkeypatch, seq, probes, opts):
    """simulate() with the eager diff form in the planned one's place."""
    with monkeypatch.context() as m:
        m.setattr(tdiff, "simulate_diff", tdiff.simulate_diff_eager)
        return tepg.simulate(seq, probe=probes, fisp_kernel=False, **opts)


@pytest.mark.parametrize("name", CASES)
def test_planned_equals_jax_and_eager(port_f64, monkeypatch, name):
    build, probes, opts = CASES[name]
    seq, tprobes = build(tepg), probes(tepg)
    before = tdiff.PROGRAM_COUNTS["plans"]
    got = tepg.simulate(seq, probe=tprobes, fisp_kernel=False, **opts)
    assert tdiff.PROGRAM_COUNTS["plans"] == before + 1
    want = jepg.simulate(build(jepg), probe=probes(jepg), fisp_kernel=False,
                         **opts)
    eager = _eager(monkeypatch, seq, tprobes, opts)
    for g, w, ea in zip(got, want, eager):
        assert g.dtype == np.complex128
        assert _close(g, w, TOL_JAX)
        assert _close(g, ea, TOL_EAGER)
    assert any(np.abs(g).max() > 0 for g in got[1:])


def _jax_plan(seq):
    """The kinds and slot pattern of JAX's plan of the train as its
    ``simulate_diff`` substitutes it (traced eps, the value-signature
    memo)."""
    variables = jdiff.tracked_variables(seq)
    out = {}

    def run(eps_vec):
        eps = {v: eps_vec[i] for i, v in enumerate(variables)}
        memo, seq2 = {}, []
        for op in seq:
            key = jdiff._subst_key(op)
            sub = memo.get(key) if key is not None else None
            if sub is None:
                sub = jdiff.substitute(op, eps)
                if key is not None:
                    memo[key] = sub
            seq2.append(sub)
        kinds, payload = jengine._plan_and_payload(seq2, cache=False)
        out["kinds"] = kinds
        out["slots"] = [None if k[0] == "unroll" else tuple(
            "const" if isinstance(s, jengine._Const) else "stack"
            for s in pl[1]) for k, pl in zip(kinds, payload)]
        return jnp.zeros(())

    jax.make_jaxpr(run)(jnp.zeros(len(variables)))
    return out


# (not the D train: JAX's D holds device arrays, which its memo never
# merges, so JAX stacks a D slot the port -- host parameters -- keeps
# constant)
@pytest.mark.parametrize("name", ["fisp_stacked_T", "b1_on_T",
                                  "flagship_hessian", "adc_phase",
                                  "combined", "darrs_dmats"])
def test_substituted_plan_equals_jax(port_f64, name):
    build = CASES[name][0]
    seq = tengine.flatten_sequence(build(tepg))
    seq2 = tdiff._substituted(seq, tdiff.tracked_variables(seq))
    entry = tengine._plan_and_payload(seq2, cache=False)
    slots = [None if k[0] == "unroll" else tuple(s[0] for s in pl[1])
             for k, pl in zip(entry.kinds, entry.payload)]
    want = _jax_plan(jengine.flatten_sequence(build(jepg)))
    assert entry.kinds == want["kinds"]
    assert slots == want["slots"]
    assert any(k[0] == "scan" for k in entry.kinds)


def test_value_identical_ops_share_one_substitution(port_f64):
    """One fresh-but-equal tracked E per TR substitutes to ONE object (a
    scan constant); distinct aliases stay distinct (stacked)."""
    seq, _ = _flagship(tepg)
    fresh = [op for fa in (20.0, 30.0, 40.0, 50.0) for op in (
        tepg.T(fa, 90), tepg.E(5.0, 800.0, 60.0, order1=["T1"]), tepg.ADC)]
    sub = tdiff._substituted(fresh, ["T1"])
    assert sub[1] is sub[4] is sub[7] is sub[10]
    assert sub[0] is fresh[0]
    sub = tdiff._substituted(seq, tdiff.tracked_variables(seq))
    assert sub[0] is not sub[4] and sub[1] is not sub[5]


def test_second_call_plans_nothing(port_f64):
    seq = _fisp(tepg, b1=True)
    probes = [tepg.ADC, tepg.Jacobian(["B1", "T1", "T2"])]
    first = tepg.simulate(seq, probe=probes, jacobian_chunk=2)
    counts = dict(tdiff.PROGRAM_COUNTS)
    again = tepg.simulate(seq, probe=probes, jacobian_chunk=2)
    assert tdiff.PROGRAM_COUNTS["plans"] == counts["plans"]
    assert tdiff.PROGRAM_COUNTS["hits"] == counts["hits"] + 1
    for a, b in zip(first, again):
        assert np.array_equal(a, b)
    # another chunk size is another program
    tepg.simulate(seq, probe=probes, jacobian_chunk=3)
    assert tdiff.PROGRAM_COUNTS["plans"] == counts["plans"] + 1


def test_table_train_tangents_follow_the_primal_merge(port_f64, monkeypatch):
    """A trimming table train (capacity below the lattice bound, so the
    merge ranks cells by magnitude): the tangent planes follow the
    primal's cells, as JAX's jvp does."""
    seq = _table(tepg)
    probes = [tepg.ADC, tepg.Jacobian(["T2"])]
    opts = {"kgrid": 0.5, "max_nstate": 16}
    got = tepg.simulate(seq, probe=probes, fisp_kernel=False, **opts)
    want = jepg.simulate(_table(jepg), probe=[jepg.ADC,
                                              jepg.Jacobian(["T2"])],
                         fisp_kernel=False, **opts)
    eager = _eager(monkeypatch, seq, probes, opts)
    for g, w, ea in zip(got, want, eager):
        assert _close(g, w, TOL_JAX) and _close(g, ea, TOL_EAGER)


_GD = np.load(os.path.join(GOLDEN_DIR, "fuzz_diff.npz"))
_DSPECS = json.loads(bytes(_GD["specs_json"]).decode())


@pytest.mark.parametrize("i", range(len(_DSPECS)))
def test_fuzz_diff_golden_through_the_planner(port_f64, i):
    sp = _DSPECS[i]
    seq = []
    for n in range(sp["ntr"]):
        if sp["alias"]:
            o1 = {f"a{n}": "alpha"} if n < 3 else False
        else:
            o1 = "alpha" if n < 3 else False
        seq += [tepg.T(sp["alphas"][n], sp["phi"], order1=o1),
                tepg.E(sp["taus"][n], sp["T1"], sp["T2"],
                       order1=["T1", "T2"]), tepg.ADC, tepg.S(1)]
    before = tdiff.PROGRAM_COUNTS["plans"]
    jac = tepg.simulate(seq, max_nstate=6, probe=tepg.Jacobian(sp["vars"]),
                        jacobian_chunk=2)
    assert tdiff.PROGRAM_COUNTS["plans"] == before + 1
    ref = _GD[f"jac_re_{i:02d}"] + 1j * _GD[f"jac_im_{i:02d}"]
    assert np.abs(jac - ref).max() < 1e-8


_GH = np.load(os.path.join(GOLDEN_DIR, "fuzz_hessian.npz"))
_HSPECS = json.loads(bytes(_GH["specs_json"]).decode())


@pytest.mark.parametrize("i", range(len(_HSPECS)))
def test_fuzz_hessian_golden_through_the_planner(port_f64, i):
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
    before = tdiff.PROGRAM_COUNTS["plans"]
    _, hess = tepg.simulate(seq, max_nstate=6, jacobian_chunk=3, probe=[
        tepg.Jacobian(["T1"]), tepg.Hessian(sp["vars1"], sp["vars2"])])
    assert tdiff.PROGRAM_COUNTS["plans"] == before + 1
    ref = _GH[f"hes_re_{i:02d}"] + 1j * _GH[f"hes_im_{i:02d}"]
    assert hess.shape == ref.shape
    assert np.abs(hess - ref).max() < 1e-10


def test_user_callable_probe_runs_the_program_eagerly(port_f64, monkeypatch):
    """A probe that calls user code keeps the diff program out of a CUDA
    graph (its code runs at every ADC, as the primal planner's rule
    says): with the card's branch forced on the CPU, no graph is built
    and the outputs equal the plain run's."""
    calls = []

    def reader(sm):
        calls.append(1)
        return sm.F0

    seq = _fisp(tepg)
    probes = [tepg.Probe(reader), tepg.Jacobian(["T2"])]
    want = tepg.simulate(seq, probe=probes, fisp_kernel=False)
    n = len(calls)
    monkeypatch.setattr(tdiff, "_graph_passes", lambda: True)
    got = tepg.simulate(seq, probe=probes, fisp_kernel=False)
    assert len(calls) == 2 * n == 2 * len(want[0])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
