"""The DW-FISP family of epgpy_torch vs epgpy_tpu: the FISP kernels with
their diffusion attenuation behind ``simulate()``.

* ``match_dwfisp`` returns the JAX matcher's dict, key by key (its
  ``diffusion`` entry included: b-value bases, ramp flag, scalar or 3x3
  Dcoef), and falls through with a logged reason on off-pattern trains (a
  fresh D per TR, a D at k=2, an array tau, a tracked tensor D, too short);
* the float64 forced path (the FISP twin with its attenuation,
  ``DISPATCH_COUNTS["dw"]``) == the port's general path to 1e-10 for a
  ramped, a constant-k, a tensor D and an inversion-prepped train;
* Jacobian probes over (T1, T2, Dcoef), and with a tracked B1, through the
  FISP Jacobian twin (``["jac:dw"]``) == the general diff path to 1e-8 in
  float64;
* JAX match dicts carried through ``convert`` run the port's runners to the
  JAX runners' values (float32, 1e-5).
"""

import logging

import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch.convert import from_numpy_params
from epgpy_tpu import fisp_dispatch as jfd

from torch_support import composite_claims, port_f32, port_f64  # noqa: F401

KV = 2 * np.pi / 1e-3          # 1 mm voxel: 6283 rad/m per state index


def _train(e, P=12, nb=3, *, D=1e-3, dkw=None, tau=7.0, prep=None,
           d_per_tr=False, track=None, d_track=False, b1_track=False):
    """tests/test_dwfisp_dispatch.py:17's DW-FISP train in package `e`."""
    dkw = dict(k=1) if dkw is None else dkw
    FA = 10 + 50 * np.abs(np.sin(np.arange(P) / 5.0))
    T1 = np.linspace(600, 1500, nb)
    T2 = np.linspace(50, 120, nb)
    B1 = np.linspace(0.9, 1.1, nb) if b1_track else 1.0
    okw = {} if track is None else {"order1": list(track)}
    dspec = {"order1": ["Dcoef"]} if d_track else {}
    d_op = e.D(tau, D, **dkw, **dspec)
    seq = []
    if prep is not None:
        seq += [e.T(180, 0), e.E(float(prep), T1, T2, **okw)]
    for i in range(P):
        tkw = {"order1": {"B1": {"alpha": float(FA[i])}}} if b1_track else {}
        seq += [e.T(FA[i] * B1, 90.0, **tkw), e.E(5.0, T1, T2, **okw),
                e.ADC, e.E(7.0 + (i % 2), T1, T2, **okw), e.S(1),
                e.D(tau, D, **dkw) if d_per_tr else d_op]
    return seq


TRAINS = {
    "ramp": dict(),
    "const_k": dict(dkw={}),
    "tensor": dict(D=np.diag([1.2e-3, 0.4e-3, 0.2e-3])),
    "prep": dict(prep=15.0, nb=4),
    "tracked": dict(track=("T1", "T2"), d_track=True),
    "b1_tracked": dict(track=("T2",), b1_track=True),
}
KEYS = ("FA", "phi", "TR", "TE", "T1", "T2", "B1", "TI", "inv_df", "vars",
        "b1_scale", "d_var", "demod", "shape", "df", "diffusion")


@pytest.mark.parametrize("name", TRAINS)
def test_match_dwfisp_equals_jax(name):
    j = jfd.match_dwfisp(_train(jepg, **TRAINS[name]), KV)
    t = tfd.match_dwfisp(_train(tepg, **TRAINS[name]), KV)
    assert j is not None and t is not None
    assert set(t) == set(KEYS) and set(j) == set(KEYS)
    for k in KEYS:
        a, b = j[k], t[k]
        if k == "diffusion":
            assert set(a) == set(b) == {"bT", "bL", "Dcoef", "ramp"}
            for d in a:
                assert np.array_equal(np.asarray(a[d]), np.asarray(b[d])), d
        elif a is None or b is None or isinstance(a, (bool, float, tuple,
                                                      str)):
            assert a == b or (np.ndim(a) == 0 and np.ndim(b) == 0
                              and float(a) == float(b)), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


OFF_PATTERN = {
    "per_tr_instances": dict(d_per_tr=True),
    "k2": dict(dkw=dict(k=2)),
    "array_tau": dict(nb=2, tau=np.array([7.0, 7.0])),
    "tracked_tensor": dict(D=np.diag([1.2e-3, 0.4e-3, 0.2e-3]),
                           d_track=True),
    "short": dict(P=1),
}


@pytest.mark.parametrize("name", OFF_PATTERN)
def test_off_pattern_trains_fall_through(port_f64, name, caplog):
    kw = OFF_PATTERN[name]
    assert jfd.match_dwfisp(_train(jepg, **kw), KV) is None
    seq = _train(tepg, **kw)
    tfd.clear_cache()
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        assert tfd.match_dwfisp(seq, KV) is None
    assert any("not a DW-FISP train" in r.getMessage()
               for r in caplog.records)
    before = dict(tfd.DISPATCH_COUNTS)
    got = tepg.simulate(seq, fisp_kernel="force", max_nstate=6, kvalue=KV)
    assert tfd.DISPATCH_COUNTS == composite_claims(
        tfd, jfd, seq, _train(jepg, **kw), before, KV)
    want = tepg.simulate(seq, fisp_kernel=False, max_nstate=6, kvalue=KV)
    assert np.abs(got - want).max() < 1e-10


def test_host_kvalue_only(port_f64):
    """A kvalue that is not a host number leaves the train to the general
    path (the matcher reads the b-values on the host)."""
    seq = _train(tepg)
    assert tfd.match_dwfisp(seq, np.array([KV, KV])) is None
    assert tfd.match_dwfisp(seq, KV) is not None


@pytest.mark.parametrize("name", ["ramp", "const_k", "tensor", "prep"])
def test_float64_forced_path_matches_general_path(port_f64, name):
    seq = _train(tepg, **TRAINS[name])
    before = tfd.DISPATCH_COUNTS.get("dw", 0)
    forced = tepg.simulate(seq, fisp_kernel="force", max_nstate=8,
                           kvalue=KV)
    assert tfd.DISPATCH_COUNTS.get("dw", 0) == before + 1
    loop = tepg.simulate(seq, fisp_kernel=False, max_nstate=8, kvalue=KV)
    assert forced.dtype == loop.dtype == np.complex128
    assert forced.shape == loop.shape
    assert np.abs(forced - loop).max() < 1e-10
    # the attenuation is there: the same train without D ops differs
    free = tepg.simulate([op for op in seq if not isinstance(op, tepg.D)],
                         fisp_kernel=False, max_nstate=8)
    assert np.abs(free - loop).max() > 1e-4


JAC_TRAINS = {
    "t1_t2_dcoef": (TRAINS["tracked"], ["magnitude", "T1", "T2", "Dcoef"]),
    "b1_tracked_prep": (dict(track=("T1", "T2"), d_track=True,
                             b1_track=True, prep=12.0),
                        ["Dcoef", "B1", "T2"]),
}


@pytest.mark.parametrize("name", JAC_TRAINS)
def test_jacobian_probes_match_general_diff_path(port_f64, name):
    kw, names = JAC_TRAINS[name]
    seq = _train(tepg, **kw)
    if kw.get("prep") is not None:
        # a B1-tracked train's prep pulse must be tracked too (its kernel
        # coefficient is 180: d(180 B1)/dB1)
        B1 = np.linspace(0.9, 1.1, 3)
        seq[0] = tepg.T(180 * B1, 0, order1={"B1": {"alpha": 180.0}})
    probes = [tepg.ADC, tepg.Jacobian(names)]
    before = tfd.DISPATCH_COUNTS.get("jac:dw", 0)
    sig_k, jac_k = tepg.simulate(seq, probe=probes, fisp_kernel="force",
                                 max_nstate=6, kvalue=KV)
    assert tfd.DISPATCH_COUNTS.get("jac:dw", 0) == before + 1
    sig_g, jac_g = tepg.simulate(seq, probe=probes, fisp_kernel=False,
                                 max_nstate=6, kvalue=KV)
    assert jac_k.shape == jac_g.shape == sig_k.shape + (len(names),)
    assert np.abs(sig_k - sig_g).max() < 1e-8
    for c in range(len(names)):
        scale = max(np.abs(jac_g[..., c]).max(), 1.0)
        assert np.abs(jac_g[..., c]).max() > 0
        assert np.abs(jac_k[..., c] - jac_g[..., c]).max() < 1e-8 * scale


@pytest.mark.parametrize("name", ["tensor", "tracked"])
def test_jax_params_through_port_runners(port_f32, name):
    jp = jfd.match_dwfisp(_train(jepg, **TRAINS[name]), KV)
    tp = from_numpy_params(jp, "cpu")
    assert set(tp) - {"_dev"} == set(KEYS)
    assert tp["diffusion"]["Dcoef"].shape == np.shape(
        TRAINS[name].get("D", 1e-3))
    got = tfd.run_dwfisp_kernel(tp, 6).numpy()
    want = jfd.run_dwfisp_kernel(jp, 6, interpret=True)
    want = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    if not jp["vars"]:
        return
    specs = (("sig",), ("jac", ("magnitude",) + tuple(jp["vars"])))
    tj = tfd.run_dwfisp_jacobian(tp, 6, specs)
    jj = jfd.run_dwfisp_jacobian(jp, 6, specs, interpret=True)
    for a, b in zip(tj, jj):
        b = np.asarray(b["__c_re"]) + 1j * np.asarray(b["__c_im"])
        a = a.numpy()
        assert a.shape == b.shape
        scale = np.abs(b).max(axis=tuple(range(b.ndim - 1))) \
            if a.ndim == 3 else np.abs(b).max()
        assert (np.abs(a - b).max(axis=tuple(range(a.ndim - 1)))
                <= 1e-5 * np.maximum(scale, 1.0)).all()
