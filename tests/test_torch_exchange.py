"""The EPG-X exchange operator of epgpy_torch vs epgpy_tpu: the kinetic
matrix, the closed-form 2x2 exponential, the conservation check, batched
kinetic matrices, X trains on the general path, the goldens and the X
order-1 Jacobians.

* ``exchange_matrix`` == the JAX function exactly; ``_expm2`` vs
  ``scipy.linalg.expm`` near eigenvalue degeneracy (complex64 3e-6,
  complex128 1e-12 relative: ``tests/test_exchange_ops.py:63-82``'s
  limits) and under a large common magnitude (1e-10);
* X trains through the port's general path (float64) vs the JAX
  package's float64 general path, 1e-10 absolute; the goldens
  ``exchange_gre.npz`` (through ``simulate(init=...)``) at 1e-10 and
  ``mt_rates.npz`` at the JAX test's own limits (rtol 1e-10; 1e-6 for the
  super-Lorentzian line, whose golden integrates differently), the MT
  rates also == the JAX package's at 1e-12;
* order-1 Jacobians of the exchange rate and the free-pool T2
  (``order1={"k": {"khi": kron}, "T2f": {"T2": e0}}``) through the port's
  diff path vs the JAX diff path, 1e-8 relative to each column's scale.
"""

import os

import numpy as np
import pytest
import torch

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch.ops import exchange as tex
from epgpy_torch.utils import magnettransfer as tmt
from epgpy_tpu.ops import exchange as jex
from epgpy_tpu.utils import magnettransfer as jmt

from chip_smoke import exchange_gre_train
from torch_support import GOLDEN_DIR, port_f64  # noqa: F401


@pytest.mark.parametrize("kw", [
    dict(k=0.005), dict(k=0.01, densities=[0.8, 0.2]),
    dict(k=0.004, ncomp=3, densities=[0.5, 0.3, 0.2]),
    dict(k=[0.005, 0.01, 0.02], axis=0), dict(k=[0.002, 0.03], axis=-1)],
    ids=["scalar", "densities", "three", "batched_axis0", "batched_last"])
def test_exchange_matrix_matches_jax(kw):
    kw = dict(kw)
    k = kw.pop("k")
    assert np.array_equal(tex.exchange_matrix(k, **kw),
                          jex.exchange_matrix(k, **kw))


@pytest.mark.parametrize("delta", [0.0, 1e-6, 1e-4, 1e-2, 0.03, 0.05, 0.3,
                                   2.0])
def test_expm2_near_degeneracy(delta):
    import scipy.linalg as sla

    x, b = 0.7, 1.3
    c = -(x ** 2 - delta ** 2) / b
    m = np.array([[-1.0 + x, b], [c, -1.0 - x]], complex)
    truth = sla.expm(m)
    for dt, tol in ((torch.complex64, 3e-6), (torch.complex128, 1e-12)):
        got = tex._expm2(torch.as_tensor(m, dtype=dt)).numpy()
        assert np.abs(got - truth).max() / np.abs(truth).max() < tol


@pytest.mark.parametrize("mu_im,delta", [(60.0, 1.0), (600.0, 2.5),
                                         (60.0, 8.0)])
def test_expm2_large_common_magnitude(mu_im, delta):
    import scipy.linalg as sla

    x = delta / 2
    m = np.array([[1j * mu_im - 0.5 + x, 0.7],
                  [0.03, 1j * mu_im - 0.5 - x]], complex)
    truth = sla.expm(m)
    got = tex._expm2(torch.as_tensor(m, dtype=torch.complex128)).numpy()
    assert np.abs(got - truth).max() / np.abs(truth).max() < 1e-10


def test_conservation_check(port_f64):
    """Per-atom kinetic matrices each conserving their own atom's density
    pass (the atoms pair, they do not cross); a matrix that does not
    conserve the density raises."""
    dens = np.asarray([[0.9, 0.7], [0.1, 0.3]])       # (C, B)
    khis = np.stack([tex.exchange_matrix(0.005, densities=dens[:, b])
                     for b in range(2)], axis=1)       # (C, B, C)
    X = tepg.X(10.0, khis, axis=0, T1=1000.0,
               T2=np.asarray([[80.0, 90.0], [0.012, 0.012]]))
    sm = tepg.StateMatrix([0, 0, 1], nstate=2, density=dens)
    sm = tepg.T(np.asarray([10.0, 0.0]), 0.0)(sm.broadcast((2, 2)))
    assert torch.isfinite(torch.view_as_real(X(sm).states)).all()
    bad = tepg.X(10.0, tex.exchange_matrix(0.005), axis=0, T1=1000.0,
                 T2=80.0)
    with pytest.raises(RuntimeError, match="conserve"):
        bad(tepg.StateMatrix([0, 0, 1], nstate=1,
                             density=[0.8, 0.2]).broadcast((2,)))
    with pytest.raises(ValueError, match="sum to 0"):
        tepg.X(1.0, np.array([[1.0, 0.0], [0.0, 1.0]]))


def _run(e, khi, T2, dens=(0.5, 0.5), fisp_kernel=False):
    X = e.X(10.0, khi, axis=0, T1=1000.0, T2=T2)
    seq = []
    for _ in range(6):
        seq += [e.T(np.asarray([10.0, 0.0]), 0.0), e.ADC, X, e.S(1)]
    return np.asarray(e.simulate(seq, max_nstate=4, density=list(dens),
                                 fisp_kernel=fisp_kernel))


@pytest.mark.parametrize("rates", [[0.005, 0.01, 0.02], [0.005, 0.02]])
def test_batched_khi_matches_per_atom_loop(port_f64, rates):
    """Per-atom khi (exchange_matrix(rates, axis=0) -> (C, B, C)) pairs each
    atom's kinetic matrix with that atom's parameters, B == C included;
    and equals the JAX package's general path."""
    B = len(rates)
    t2f = np.linspace(60, 100, B)
    T2 = np.stack([t2f, np.full(B, 0.012)])
    khi = tex.exchange_matrix(np.asarray(rates), axis=0)
    batched = _run(tepg, khi, T2)
    per_atom = np.stack([_run(tepg, tex.exchange_matrix(float(rates[b])),
                              np.asarray([t2f[b], 0.012]))
                         for b in range(B)], axis=-1)
    assert np.abs(batched - per_atom).max() < 1e-14
    assert np.abs(batched - _run(jepg, khi, T2)).max() < 1e-10


def _x_train(e, C=2, *, sat=True, two=False, g=None, axis=0, n=10):
    dens = np.asarray([0.6, 0.25, 0.15][:C])
    dens = dens / dens.sum()
    khi = e.exchange_matrix(0.006, ncomp=C, densities=dens)
    T2 = np.stack([np.linspace(40.0, 120.0, 3)]
                  + [np.full(3, 0.5 * (c + 1)) for c in range(C - 1)])
    T1 = np.linspace(800.0, 1200.0, C)
    X1 = e.X(3.0, khi, axis=axis, T1=T1, T2=T2, g=g) if two else None
    X2 = e.X(8.0, khi, axis=axis, T1=T1, T2=T2, g=g)
    seq = []
    for i in range(n):
        if sat:
            rL = np.zeros(C)
            rL[-1] = 0.3
            seq.append(e.R(0, rL=rL, r0=None))
        seq.append(e.T(np.asarray([12.0 + 3 * np.sin(i)] + [2.0] * (C - 1)),
                       30.0 * i))
        seq += ([X1] if two else []) + [e.ADC, X2, e.S(1)]
    return seq, list(dens)


@pytest.mark.parametrize("kw", [dict(), dict(two=True, g=[0.03, -0.01]),
                                dict(C=3, two=True), dict(sat=False)],
                         ids=["mt", "two_stage_df", "three_pools", "no_sat"])
def test_x_trains_general_path_match_jax(port_f64, kw):
    """X trains through the port's general path (the kernels off) vs the
    JAX package's float64 general path; three pools take
    torch.linalg.matrix_exp against the JAX Pade exponential."""
    seq, dens = _x_train(tepg, **kw)
    jseq, _ = _x_train(jepg, **kw)
    got = tepg.simulate(seq, max_nstate=6, density=dens, fisp_kernel=False)
    want = np.asarray(jepg.simulate(jseq, max_nstate=6, density=dens,
                                    fisp_kernel=False))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-10


def test_x_shape_matches_jax():
    """The op's batch shape drops the matrix's inserted axis, not a
    parameter axis (the engine's broadcast shape depends on it)."""
    cases = [
        dict(tau=10.0, khi=0.005, axis=-1, T1=[1000.0, 500.0],
             T2=[80.0, 20.0]),
        dict(tau=10.0, khi=tex.exchange_matrix(0.005), axis=0,
             T1=np.asarray([1000.0, 1000.0]),
             T2=np.stack([np.linspace(40, 120, 4), np.full(4, 0.012)])),
        dict(tau=4.0, khi=tex.exchange_matrix([0.005, 0.01, 0.02], axis=0),
             axis=0, T1=1000.0, T2=np.ones((2, 3))),
        dict(tau=np.asarray([1.0, 2.0]), khi=tex.exchange_matrix(0.01),
             axis=0, T2=80.0),
    ]
    for kw in cases:
        kw = dict(kw)
        tau, khi = kw.pop("tau"), kw.pop("khi")
        assert tepg.X(tau, khi, **kw).shape == jepg.X(tau, khi, **kw).shape


def test_precomputed_exchange_equals_x(port_f64):
    X = tepg.X(7.0, tex.exchange_matrix(0.01, densities=[0.7, 0.3]), axis=0,
               T1=[900.0, 700.0], T2=np.stack([[40.0, 80.0], [0.5, 0.5]]),
               g=[0.02, 0.0])
    sm = tepg.StateMatrix([0, 0, 1], nstate=2, density=[0.7, 0.3])
    sm = tepg.T(np.asarray([30.0, 0.0]), 20.0)(sm.broadcast((2, 2)))
    pre = tex.precompute_exchange(X)
    assert pre.shape == X.shape
    assert torch.allclose(pre(sm).states, X(sm).states, atol=1e-15)


def test_exchange_gre_golden(port_f64):
    """tests/golden/exchange_gre.npz (tests/test_shiftnd.py:429-444): a
    scalar-rate X on the last axis, a custom initial state."""
    g = np.load(os.path.join(GOLDEN_DIR, "exchange_gre.npz"))
    seq = exchange_gre_train(tepg)
    sig = tepg.simulate(seq, max_nstate=12,
                        init=np.array([0, 0, 0.5]) * np.ones((2, 1, 1)),
                        density=[0.5, 0.5])
    assert np.abs(sig - g["signal"]).max() < 1e-10


def test_mt_rates_golden():
    g = np.load(os.path.join(GOLDEN_DIR, "mt_rates.npz"))
    off = g["offres"]
    for shape in ("gaussian", "lorentzian"):
        got = tmt.absorption_rate(12e-3, shape, off)
        assert np.allclose(got, g[shape], rtol=1e-10)
        assert np.allclose(got, jmt.absorption_rate(12e-3, shape, off),
                           rtol=1e-12)
    sl = tmt.absorption_rate(12e-3, "super-lorentzian", off[2:])
    assert np.allclose(sl, g["super_lorentzian"], rtol=1e-6)
    assert np.allclose(sl, jmt.absorption_rate(12e-3, "super-lorentzian",
                                               off[2:]), rtol=1e-12)
    W = tmt.saturation_rate(5.0, 10.0,
                            tmt.absorption_rate(12e-3, "gaussian", 2.0))
    assert np.isclose(W, g["satrate"], rtol=1e-10)
    wave = np.linspace(0.0, 10.0, 11)
    assert np.isclose(tmt.saturation_rate(5.0, wave, 1e-3),
                      jmt.saturation_rate(5.0, wave, 1e-3), rtol=1e-12)


KRON = np.array([[-0.2, 0.8], [0.2, -0.8]])


def _tracked(e, k=0.005, track=True, n=12):
    T2 = np.stack([np.linspace(40.0, 120.0, 3), np.full(3, 0.012)])
    o1 = ({"k": {"khi": KRON}, "T2f": {"T2": np.array([[1.0], [0.0]])}}
          if track else False)
    X = e.X(10.0, k * KRON, axis=0, T1=np.array([1000.0, 1100.0]), T2=T2,
            order1=o1)
    seq = []
    for _ in range(n):
        seq += [e.T(np.asarray([10.0, 0.0]), 0), e.ADC, X, e.S(1)]
    return seq


def test_x_order1_jacobian_matches_jax(port_f64):
    """d(signal)/dk (khi = k kron) and d/dT2 of the free pool through the
    port's diff path == the JAX diff path, 1e-8 relative per column."""
    probe = [tepg.ADC, tepg.Jacobian(["k", "T2f"])]
    sig, jac = tepg.simulate(_tracked(tepg), max_nstate=8,
                             density=[0.8, 0.2], probe=probe)
    jsig, jjac = jepg.simulate(_tracked(jepg), max_nstate=8,
                               density=[0.8, 0.2],
                               probe=[jepg.ADC, jepg.Jacobian(["k", "T2f"])],
                               fisp_kernel=False)
    jjac = np.asarray(jjac)
    assert jac.shape == jjac.shape == (12, 2, 3, 2)
    assert np.abs(sig - np.asarray(jsig)).max() < 1e-12
    for c in range(2):
        scale = np.abs(jjac[..., c]).max()
        assert scale > 0
        assert np.abs(jac[..., c] - jjac[..., c]).max() < 1e-8 * scale


def test_x_order1_jacobian_finite_difference(port_f64):
    jac = tepg.simulate(_tracked(tepg), max_nstate=8, density=[0.8, 0.2],
                        probe=tepg.Jacobian(["k"]))
    eps = 1e-7
    fd = (tepg.simulate(_tracked(tepg, 0.005 + eps, False), max_nstate=8,
                        density=[0.8, 0.2])
          - tepg.simulate(_tracked(tepg, 0.005 - eps, False), max_nstate=8,
                          density=[0.8, 0.2])) / (2 * eps)
    assert np.abs(jac[..., 0] - fd).max() / np.abs(fd).max() < 1e-7


def test_tracked_x_falls_through_the_kernels(port_f64):
    """A tracked X is not claimed by the fused EPG-X matchers (their kernels
    ignore order1): a forced run equals the general path; a probe of an
    untracked variable raises."""
    seq = _tracked(tepg)
    assert tfd.match_xgre(seq, (2, 3), [0.8, 0.2]) is None
    assert tfd.match_xcomposite(seq, (2, 3), [0.8, 0.2]) is None
    tfd.DISPATCH_COUNTS.clear()
    got = tepg.simulate(seq, max_nstate=8, density=[0.8, 0.2],
                        fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS == {}
    ref = tepg.simulate(_tracked(tepg, track=False), max_nstate=8,
                        density=[0.8, 0.2], fisp_kernel=False)
    assert np.abs(got - ref).max() < 1e-14
    with pytest.raises(ValueError, match="not tracked"):
        tepg.simulate(_tracked(tepg, track=False), max_nstate=8,
                      density=[0.8, 0.2], probe=tepg.Jacobian(["k"]))
