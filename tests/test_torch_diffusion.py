"""epgpy_torch's diffusion operator D vs epgpy_tpu's, on the 1-D ladder.

Random conjugate-symmetric states (numpy, seeded) go through both
packages' D ops in float64 -- scalar and 3x3 tensor D, constant-k
(k=None) and ramped (k=1) attenuation, a non-unit ``kvalue`` -- and agree
to 1e-12 (both float64, a different operation order).  The b-matrix and
attenuation helpers, the StateMatrix's wavenumbers, a DW train through
the general path and a Dcoef Jacobian through the general diff path are
held against the JAX package the same way.
"""

import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch.ops import diffusion as tdif
from epgpy_tpu.ops import diffusion as jdif

from torch_support import port_f64, random_ladder  # noqa: F401

ATOL = 1e-12
KV = 2 * np.pi / 1e-3        # 1 mm voxel: 6283 rad/m per state index
DTENSOR = np.diag([1.5e-3, 0.5e-3, 0.25e-3]) + 1e-4 * np.ones((3, 3))


@pytest.mark.parametrize("Dc", [1.2e-3, DTENSOR], ids=["scalar", "tensor"])
@pytest.mark.parametrize("k", [None, 1], ids=["k_none", "k1"])
@pytest.mark.parametrize("kvalue", [1.0, KV], ids=["kv1", "kv_mm"])
def test_D_matches_jax(port_f64, Dc, k, kvalue):
    states = random_ladder(np.random.default_rng(3), (4,), 5)
    jsm = jepg.StateMatrix(states, kvalue=kvalue)
    tsm = tepg.StateMatrix(states, kvalue=kvalue)
    want = np.asarray(jepg.D(4.5, Dc, k=k)(jsm).states)
    got = tepg.D(4.5, Dc, k=k)(tsm).states.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < ATOL
    if kvalue != 1.0:
        # the attenuation really bites at the physical wavenumbers
        assert np.abs(got - states).max() > 1e-3


def test_statematrix_k_matches_jax(port_f64):
    jsm = jepg.StateMatrix(nstate=6, kvalue=KV)
    tsm = tepg.StateMatrix(nstate=6, kvalue=KV)
    want = np.asarray(jsm.k)
    # the batch axes lead, as in JAX: (1, 13, 1)
    assert tsm.k.shape == want.shape == (1, 13, 1)
    assert np.abs(tsm.k.numpy() - want).max() < ATOL
    # kvalue survives an operator application
    assert tepg.S(1)(tsm).kvalue == KV


@pytest.mark.parametrize("ramp", [False, True])
def test_bmatrix_and_operator_match_jax(port_f64, ramp):
    k = np.arange(-4, 5, dtype=float)[:, None] * KV
    jb = jdif.compute_bmatrix(3.0, k - KV if ramp else k, k if ramp else None)
    tb = tdif.compute_bmatrix(3.0, k - KV if ramp else k, k if ramp else None)
    assert np.abs(tb.numpy() - np.asarray(jb)).max() < ATOL * np.abs(
        np.asarray(jb)).max()
    for Dc in (1e-3, DTENSOR):
        for a, b in zip(jdif.diffusion_operator(jb, jb, Dc),
                        tdif.diffusion_operator(tb, tb, Dc)):
            assert np.abs(b.numpy() - np.asarray(a)).max() < ATOL


def test_D_validation():
    with pytest.raises(ValueError):
        tepg.D(4.0, np.ones(3), k=1)
    with pytest.raises(ValueError):
        tepg.D(4.0, np.ones((3, 2)))
    with pytest.raises(ValueError):
        tepg.D(4.0, np.eye(3), k=[1.0, 0.0])


def _dw_train(e, Dc, order1=False):
    d1 = e.D(4.0, Dc, k=1, order1=order1)
    d2 = e.D(4.5, Dc, order1=order1)
    seq = [e.T(90, 90)]
    for i in range(6):
        seq += [e.E(4.0, [800.0, 1400.0], [60.0, 110.0]), e.S(1), d1,
                e.T(100.0 + 8.0 * i, 0.0),
                e.E(4.5, [800.0, 1400.0], [60.0, 110.0]), e.S(1), d2, e.ADC]
    return seq


@pytest.mark.parametrize("Dc", [1.2e-3, DTENSOR], ids=["scalar", "tensor"])
def test_dw_train_general_path_matches_jax(port_f64, Dc):
    got = tepg.simulate(_dw_train(tepg, Dc), kvalue=KV, fisp_kernel=False)
    want = np.asarray(jepg.simulate(_dw_train(jepg, Dc), kvalue=KV,
                                    fisp_kernel=False))
    assert got.shape == want.shape == (6, 2)
    assert np.abs(got - want).max() < 1e-10


def _batched_tau_train(e):
    """tests/test_dwfisp_dispatch.py:101-102's "traced_tau" train: one D
    with a batched tau = [7, 7] after every S(1), 2 atoms x 8 TRs."""
    FA = 10 + 50 * np.abs(np.sin(np.arange(8) / 5.0))
    T1, T2 = np.linspace(600, 1500, 2), np.linspace(50, 120, 2)
    d = e.D(np.array([7.0, 7.0]), 1e-3, k=1)
    seq = []
    for i in range(8):
        seq += [e.T(float(FA[i]), 90.0), e.E(5.0, T1, T2), e.ADC,
                e.E(7.0 + (i % 2), T1, T2), e.S(1), d]
    return seq


def test_batched_tau_train_matches_jax(port_f64):
    """A D op with a batched tau runs on the general path (its tau axes
    lead the ladder axis) and equals the JAX general path; no kernel
    claims the train, so the forced dispatch gives the same values."""
    from epgpy_torch import fisp_dispatch as tfd

    want = np.asarray(jepg.simulate(_batched_tau_train(jepg), max_nstate=6,
                                    kvalue=KV, fisp_kernel=False))
    got = tepg.simulate(_batched_tau_train(tepg), max_nstate=6, kvalue=KV,
                        fisp_kernel=False)
    tfd.DISPATCH_COUNTS.clear()
    forced = tepg.simulate(_batched_tau_train(tepg), max_nstate=6,
                           kvalue=KV, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS == {}
    assert got.shape == forced.shape == want.shape == (8, 2)
    assert np.abs(got - want).max() < 1e-10
    assert np.abs(forced - want).max() < 1e-10


def test_dcoef_jacobian_matches_jax(port_f64):
    """dS/dDcoef through the general diff path (the D op's one
    differentiable parameter) == the JAX general path."""
    probes = lambda e: [e.ADC, e.Jacobian(["Dcoef"])]  # noqa: E731
    got = tepg.simulate(_dw_train(tepg, 1.2e-3, order1=["Dcoef"]),
                        kvalue=KV, fisp_kernel=False, probe=probes(tepg))
    want = jepg.simulate(_dw_train(jepg, 1.2e-3, order1=["Dcoef"]),
                         kvalue=KV, fisp_kernel=False, probe=probes(jepg))
    for a, b in zip(got, want):
        assert a.shape == np.shape(b)
        assert np.abs(a - np.asarray(b)).max() < 1e-8 * max(
            np.abs(np.asarray(b)).max(), 1.0)
    assert np.abs(got[1]).max() > 0
