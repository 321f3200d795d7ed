"""The 1-D inverse Laplace transform of epgpy_torch
(``epgpy_torch/utils/ilt1d.py``) against the JAX package
(``epgpy_tpu/utils/ilt1d.py``): tests/test_utils.py's ilt1d cases run
through the port, the refinement (``ilt1d_ls``, torch.autograd) and the
Cramer-Rao bounds (``ilt1d_crb``, torch.func.jacfwd) held to JAX's within
1e-8, and examples/diffusion_exchange.py's two exchange ILT functions run
through the port with the example's asserts.
"""

import numpy as np
import pytest

import epgpy_torch as tepg
import epgpy_torch.utils.ilt1d as ilt
import epgpy_tpu.utils.ilt1d as jilt

from torch_support import port_f64  # noqa: F401


def test_ilt1d_two_components():
    t = np.linspace(0, 200, 120)
    y = 0.7 * np.exp(-t / 25) + 0.3 * np.exp(-t / 90)
    r, a = ilt.ilt1d(t, y)
    assert len(r) == 2
    assert np.allclose(np.sort(1 / r), [25.0, 90.0], rtol=1e-4)
    assert np.allclose(np.sort(a), [0.3, 0.7], rtol=1e-4)


def test_ilt1d_forward_roundtrip():
    t = np.linspace(0, 100, 80)
    r0, a0 = np.asarray([0.05, 0.01]), np.asarray([0.4, 0.6])
    y = ilt.flt1d(t, r0, a0)
    r, a = ilt.ilt1d(t, y)
    assert np.abs(ilt.flt1d(t, r, a) - y).max() < 1e-8


def test_ilt1d_crb_and_spectrum():
    t = np.linspace(0, 150, 100)
    y = np.exp(-t / 40)
    r, a = ilt.ilt1d(t, y)
    sd_r, sd_a = ilt.ilt1d_crb(t, y + 1e-6, r, a)
    assert np.all(np.isfinite(sd_r)) and np.all(np.isfinite(sd_a))
    grid, spec = ilt.quasi_continuous(r, a)
    assert spec.max() > 0
    assert np.isclose(grid[np.argmax(spec)], r[0], rtol=0.1)


def test_ilt1d_custom_kernel_sizes_pencil():
    """A user kernel with fewer time rows shrinks the Hankel pencil
    window (reference: L = kernel.shape[0] // 2)."""
    t = np.linspace(0, 200, 120)
    y = 0.7 * np.exp(-t / 25) + 0.3 * np.exp(-t / 90)
    _, kernel = ilt.get_kernel(t[:40], ilt.get_bounds(t), 12)
    r, a = ilt.ilt1d(t, y, kernel=kernel)
    assert np.allclose(np.sort(1 / r), [25.0, 90.0], rtol=1e-3)


def test_ilt1d_irregular_raises():
    t = np.asarray([0.0, 1.0, 3.0, 4.0])
    with pytest.raises(ValueError):
        ilt.ilt1d(t, np.exp(-t))
    with pytest.raises(ValueError):
        ilt.ilt1d(t[:3], np.exp(-t))


def test_ilt1d_direct_amplitudes_unbiased():
    """ls=False residues from the shifted Hankel divide out the one-step
    decay."""
    t = np.arange(0, 50.5, 0.5)
    y = 1.0 * np.exp(-0.05 * t) + 0.8 * np.exp(-0.5 * t)
    rates, amps = ilt.ilt1d(t, y, ls=False)
    order = np.argsort(rates)
    assert np.allclose(rates[order], [0.05, 0.5], atol=1e-6)
    assert np.allclose(amps[order], [1.0, 0.8], atol=1e-6)


def test_kernel_sizing_matches_jax():
    t = np.linspace(0.5, 300.0, 90)
    b = ilt.get_bounds(t)
    assert b == jilt.get_bounds(t)
    assert ilt.get_resolution(t, b) == jilt.get_resolution(t, b)
    r, K = ilt.get_kernel(t, b, 17)
    rj, Kj = jilt.get_kernel(t, b, 17)
    assert np.array_equal(r, rj) and np.array_equal(K, Kj)


@pytest.mark.parametrize("ls", [True, False])
def test_ilt1d_matches_jax(ls):
    rng = np.random.default_rng(2)
    t = np.linspace(0, 250, 150)
    y = 0.5 * np.exp(-t / 18) + 0.35 * np.exp(-t / 70) + 0.15 * np.exp(
        -t / 200) + 1e-5 * rng.standard_normal(t.size)
    r, a = ilt.ilt1d(t, y, ls=ls)
    rj, aj = jilt.ilt1d(t, y, ls=ls)
    assert r.shape == np.asarray(rj).shape
    np.testing.assert_allclose(r, rj, rtol=1e-8)
    np.testing.assert_allclose(a, aj, rtol=1e-8)


def test_ilt1d_ls_matches_jax():
    """The variable-projection refinement from the same start: the rates
    and amplitudes agree with JAX's within 1e-8."""
    t = np.linspace(0, 200, 100)
    y = 0.6 * np.exp(-t / 30) + 0.4 * np.exp(-t / 110)
    start = np.array([1 / 27.0, 1 / 120.0])
    r, a = ilt.ilt1d_ls(t, y, start)
    rj, aj = jilt.ilt1d_ls(t, y, start)
    np.testing.assert_allclose(r, rj, rtol=1e-8)
    np.testing.assert_allclose(a, aj, rtol=1e-8)
    np.testing.assert_allclose(np.sort(1 / r), [30.0, 110.0], rtol=1e-2)


def test_vp_cost_gradient_matches_jax():
    """The cost and its autograd gradient against jax.value_and_grad."""
    import jax
    import jax.numpy as jnp
    import torch

    t = np.linspace(0, 100, 60)
    y = np.exp(-t / 20) + 0.5 * np.exp(-t / 60)
    lr = np.log([0.04, 0.02, 0.01])
    vj, gj = jax.value_and_grad(lambda x: jilt._vp_cost(
        x, jnp.asarray(t), jnp.asarray(y)))(jnp.asarray(lr))
    x = torch.tensor(lr, dtype=torch.float64, requires_grad=True)
    v = ilt._vp_cost(x, torch.as_tensor(t), torch.as_tensor(y))
    (g,) = torch.autograd.grad(v, x)
    assert abs(float(v.detach()) - float(vj)) <= 1e-8 * abs(float(vj))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("sigma2", [None, 1e-6])
def test_ilt1d_crb_matches_jax(sigma2):
    rng = np.random.default_rng(6)
    t = np.linspace(0, 150, 100)
    rates, amps = np.array([0.05, 0.012]), np.array([0.45, 0.55])
    y = ilt.flt1d(t, rates, amps) + 1e-4 * rng.standard_normal(t.size)
    sd = ilt.ilt1d_crb(t, y, rates, amps, sigma2=sigma2)
    sdj = jilt.ilt1d_crb(t, y, rates, amps, sigma2=sigma2)
    for got, want in zip(sd, sdj):
        np.testing.assert_allclose(got, want, rtol=1e-8)


def test_quasi_continuous_matches_jax():
    rates, amps = np.array([0.02, 0.3]), np.array([1.0, 0.4])
    for kw in ({}, dict(rgrid=np.logspace(-3, 0, 50), width=0.1)):
        g, s = ilt.quasi_continuous(rates, amps, **kw)
        gj, sj = jilt.quasi_continuous(rates, amps, **kw)
        assert np.array_equal(g, gj)
        np.testing.assert_allclose(s, sj, rtol=1e-12)


def test_public_names():
    """ilt1d at the package's top level and in the flat namespace; the
    helpers in utils, as in JAX."""
    from epgpy_torch import utils

    assert tepg.ilt1d is ilt.ilt1d and tepg.epg.ilt1d is ilt.ilt1d
    for name in ("ilt1d_ls", "flt1d", "ilt1d_crb", "quasi_continuous"):
        assert getattr(utils, name) is getattr(ilt, name)
    assert utils.ilt1d is ilt                  # the module, not shadowed


def test_relaxation_exchange_ilt(port_f64):
    """examples/diffusion_exchange.py relaxation_exchange_ilt through the
    port: exchange-mixed T1 components from a mixing-time sweep (the
    example prints them; they are held here to JAX's)."""
    import epgpy_tpu as jepg

    def run(e, inv):
        taus = np.linspace(1.0, 2500.0, 160)
        X = e.X(taus[None, :], 0.0005, axis=-1,
                T1=[1200.0, 250.0], T2=[80.0, 20.0])
        sm = e.StateMatrix(shape=(2, 1), density=[[0.6], [0.4]])
        seq = [e.T(90, 90), e.SPOILER, X, e.T(90, 90), e.ADC]
        sig = np.asarray(e.simulate(seq, init=sm))[0]
        total = np.abs(sig.sum(axis=0))
        decay = total.max() - total
        return inv(taus, decay + 1e-12)

    rates, amps = run(tepg, ilt.ilt1d)
    rj, aj = run(jepg, jilt.ilt1d)
    assert len(rates) == 2
    np.testing.assert_allclose(np.sort(1 / rates), np.sort(1 / rj),
                               rtol=1e-6)
    assert np.all(amps > 0)


def test_cpmg_relaxation_exchange(port_f64):
    """examples/diffusion_exchange.py cpmg_relaxation_exchange through the
    port, with the example's asserts: both T2s resolved at slow exchange,
    a single harmonic mean at fast exchange."""
    T2a, T2b = 2.5, 25.0
    rates = np.geomspace(1e-3, 10.0, 8)
    TE, necho = 0.1, 200
    khi = tepg.exchange_matrix(rates, axis=1, ncomp=2)
    xt = tepg.X(TE / 2, khi, T2=[[T2a, T2b]], axis=1, duration=True)
    seq = [tepg.T(90, 90)] + [xt, tepg.T(180, 0), xt, tepg.ADC] * necho
    sig = np.asarray(tepg.simulate(seq))
    total = 0.5 * (sig[..., 0] + sig[..., 1]).real
    times = TE * np.arange(1, necho + 1)
    apparent = [np.sort(1 / ilt.ilt1d(times, total[:, i])[0])
                for i in range(len(rates))]
    assert np.allclose(apparent[0], [T2a, T2b], rtol=0.05)
    t2_mean = 1.0 / (0.5 * (1 / T2a + 1 / T2b))
    assert len(apparent[-1]) == 1
    assert np.isclose(apparent[-1][0], t2_mean, rtol=0.05)
