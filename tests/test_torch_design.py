"""CRLB statistics and MRF sequence design of epgpy_torch vs epgpy_tpu.

* ``stats.crlb`` (without and with the analytic Hessian contraction),
  ``crlb_split`` and ``confint`` equal the JAX functions in float64 on
  seeded random Jacobians and Hessians (1e-10 relative);
* ``mrf_design_loss_grad_fused`` (the per-pulse Hessian kernel's plain
  twin on the CPU, float32) equals autograd of the port's
  ``mrf_design_loss`` and JAX's ``value_and_grad(mrf_design_loss)`` on a
  one-device CPU mesh, to 2e-5 relative on loss, gFA and gTR (NTR 10, 4
  atoms; the JAX test's budget, tests/test_hessian_dispatch.py:248-250);
  the port's autograd oracle equals JAX's to 1e-10;
* ``mrf_design_step`` equals JAX's step, and a 2-iteration
  ``mrf_design_slsqp`` keeps the bounds and the |dFA| <= 1 constraint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epgpy_torch import parallel as tpar
from epgpy_torch import stats as tstats
from epgpy_tpu import parallel as jpar
from epgpy_tpu import stats as jstats

from torch_support import port_f64  # noqa: F401

NTR, NATOMS = 10, 4
RNG = np.random.default_rng(3)
FA = RNG.uniform(12, 58, NTR)
TR = RNG.uniform(11.5, 15.5, NTR)
T1S = RNG.uniform(400.0, 1600.0, NATOMS)
T2S = RNG.uniform(40.0, 120.0, NATOMS)
KW = dict(TE=5.0, nstate=6, inversion=20.0, sigma2=10.0, smooth_weight=1e-3)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _cplx(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


STATS = {
    "crlb": lambda m, J, H, W, obs: m.crlb(J, sigma2=2.0),
    "crlb_weighted_log": lambda m, J, H, W, obs: m.crlb(J, W=W, log=True),
    "crlb_hessian": lambda m, J, H, W, obs: m.crlb(J, H, W=W, sigma2=2.0),
    "crlb_hessian_log": lambda m, J, H, W, obs: m.crlb(J, H, log=True),
    "crlb_split": lambda m, J, H, W, obs: m.crlb_split(J, W=W, sigma2=3.0),
    "confint": lambda m, J, H, W, obs: m.confint(obs, obs * 0.9, J),
    "confint_hessian": lambda m, J, H, W, obs: m.confint(
        obs, obs * 0.9, J, H[..., :3], conflevel=0.9),
}


@pytest.mark.parametrize("name", STATS)
def test_stats_equal_jax(name):
    rng = np.random.default_rng(11)
    J = _cplx(rng, 5, 40, 3)
    H = _cplx(rng, 5, 40, 3, 7)
    W = rng.uniform(0.5, 2.0, 3)
    obs = _cplx(rng, 5, 40)
    want = STATS[name](jstats, jnp.asarray(J), jnp.asarray(H), jnp.asarray(W),
                       jnp.asarray(obs))
    got = STATS[name](tstats, torch.as_tensor(J), torch.as_tensor(H),
                      torch.as_tensor(W), torch.as_tensor(obs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert rel(_host(g), w) < 1e-10


def test_singular_fisher_is_nan():
    J = np.zeros((2, 6, 3), complex)
    J[1] = _cplx(np.random.default_rng(1), 6, 3)
    J[0, :, 0] = 1.0                       # rank 1: singular Fisher
    got = tstats.crlb(torch.as_tensor(J)).numpy()
    want = np.asarray(jstats.crlb(jnp.asarray(J)))
    assert np.isnan(got[0]) and np.isnan(want[0])
    assert rel(got[1], want[1]) < 1e-10


def _jax_loss_grad():
    mesh = jpar.make_mesh(jax.devices("cpu")[:1], axes=("atoms",))
    loss, (gfa, gtr) = jax.value_and_grad(
        lambda fa, tr: jpar.mrf_design_loss(
            fa, tr, jnp.asarray(T1S), jnp.asarray(T2S), mesh, ridge=0.0,
            **KW), argnums=(0, 1))(jnp.asarray(FA), jnp.asarray(TR))
    return loss, gfa, gtr


def test_autograd_oracle_equals_jax(port_f64):
    fa = torch.tensor(FA, requires_grad=True)
    tr = torch.tensor(TR, requires_grad=True)
    loss = tpar.mrf_design_loss(fa, tr, T1S, T2S, ridge=0.0, **KW)
    gfa, gtr = torch.autograd.grad(loss, (fa, tr))
    for g, w in zip((loss.detach(), gfa, gtr), _jax_loss_grad()):
        assert rel(_host(g), w) < 1e-10


def test_fused_design_equals_autograd_and_jax(port_f64):
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa
    got = tpar.mrf_design_loss_grad_fused(f32(FA), f32(TR), f32(T1S),
                                          f32(T2S), **KW)
    fa = torch.tensor(FA, requires_grad=True)
    tr = torch.tensor(TR, requires_grad=True)
    loss = tpar.mrf_design_loss(fa, tr, T1S, T2S, ridge=0.0, **KW)
    oracle = (loss.detach(),) + torch.autograd.grad(loss, (fa, tr))
    for g, o, w in zip(got, oracle, _jax_loss_grad()):
        assert g.dtype == torch.float32
        assert rel(_host(g), _host(o)) < 2e-5
        assert rel(_host(g), w) < 2e-5


def test_design_step_equals_jax(port_f64):
    fa, tr, loss = tpar.mrf_design_step(FA, TR, T1S, T2S, lr_fa=2.0,
                                        lr_tr=0.1, ridge=0.0, **KW)
    mesh = jpar.make_mesh(jax.devices("cpu")[:1], axes=("atoms",))
    jfa, jtr, jloss = jpar.mrf_design_step(
        jnp.asarray(FA), jnp.asarray(TR), jnp.asarray(T1S), jnp.asarray(T2S),
        mesh, lr_fa=2.0, lr_tr=0.1, ridge=0.0, **KW)
    for g, w in ((fa, jfa), (tr, jtr), (loss, jloss)):
        assert rel(_host(g), w) < 1e-10


@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_slsqp_keeps_bounds_and_smoothness(port_f64, engine):
    """Two SLSQP iterations from a feasible smooth train stay inside the
    box and the |FA_i - FA_{i-1}| <= 1 constraint, and lower the loss."""
    fa0 = np.linspace(20.0, 24.5, NTR)
    tr0 = np.full(NTR, 12.0)
    seen = []
    fa, tr, res = tpar.mrf_design_slsqp(
        fa0, tr0, T1S, T2S, maxiter=2, engine=engine,
        callback=lambda xk: seen.append(xk.copy()), **KW)
    assert res.nit <= 2 and len(seen) >= 1
    tol = 1e-6
    assert fa.min() >= 10.0 - tol and fa.max() <= 60.0 + tol
    assert tr.min() >= 11.0 - tol and tr.max() <= 16.0 + tol
    assert np.abs(np.diff(fa)).max() <= 1.0 + tol
    start = tpar.mrf_design_loss_grad_fused(
        torch.as_tensor(fa0, dtype=torch.float32),
        torch.as_tensor(tr0, dtype=torch.float32),
        torch.as_tensor(T1S, dtype=torch.float32),
        torch.as_tensor(T2S, dtype=torch.float32), **KW)[0]
    assert res.fun < float(start)


def test_mesh_is_not_ported(port_f64):
    """The atom-sharded form the port once refused: on a 4-entry CPU mesh
    the fused loss and gradient are the mean of the shards' means, equal
    to ``mesh=None`` (4 atoms, one per shard: 1e-6 relative in float32,
    the means summed in another order) and to JAX's mesh form on four CPU
    devices (2e-5, the fused design's budget above)."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa
    args = (f32(FA), f32(TR), f32(T1S), f32(T2S))
    mesh = tpar.make_mesh([torch.device("cpu")] * NATOMS)
    got = tpar.mrf_design_loss_grad_fused(*args, mesh, **KW)
    single = tpar.mrf_design_loss_grad_fused(*args, **KW)
    jmesh = jpar.make_mesh(jax.devices("cpu")[:NATOMS], axes=("atoms",))
    f = np.float32
    want = jpar.mrf_design_loss_grad_fused(
        jnp.asarray(FA, f), jnp.asarray(TR, f), jnp.asarray(T1S, f),
        jnp.asarray(T2S, f), jmesh, interpret=True, **KW)
    for g, o, w in zip(got, single, want):
        assert g.dtype == torch.float32
        assert rel(_host(g), _host(o)) < 1e-6
        assert rel(_host(g), w) < 2e-5
