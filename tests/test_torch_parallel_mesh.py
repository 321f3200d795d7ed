"""The atom-sharded match, reconstruction and CRLB design of epgpy_torch
against epgpy_tpu's mesh forms, in float64 on the CPU unless a test says.

The port's mesh has 8 (or 4) CPU entries, JAX's as many virtual CPU
devices (tests/conftest.py); both get the same seeded inputs.

* ``dictionary_match`` and ``mrf_reconstruct`` (tests/test_parallel.py:
  105-171, tests/test_recon.py:95-106): indices equal, correlations within
  1e-12 (a rank-12 compressed reconstruction: 1e-10 of JAX's, the serving
  budget of tests/test_torch_serving.py, the two eigendecompositions
  differing in rounding); a tie across shards and one inside a shard go
  to the lowest atom; ``atom_chunk`` applies per shard; the compression
  stays global;
* ``fingerprint_crlb_loss`` on (4, 2) and (1,) meshes, the FA-train term
  on a 7-pulse train over 2 tangent shards included, and
  ``crlb_train_step`` on (4, 2): rtol 1e-9 (tests/test_parallel.py:22-66);
* ``mrf_design_step`` and ``mse_design_loss_grad_fused`` on a 4-entry
  mesh against ``mesh=None`` and JAX's mesh forms, at the budgets of
  tests/test_torch_design.py and tests/test_torch_msedesign.py; the two
  SLSQP solvers run with a mesh;
* examples/sequence_optimization.py through the port (mesh (4, 2), 16
  pulses, nstate 4, ``fa_weight=0``; 3 steps of its 20) and the
  ``mrf_design_step`` path of examples/optim_mrf.py (16 atoms on 8
  entries, the example's initial train cut to 20 TRs from 400, 2 steps)
  against JAX.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epgpy_torch import parallel as tpar
from epgpy_tpu import parallel as jpar
from epgpy_tpu.models import mrf as jmrf

from torch_support import port_f32, port_f64  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_mesh(n, **kw):
    return tpar.make_mesh([torch.device("cpu")] * n, **kw)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def dictionary():
    """64 normalized FISP atoms x 24 pulses (nstate 4), and 32 noisy
    voxels of random atoms with random complex scales."""
    FA = np.linspace(10, 60, 24)
    T1, T2 = np.meshgrid(np.linspace(300, 1500, 8), np.linspace(30, 120, 8))
    re, im = jmrf.fisp_mrf_dictionary(FA, 12.0, 5.0, T1.ravel(), T2.ravel(),
                                      nstate=4, normalize=True)
    re, im = np.asarray(re), np.asarray(im)
    rng = np.random.default_rng(0)
    pick = rng.integers(0, 64, 32)
    pd = rng.uniform(0.5, 2.0, 32) * np.exp(2j * np.pi * rng.random(32))
    sig = pd[:, None] * (re[pick] + 1j * im[pick])
    sig += 1e-3 * (rng.normal(size=sig.shape)
                   + 1j * rng.normal(size=sig.shape))
    grid = np.stack([T1.ravel(), T2.ravel()], -1)
    return re, im, sig.real.copy(), sig.imag.copy(), grid


@pytest.mark.parametrize("atom_chunk", [None, 3])
def test_sharded_match_equals_jax(port_f64, cpu_devices, dictionary,
                                  atom_chunk):
    re, im, sre, sim, _ = dictionary
    jmesh = jpar.make_mesh(cpu_devices, axes=("atoms",))
    ji, jv = jpar.dictionary_match(jnp.asarray(re), jnp.asarray(im),
                                   jnp.asarray(sre), jnp.asarray(sim), jmesh,
                                   atom_chunk=atom_chunk)
    ti, tv = tpar.dictionary_match(re, im, sre, sim, cpu_mesh(8),
                                   atom_chunk=atom_chunk)
    i0, v0 = tpar.dictionary_match(re, im, sre, sim)
    assert ti.dtype == torch.int64 and tv.dtype == torch.float64
    assert np.array_equal(_np(ti), np.asarray(ji))
    assert np.array_equal(_np(ti), _np(i0))
    assert np.abs(_np(tv) - np.asarray(jv)).max() < 1e-12
    assert np.abs(_np(tv) - _np(v0)).max() < 1e-12


def test_sharded_match_ties_go_to_the_lowest_atom(port_f64, cpu_devices,
                                                  dictionary):
    """Atom 3 is copied to atom 13 (another shard) and atom 20 to atom 21
    (the same shard of 8): voxels of those atoms match 3 and 20, as JAX's
    argmax over the gathered values gives."""
    re, im = (x.copy() for x in dictionary[:2])
    re[13], im[13] = re[3], im[3]
    re[21], im[21] = re[20], im[20]
    sre, sim = re[[13, 3, 21, 20]] * 1.5, im[[13, 3, 21, 20]] * 1.5
    jmesh = jpar.make_mesh(cpu_devices, axes=("atoms",))
    ji, _ = jpar.dictionary_match(jnp.asarray(re), jnp.asarray(im),
                                  jnp.asarray(sre), jnp.asarray(sim), jmesh)
    ti, _ = tpar.dictionary_match(re, im, sre, sim, cpu_mesh(8))
    assert list(_np(ti)) == list(np.asarray(ji)) == [3, 3, 20, 20]


@pytest.mark.parametrize("rank", [None, 12])
def test_sharded_reconstruct_equals_jax(port_f64, cpu_devices, dictionary,
                                        rank):
    re, im, sre, sim, grid = dictionary
    # unnormalized atoms: the reconstruction normalizes (and compresses
    # over all atoms, not per shard)
    scale = np.linspace(0.5, 2.0, len(re))[:, None]
    dre, dim = re * scale, im * scale
    jmesh = jpar.make_mesh(cpu_devices, axes=("atoms",))
    want = jpar.mrf_reconstruct(sre, sim, dre, dim, grid, mesh=jmesh,
                                rank=rank)
    got = tpar.mrf_reconstruct(sre, sim, dre, dim, grid, mesh=cpu_mesh(8),
                               rank=rank)
    single = tpar.mrf_reconstruct(sre, sim, dre, dim, grid, rank=rank)
    assert np.array_equal(_np(got["index"]), np.asarray(want["index"]))
    assert np.array_equal(_np(got["index"]), _np(single["index"]))
    assert np.array_equal(_np(got["maps"]), np.asarray(want["maps"]))
    for key in ("corr", "pd_re", "pd_im"):
        assert np.abs(_np(got[key]) - np.asarray(want[key])).max() < \
            (1e-12 if rank is None else 1e-10)
        assert np.abs(_np(got[key]) - _np(single[key])).max() < 1e-12


T1S, T2S = np.linspace(400, 1400, 8), np.linspace(40, 110, 8)


@pytest.mark.parametrize("shape,npulse,fa_weight", [
    ((4, 2), 8, 0.0), ((4, 2), 8, 1e-3), ((1,), 8, 1e-3), ((4, 2), 7, 1.0)])
def test_fingerprint_crlb_loss_equals_jax(port_f64, cpu_devices, shape,
                                          npulse, fa_weight):
    axes = ("atoms", "tangents")[:len(shape)]
    n = int(np.prod(shape))
    FA = np.linspace(20, 60, npulse)
    jmesh = jpar.make_mesh(cpu_devices[:n], axes=axes, shape=shape)
    want = jpar.fingerprint_crlb_loss(jnp.asarray(FA), T1S, T2S, jmesh,
                                      nstate=3, fa_weight=fa_weight)
    got = tpar.fingerprint_crlb_loss(FA, T1S, T2S,
                                     cpu_mesh(n, axes=axes, shape=shape),
                                     nstate=3, fa_weight=fa_weight)
    assert got.dtype == torch.float64 and got.ndim == 0
    assert rel(got, want) < 1e-9


def test_crlb_train_step_equals_jax(port_f64, cpu_devices):
    FA = np.linspace(20, 60, 8)
    jmesh = jpar.make_mesh(cpu_devices, axes=("atoms", "tangents"),
                           shape=(4, 2))
    mesh = cpu_mesh(8, axes=("atoms", "tangents"), shape=(4, 2))
    jfa, jloss = jax.jit(lambda fa: jpar.crlb_train_step(
        fa, T1S, T2S, jmesh, lr=0.1, nstate=3))(jnp.asarray(FA))
    fa, loss = tpar.crlb_train_step(FA, T1S, T2S, mesh, lr=0.1, nstate=3)
    assert rel(fa, jfa) < 1e-9 and rel(loss, jloss) < 1e-9
    assert not np.allclose(_np(fa), FA)
    after = tpar.fingerprint_crlb_loss(fa, T1S, T2S, mesh, nstate=3)
    assert float(after) <= float(loss) * (1 + 1e-6)


#: tests/test_torch_design.py's MRF design inputs
NTR = 10
RNG = np.random.default_rng(3)
FA_D = RNG.uniform(12, 58, NTR)
TR_D = RNG.uniform(11.5, 15.5, NTR)
T1_D = RNG.uniform(400.0, 1600.0, 4)
T2_D = RNG.uniform(40.0, 120.0, 4)
KW_D = dict(TE=5.0, nstate=6, inversion=20.0, sigma2=10.0,
            smooth_weight=1e-3)


def test_design_step_with_mesh(port_f64, cpu_devices):
    step = dict(lr_fa=2.0, lr_tr=0.1, ridge=0.0, **KW_D)
    got = tpar.mrf_design_step(FA_D, TR_D, T1_D, T2_D, cpu_mesh(4), **step)
    single = tpar.mrf_design_step(FA_D, TR_D, T1_D, T2_D, **step)
    jmesh = jpar.make_mesh(cpu_devices[:4], axes=("atoms",))
    want = jax.jit(lambda fa, tr: jpar.mrf_design_step(
        fa, tr, jnp.asarray(T1_D), jnp.asarray(T2_D), jmesh, **step))(
        jnp.asarray(FA_D), jnp.asarray(TR_D))
    for g, s, w in zip(got, single, want):
        assert rel(g, s) < 1e-12
        assert rel(g, w) < 1e-10


def test_tse_design_with_mesh(port_f32, cpu_devices):
    """mse_design_loss_grad_fused over 4 atoms on 4 entries: within 1e-6
    of ``mesh=None`` (the same float32 values, the mean taken over the
    shards' means) and 1e-5 of JAX's mesh form (interpret mode; the
    budget of tests/test_torch_msedesign.py)."""
    rng = np.random.default_rng(5)
    FA, ESP = rng.uniform(90, 170, 8), rng.uniform(7, 12, 8)
    T1, T2 = np.array([600.0, 900.0, 1200.0, 1400.0]), np.array(
        [45.0, 60.0, 80.0, 110.0])
    f32 = np.float32
    got = tpar.mse_design_loss_grad_fused(FA, ESP, T1, T2, cpu_mesh(4),
                                          nstate=16)
    single = tpar.mse_design_loss_grad_fused(FA, ESP, T1, T2, nstate=16)
    jmesh = jpar.make_mesh(cpu_devices[:4], axes=("atoms",))
    want = jax.jit(lambda *a: jpar.mse_design_loss_grad_fused(
        *a, jmesh, nstate=16, interpret=True))(
        *(jnp.asarray(x, f32) for x in (FA, ESP, T1, T2)))
    for g, s, w in zip(got, single, want):
        assert g.dtype == torch.float32
        assert rel(g, s) < 1e-6
        assert rel(g, w) < 1e-5


def test_slsqp_solvers_take_a_mesh(port_f64):
    """Both SLSQP solvers run with a mesh, to the same iterates as without
    one (float32 kernels: 1e-4 of the parameters)."""
    fa0, tr0 = np.linspace(20.0, 24.5, NTR), np.full(NTR, 12.0)
    kw = dict(maxiter=2, engine="fused", **KW_D)
    fa, tr, _ = tpar.mrf_design_slsqp(fa0, tr0, T1_D, T2_D, cpu_mesh(4),
                                      **kw)
    fa1, tr1, _ = tpar.mrf_design_slsqp(fa0, tr0, T1_D, T2_D, **kw)
    assert rel(fa, fa1) < 1e-4 and rel(tr, tr1) < 1e-4
    esp0, fa0 = np.full(8, 9.0), np.full(8, 150.0)
    T1, T2 = np.array([700.0, 1300.0]), np.array([50.0, 100.0])
    kw = dict(maxiter=2, nstate=16, sar_budget=0.5)
    fa, esp, _ = tpar.tse_design_slsqp(fa0, esp0, T1, T2, cpu_mesh(2), **kw)
    fa1, esp1, _ = tpar.tse_design_slsqp(fa0, esp0, T1, T2, **kw)
    assert rel(fa, fa1) < 1e-4 and rel(esp, esp1) < 1e-4


def test_sequence_optimization_example(port_f64, cpu_devices):
    """examples/sequence_optimization.py at its CPU widths (its (4, 2)
    mesh over 8 devices, 32 atoms, 16 pulses, nstate 4, fa_weight 0, lr
    2.0), 3 steps of its 20: every step's FA and loss within 1e-9 of
    JAX's, and the loss falls."""
    jmesh = jpar.make_mesh(cpu_devices, axes=("atoms", "tangents"),
                           shape=(4, 2))
    mesh = cpu_mesh(8, axes=("atoms", "tangents"), shape=(4, 2))
    T1s, T2s = np.linspace(400.0, 1400.0, 32), np.linspace(40.0, 110.0, 32)
    opts = dict(nstate=4, fa_weight=0.0)
    jstep = jax.jit(lambda fa: jpar.crlb_train_step(fa, T1s, T2s, jmesh,
                                                    lr=2.0, **opts))
    jfa = fa = np.full(16, 30.0)
    loss0 = tpar.fingerprint_crlb_loss(fa, T1s, T2s, mesh, **opts)
    for _ in range(3):
        jfa, jloss = jstep(jnp.asarray(jfa))
        fa, loss = tpar.crlb_train_step(fa, T1s, T2s, mesh, lr=2.0, **opts)
        assert rel(fa, jfa) < 1e-9 and rel(loss, jloss) < 1e-9
    assert float(tpar.fingerprint_crlb_loss(fa, T1s, T2s, mesh, **opts)) \
        < float(loss0)


def test_optim_mrf_example_design_steps(port_f64, cpu_devices):
    """examples/optim_mrf.py's projected-gradient path (mrf_design_step,
    nstate 10, smooth_weight 1e-3, lr_fa 2.0, lr_tr 0.1) over its 16
    atoms on 8 entries, from its initial train cut to 20 TRs: 2 steps,
    each within 1e-10 of JAX's on an 8-device mesh."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import optim_mrf
    finally:
        sys.path.pop(0)
    FA0, TR0 = optim_mrf.initial_train(20)
    rng = np.random.default_rng(1)
    T1s, T2s = rng.uniform(400.0, 1600.0, 16), rng.uniform(40.0, 120.0, 16)
    opts = dict(nstate=10, smooth_weight=1e-3, lr_fa=2.0, lr_tr=0.1)
    jmesh = jpar.make_mesh(cpu_devices, axes=("atoms",))
    jstep = jax.jit(lambda fa, tr: jpar.mrf_design_step(
        fa, tr, jnp.asarray(T1s), jnp.asarray(T2s), jmesh, **opts))
    fa, tr, jfa, jtr = FA0, TR0, jnp.asarray(FA0), jnp.asarray(TR0)
    for _ in range(2):
        jfa, jtr, jloss = jstep(jfa, jtr)
        fa, tr, loss = tpar.mrf_design_step(fa, tr, T1s, T2s, cpu_mesh(8),
                                            **opts)
        for g, w in ((fa, jfa), (tr, jtr), (loss, jloss)):
            assert rel(g, w) < 1e-10
