"""MRF serving of epgpy_torch (parallel/match.py, parallel/recon.py) vs
epgpy_tpu.parallel, in float64 on the CPU.

The same seeded dictionary and voxels go through both packages: matched
indices must be identical and correlations, proton densities and
compressed atoms agree to 1e-10 (float64 both; only the summation order of
the products differs).  Gauss-Newton refinement through the port's fused
Jacobian dispatch (the kernel's plain twin here) meets the recovery bounds
of tests/test_recon.py:115-165, and with an unknown complex PD its
variable-projection update recovers joint (T1, T2, B1) where the JAX
update drifts (recon.gauss_newton_refine, ``solve_scale``).
"""

import numpy as np
import pytest
import torch

import epgpy_torch as tepg
from epgpy_torch.models.mrf import fisp_mrf_dictionary
from epgpy_torch.parallel import (compress_dictionary, dictionary_match,
                                  full_precision, gauss_newton_refine,
                                  make_mesh, mrf_reconstruct,
                                  project_signals)
from epgpy_torch.parallel.match import _chunked_match
from epgpy_tpu.models import mrf as jmrf
from epgpy_tpu import parallel as jpar

from torch_support import port_f64  # noqa: F401

P = 60
FA = 10 + 50 * np.abs(np.sin(np.arange(P) * 2 * np.pi / 250))
TRv, TEv = 12.0, 5.0


@pytest.fixture(scope="module")
def dict_and_grid():
    T1g = np.linspace(300, 1800, 12)
    T2g = np.linspace(30, 180, 10)
    grid = np.stack(np.meshgrid(T1g, T2g, indexing="ij"), -1).reshape(-1, 2)
    grid = grid[grid[:, 1] < 0.8 * grid[:, 0]]
    dre, dim = jmrf.fisp_mrf_dictionary(FA, TRv, TEv, grid[:, 0], grid[:, 1])
    return np.asarray(dre), np.asarray(dim), grid


def _observations(dre, dim, grid, nvox, seed, noise=1e-4):
    """On-grid voxels with random complex PD scales + noise."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(grid), nvox)
    pd = rng.uniform(0.5, 2.0, nvox) * np.exp(2j * np.pi * rng.random(nvox))
    sig = pd[:, None] * (dre[pick] + 1j * dim[pick])
    sig += noise * (rng.normal(size=sig.shape)
                    + 1j * rng.normal(size=sig.shape))
    return pick, pd, sig.real.copy(), sig.imag.copy()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_port_dictionary_equals_jax(port_f64, dict_and_grid):
    dre, dim, grid = dict_and_grid
    tre, tim = fisp_mrf_dictionary(FA, TRv, TEv, grid[:, 0], grid[:, 1])
    assert np.abs(_np(tre) - dre).max() < 1e-12
    assert np.abs(_np(tim) - dim).max() < 1e-12


def test_dictionary_match_equals_jax(port_f64, dict_and_grid):
    dre, dim, grid = dict_and_grid
    pick, _, sre, sim = _observations(dre, dim, grid, 24, seed=17)
    ji, jv = jpar.dictionary_match(dre, dim, sre, sim)
    ti, tv = dictionary_match(dre, dim, sre, sim)
    assert ti.dtype == torch.int64 and tv.dtype == torch.float64
    assert np.array_equal(_np(ti), np.asarray(ji))
    assert np.abs(_np(tv) - np.asarray(jv)).max() < 1e-10
    # the atom-sharded form (once refused): the dictionary's 120 atoms over
    # an 8-entry CPU mesh give the same indices and correlations
    mesh = make_mesh([torch.device("cpu")] * 8)
    si, sv = dictionary_match(dre, dim, sre, sim, mesh=mesh)
    assert np.array_equal(_np(si), _np(ti))
    assert np.abs(_np(sv) - _np(tv)).max() < 1e-12


@pytest.mark.parametrize("chunk", [7, 16, "B-1", "B+5"])
def test_chunked_match_is_exact(port_f64, dict_and_grid, chunk):
    """Atom-chunked matching (the last window clamps to B - C and overlaps
    the one before it) == the one-shot match, indices and values."""
    dre, dim, grid = dict_and_grid
    B = len(dre)
    C = {"B-1": B - 1, "B+5": B + 5}.get(chunk, chunk)
    _, _, sre, sim = _observations(dre, dim, grid, 24, seed=18)
    i0, v0 = dictionary_match(dre, dim, sre, sim)
    i1, v1 = dictionary_match(dre, dim, sre, sim, atom_chunk=C)
    assert np.array_equal(_np(i0), _np(i1))
    assert np.abs(_np(v0) - _np(v1)).max() < 1e-12
    if C < B:
        t = [torch.as_tensor(a) for a in (dre, dim, sre, sim)]
        i2, _ = _chunked_match(*t, C)
        assert np.array_equal(_np(i2), _np(i0))


def test_compress_and_project_equal_jax(port_f64, dict_and_grid):
    dre, dim, grid = dict_and_grid
    norms = np.sqrt((dre ** 2 + dim ** 2).sum(-1))[:, None]
    j = jpar.compress_dictionary(dre / norms, dim / norms, 24)
    t = compress_dictionary(dre / norms, dim / norms, 24)
    assert abs(t["energy"] - j["energy"]) < 1e-10
    assert t["energy"] > 0.9999
    # bases agree up to a rotation inside the subspace: compare the
    # rotation-invariant Gram of the compressed atoms
    jc = np.asarray(j["cdict_re"]) + 1j * np.asarray(j["cdict_im"])
    tc = _np(t["cdict_re"]) + 1j * _np(t["cdict_im"])
    assert np.abs(tc @ tc.conj().T - jc @ jc.conj().T).max() < 1e-10
    _, _, sre, sim = _observations(dre, dim, grid, 8, seed=19)
    jr, ji = jpar.project_signals(j["basis_re"], j["basis_im"], sre, sim)
    tr, ti = project_signals(j["basis_re"], j["basis_im"], sre, sim)
    assert np.abs(_np(tr) - np.asarray(jr)).max() < 1e-10
    assert np.abs(_np(ti) - np.asarray(ji)).max() < 1e-10


@pytest.mark.parametrize("kw", [dict(), dict(rank=24), dict(atom_chunk=13)],
                         ids=["full", "rank24", "chunk13"])
def test_mrf_reconstruct_equals_jax(port_f64, dict_and_grid, kw):
    dre, dim, grid = dict_and_grid
    pick, pd, sre, sim = _observations(dre, dim, grid, 40, seed=3)
    j = jpar.mrf_reconstruct(sre, sim, dre, dim, grid, **kw)
    t = mrf_reconstruct(sre, sim, dre, dim, grid, **kw)
    assert np.array_equal(_np(t["index"]), np.asarray(j["index"]))
    assert np.array_equal(_np(t["index"]), pick)
    for k in ("corr", "pd_re", "pd_im", "maps"):
        assert np.abs(_np(t[k]) - np.asarray(j[k])).max() < 1e-10, k
    pd_hat = _np(t["pd_re"]) + 1j * _np(t["pd_im"])
    assert np.allclose(pd_hat, pd, rtol=1e-2, atol=1e-3)
    if "rank" in kw:
        assert abs(t["energy"] - j["energy"]) < 1e-10


def test_dictionary_free_reconstruct(port_f64, dict_and_grid):
    """A compression that carries per-atom norms serves without the
    (B, P) dictionary: same matches, PD within the discarded energy."""
    dre, dim, grid = dict_and_grid
    norms = np.sqrt((dre ** 2 + dim ** 2).sum(-1))
    comp = compress_dictionary(dre / norms[:, None], dim / norms[:, None], 24)
    comp["norms"] = norms
    pick, pd, sre, sim = _observations(dre, dim, grid, 32, seed=11)
    free = mrf_reconstruct(sre, sim, None, None, grid, compression=comp)
    full = mrf_reconstruct(sre, sim, dre, dim, grid)
    assert np.array_equal(_np(free["index"]), _np(full["index"]))
    pd_free = _np(free["pd_re"]) + 1j * _np(free["pd_im"])
    assert np.allclose(pd_free, pd, rtol=2e-2, atol=1e-3)
    with pytest.raises(ValueError):
        mrf_reconstruct(sre, sim, None, None, grid)


def test_full_precision_restores_setting():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with full_precision():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)


def _signal_and_jac(theta):
    """The FISP train built from theta on the host; simulate() with a
    Jacobian probe takes the fused Jacobian dispatch (the kernel's plain
    twin on the CPU)."""
    T1, T2 = theta
    seq = []
    for k in range(P):
        seq += [tepg.T(float(FA[k]), 90.0),
                tepg.E(TEv, T1, T2, order1=["T1", "T2"]), tepg.ADC,
                tepg.E(TRv - TEv, T1, T2, order1=["T1", "T2"]), tepg.S(1)]
    sig, jac = tepg.simulate(seq, max_nstate=10, fisp_kernel="force",
                             probe=[tepg.ADC, tepg.Jacobian(["T1", "T2"])])
    return (sig.real, sig.imag), (jac.real, jac.imag)


def test_gauss_newton_refine_off_grid(port_f64, dict_and_grid):
    """tests/test_recon.py:115-165 on the port: refinement from the grid
    match cuts the error fivefold, with and without an unknown complex
    proton density."""
    from epgpy_torch import fisp_dispatch

    dre, dim, grid = dict_and_grid
    rng = np.random.default_rng(6)
    nvox = 12
    T1t = rng.uniform(400, 1600, nvox)
    T2t = np.minimum(rng.uniform(40, 160, nvox), 0.6 * T1t)
    r, i = fisp_mrf_dictionary(FA, TRv, TEv, T1t, T2t)
    tre, tim = _np(r).T, _np(i).T                       # (P, V)
    out = mrf_reconstruct(tre.T, tim.T, dre, dim, grid)
    theta0 = _np(out["maps"]).T                          # (2, V)
    err0 = np.hypot(theta0[0] - T1t, theta0[1] - T2t)

    before = fisp_dispatch.DISPATCH_COUNTS.get("jac:fisp", 0)
    theta = gauss_newton_refine(_signal_and_jac, theta0, tre, tim, iters=5,
                                bounds=[(200, 2000), (20, 250)])
    assert fisp_dispatch.DISPATCH_COUNTS.get("jac:fisp", 0) == before + 5
    err1 = np.hypot(theta[0] - T1t, theta[1] - T2t)
    assert err1.mean() < 0.2 * err0.mean(), (err0.mean(), err1.mean())
    assert np.abs(theta[0] - T1t).max() < 5.0
    assert np.abs(theta[1] - T2t).max() < 1.0

    rng2 = np.random.default_rng(8)
    pd = rng2.uniform(0.5, 2.0, nvox) * np.exp(2j * np.pi * rng2.random(nvox))
    scaled = (tre + 1j * tim) * pd[None, :]
    theta2 = gauss_newton_refine(_signal_and_jac, theta0, scaled.real,
                                 scaled.imag, iters=5,
                                 bounds=[(200, 2000), (20, 250)],
                                 solve_scale=True)
    err2 = np.hypot(theta2[0] - T1t, theta2[1] - T2t)
    assert err2.mean() < 0.2 * err0.mean(), (err0.mean(), err2.mean())


def test_gauss_newton_refine_b1_unknown_pd(port_f64):
    """Joint (T1, T2, B1) refinement with an unknown complex PD
    (solve_scale=True) from half a dictionary step off: the port's
    variable-projection update (Jacobian projected orthogonal to the
    model signal) recovers noise-free truth to the float32 Jacobian's
    precision; the JAX update, which leaves the scale direction in the
    Jacobian, does not (it drifts in B1)."""
    import chip_smoke as cs
    from epgpy_tpu.parallel import gauss_newton_refine as jax_gn

    V, npulse = 24, 200
    rng = np.random.default_rng(12)
    T1t = rng.uniform(400.0, 1600.0, V)
    T2t = np.minimum(rng.uniform(40.0, 160.0, V), 0.5 * T1t)
    B1t = rng.uniform(0.8, 1.2, V)
    truth = np.stack([T1t, T2t, B1t])
    pd = rng.uniform(0.5, 2.0, V) * np.exp(2j * np.pi * rng.random(V))
    FA = cs.make_train(npulse)
    meas = tepg.simulate(cs.fisp_sequence(tepg, FA, T1t, T2t, B1t),
                         max_nstate=10) * pd
    step = np.array([63.0, 6.3, 0.013])[:, None]      # the smoke grid's
    theta0 = truth + step * rng.uniform(-0.5, 0.5, (3, V))

    def signal_and_jac(theta):
        sig, jac = tepg.simulate(
            cs.fisp_sequence(tepg, FA, *theta, tracked=True), max_nstate=10,
            fisp_kernel="force",
            probe=[tepg.ADC, tepg.Jacobian(["T1", "T2", "B1"])])
        return (sig.real, sig.imag), (jac.real, jac.imag)

    kw = dict(iters=5, solve_scale=True,
              bounds=[(100.0, 4000.0), (5.0, 400.0), (0.5, 1.5)])
    theta = gauss_newton_refine(signal_and_jac, theta0, meas.real,
                                meas.imag, **kw)
    err = np.abs(theta - truth).max(axis=1)
    assert err[0] < 0.1 and err[1] < 0.01 and err[2] < 1e-5, err
    jerr = np.abs(jax_gn(signal_and_jac, theta0, meas.real, meas.imag, **kw)
                  - truth).max(axis=1)
    assert jerr[2] > 1e-3, jerr
