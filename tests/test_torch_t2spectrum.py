"""EPG-NNLS T2 spectra / MWF mapping of epgpy_torch
(``epgpy_torch/parallel/t2spectrum.py``) against the JAX package
(``epgpy_tpu/parallel/t2spectrum.py``) and scipy's NNLS, in float64 on
the CPU.

The five cases of tests/test_t2spectrum.py run through the port; the basis
and the maps are held to JAX's on the same numpy inputs; the fit is
checked never to broadcast the Gram over voxels.
"""

import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from epgpy_torch import fisp_dispatch
from epgpy_torch.models.mse import cpmg_sequence
from epgpy_torch.parallel import nnls, t2_basis, t2_spectrum_map
from epgpy_torch.parallel import t2spectrum as tt2
from epgpy_tpu.parallel import t2spectrum as jt2

from torch_support import port_f64  # noqa: F401


def test_nnls_matches_scipy(port_f64):
    scipy_opt = pytest.importorskip("scipy.optimize")
    rng = np.random.default_rng(0)
    m, n = 24, 8
    for _ in range(5):
        A = np.abs(rng.normal(size=(m, n))) + 0.1
        y = rng.normal(size=m) + A @ np.abs(rng.normal(size=n))
        x = nnls(A, y, iters=3000).numpy()
        x_ref, _ = scipy_opt.nnls(A, y)
        # compare objective values (solutions may tie in flat directions)
        f = np.sum((A @ x - y) ** 2)
        f_ref = np.sum((A @ x_ref - y) ** 2)
        assert f <= f_ref * (1 + 1e-6) + 1e-10
        assert np.all(x >= 0)


def test_nnls_batched_and_regularized(port_f64):
    rng = np.random.default_rng(1)
    A = np.abs(rng.normal(size=(3, 10, 4))) + 0.1
    y = np.einsum("bmn,bn->bm", A, np.abs(rng.normal(size=(3, 4))))
    x = nnls(A, y, iters=2000).numpy()
    assert x.shape == (3, 4)
    resid = np.linalg.norm(np.einsum("bmn,bn->bm", A, x) - y)
    assert resid < 1e-4
    # Tikhonov shrinks the solution
    x_reg = nnls(A, y, reg=10.0, iters=2000).numpy()
    assert np.sum(x_reg) < np.sum(x)


def test_t2_basis_shapes_and_decay(port_f64):
    t2grid = np.array([20.0, 80.0, 300.0])
    basis = t2_basis(8, 10.0, t2grid, [0.8, 1.0], T1=1000.0)
    assert basis.shape == (2, 8, 3)
    # echoes decay monotonically for an ideal 180 train
    assert np.all(np.diff(basis[1], axis=0) < 0)
    # longer T2 decays slower: later-echo ratio increases with T2
    ratio = basis[1, -1] / basis[1, 0]
    assert np.all(np.diff(ratio) > 0)
    # B1 < 1 loses signal into stimulated pathways at the first echo
    assert basis[0, 0, 0] < basis[1, 0, 0]


def test_mwf_mapping_recovers_components(port_f64):
    necho, esp = 32, 10.0
    t2grid = np.geomspace(15.0, 2000.0, 40)
    b1grid = np.array([0.85, 1.0])
    basis = t2_basis(necho, esp, t2grid, b1grid, T1=1000.0)

    # two-pool voxels: myelin water (T2=20 ms, fraction f) + IE water
    # (T2=80 ms), simulated from the same EPG basis columns at B1=0.85
    i_my = int(np.argmin(np.abs(t2grid - 20.0)))
    i_ie = int(np.argmin(np.abs(t2grid - 80.0)))
    fracs = np.array([0.0, 0.15, 0.3])
    signals = np.stack([
        f * basis[0, :, i_my] + (1 - f) * basis[0, :, i_ie]
        for f in fracs
    ])

    reg = 1e-5 * float(np.mean(np.sum(basis ** 2, axis=1)))
    out = t2_spectrum_map(signals, basis, t2grid, b1grid=b1grid,
                          mwf_cutoff=40.0, reg=reg, iters=3000)
    assert out["spectrum"].shape == (3, 40)
    assert np.all(out["b1"] == 0.85)          # residual picks the true B1
    assert np.allclose(out["mwf"], fracs, atol=0.05)
    assert np.all(np.diff(out["mwf"]) > 0)    # monotone in true fraction
    # pure-IE voxel: geometric-mean T2 near 80 ms
    assert 55.0 < out["gm_t2"][0] < 115.0
    assert np.all(out["resid"] < 1e-2)


def test_t2_spectrum_map_validation(port_f64):
    t2grid = np.geomspace(15.0, 2000.0, 10)
    basis = t2_basis(6, 10.0, t2grid, 1.0)
    with pytest.raises(ValueError):
        t2_spectrum_map(np.ones((2, 5)), basis, t2grid)   # wrong necho
    with pytest.raises(ValueError):
        t2_spectrum_map(np.ones((2, 6)), basis[:, :, :4], t2grid)
    with pytest.raises(ValueError):                        # B1 count
        t2_spectrum_map(np.ones((2, 6)), basis, t2grid, b1grid=[0.9, 1.0])


#: the parity problem: 16 echoes x 12 bins x 2 B1 x 64 voxels
NECHO, ESP, NBINS, B1GRID, NVOX = 16, 10.0, 12, np.array([0.8, 1.0]), 64


def _parity_problem(basis, seed=3):
    """Sparse nonnegative spectra on random B1 planes, light noise."""
    rng = np.random.default_rng(seed)
    w = np.abs(rng.normal(size=(NVOX, NBINS))) * (
        rng.random((NVOX, NBINS)) < 0.3)
    plane = rng.integers(0, len(B1GRID), NVOX)
    sig = np.einsum("vmn,vn->vm", basis[plane], w)
    return sig + 1e-3 * rng.standard_normal(sig.shape)


def test_t2_basis_matches_jax(port_f64):
    t2grid = np.geomspace(15.0, 2000.0, NBINS)
    want = jt2.t2_basis(NECHO, ESP, t2grid, B1GRID, T1=1000.0)
    got = t2_basis(NECHO, ESP, t2grid, B1GRID, T1=1000.0)
    assert got.shape == want.shape == (len(B1GRID), NECHO, NBINS)
    assert np.abs(got - want).max() <= 1e-10


@pytest.mark.parametrize("reg", [None, 1e-4])
def test_t2_spectrum_map_matches_jax(port_f64, reg):
    t2grid = np.geomspace(15.0, 2000.0, NBINS)
    basis = jt2.t2_basis(NECHO, ESP, t2grid, B1GRID, T1=1000.0)
    sig = _parity_problem(basis)
    kw = dict(b1grid=B1GRID, reg=reg, iters=800)
    want = jt2.t2_spectrum_map(sig, basis, t2grid, **kw)
    got = t2_spectrum_map(sig, basis, t2grid, **kw)
    assert set(got) == set(want)
    assert np.array_equal(got["b1_index"], np.asarray(want["b1_index"]))
    assert np.array_equal(got["b1"], want["b1"])
    scale = np.abs(np.asarray(want["spectrum"])).max()
    assert np.abs(got["spectrum"] - want["spectrum"]).max() <= 1e-8 * scale
    assert np.abs(got["mwf"] - want["mwf"]).max() <= 1e-8
    assert np.abs(got["resid"] - want["resid"]).max() <= 1e-8 * scale
    np.testing.assert_allclose(got["gm_t2"], want["gm_t2"], rtol=1e-8)


def test_nnls_matches_jax(port_f64):
    rng = np.random.default_rng(5)
    A = np.abs(rng.normal(size=(4, 12, 5))) + 0.1
    y = rng.normal(size=(4, 12)) + np.einsum("bmn,bn->bm", A, np.abs(
        rng.normal(size=(4, 5))))
    for args in ((A, y), (A[0], y)):          # batched; shared design
        want = np.asarray(jt2.nnls(*args, reg=0.05, iters=400))
        got = nnls(*args, reg=0.05, iters=400).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_nnls_zero_design_stays_zero(port_f64):
    """A degenerate all-zero design has Lipschitz constant 0: the clamp
    keeps the step finite, so the zero solution does not turn into NaN."""
    x = nnls(np.zeros((6, 3)), np.ones(6), iters=50).numpy()
    assert np.array_equal(x, np.zeros(3))


def test_momentum_matches_fista_recurrence():
    """The host momentum weights are FISTA's (t_k - 1) / t_{k+1}."""
    mom = tt2._momentum(4)
    t, want = 1.0, []
    for _ in range(4):
        t_new = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        want.append((t - 1) / t_new)
        t = t_new
    assert mom == pytest.approx(want, rel=1e-15)
    assert mom[0] == 0.0


def test_basis_grid_takes_the_cpmg_family(port_f64):
    """The (nbins, 1) x (1, NB1) grid of t2_basis is a CPMG train the
    matcher takes, with the outer grid as the batch shape -- the route
    simulate() dispatches to the CPMG kernel on the card."""
    t2grid = np.geomspace(15.0, 2000.0, NBINS)
    seq = cpmg_sequence(NECHO, esp=ESP, T1=1000.0, T2=t2grid[:, None],
                        B1=B1GRID[None, :], exc=(90.0, 90.0),
                        ref=(180.0, 0.0))
    params = fisp_dispatch.match_mse(seq)
    assert params is not None
    assert params["shape"] == (NBINS, len(B1GRID))
    assert np.allclose(params["FA"], 180.0)


class _PeakBytes(TorchDispatchMode):
    """Peak bytes of the tensors made inside the mode (storages counted
    once while any tensor on them lives) and the largest single one."""

    def __init__(self):
        super().__init__()
        self.live, self.cur, self.peak, self.largest = {}, 0, 0, 0

    def _release(self, key):
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.cur -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key, nbytes = st.data_ptr(), st.nbytes()
            if key in self.live:
                self.live[key][1] += 1
            else:
                self.live[key] = [nbytes, 1]
                self.cur += nbytes
                self.peak = max(self.peak, self.cur)
                self.largest = max(self.largest, nbytes)
            weakref.finalize(t, self._release, key)
        return out


def test_fit_never_broadcasts_the_gram_over_voxels(port_f64):
    """JAX broadcasts AtA to (V, NB1, n, n) (fused away by XLA); the port
    keeps it (NB1, n, n): a 4,096-voxel fit's peak bytes stay below the
    size of that tensor, and no tensor of it is made."""
    V, nb1, n, m = 4096, 2, 24, 16
    rng = np.random.default_rng(7)
    basis = torch.as_tensor(np.abs(rng.normal(size=(nb1, m, n))))
    sig = torch.as_tensor(np.abs(rng.normal(size=(V, m))))
    gram_bytes = V * nb1 * n * n * 8
    with _PeakBytes() as meter:
        x, resid2 = tt2._fit_all(basis, sig, 1e-3, 20)
    assert x.shape == (nb1, V, n) and resid2.shape == (nb1, V)
    assert meter.largest < gram_bytes
    assert meter.peak < gram_bytes, (meter.peak, gram_bytes)
