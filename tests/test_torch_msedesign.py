"""The per-echo CPMG design kernel's plain twin and the TSE design of
epgpy_torch vs epgpy_tpu.

* ``cpmg_design_plain`` (float32) vs the JAX Pallas kernel in interpret
  mode, 64 atoms x 8 echoes, nstate 16, second order: every block to
  5e-6 of its scale (the JAX test's ``_close``, tests/test_msedesign.py:58;
  float32 both, a different operation order); causal zeros exact;
* ``cpmg_design_plain`` in float64 vs the port's general diff path on the
  alias-tracked train (per-echo alpha aliases on the refocusing T ops,
  per-echo esp aliases with the 1/2 chain coefficient on BOTH half-spacing
  E ops; tests/test_msedesign.py:28-43), Jacobian and Hessian probes, to
  1e-10 of each block's scale;
* ``desp[:, :, 3]`` vs a central difference of the float64 primal, 2e-5;
* ``mse_design_loss_grad_fused`` vs the JAX function (interpret, float32)
  to 1e-5 relative, and its gradient vs a central difference of its loss
  (tests/test_msedesign.py:160); ``tse_design_slsqp`` keeps its SAR and
  flip-increment constraints.
"""

import numpy as np
import pytest
import torch

import epgpy_torch as tepg
from epgpy_torch.models import cuda_msedesign
from epgpy_torch.parallel import (make_mesh, mse_design_loss_grad_fused,
                                  tse_design_slsqp)
from epgpy_tpu.models.pallas_msedesign import cpmg_design_pallas

from epgpy_torch.models.cuda_fisp import SMEM_PER_BLOCK
from torch_support import (ShiftRecorder, cplx, port_f32,  # noqa: F401
                           port_f64, rows_beyond)

NECHO = 8
RNG = np.random.default_rng(5)
FA = RNG.uniform(90, 170, NECHO)
ESP = RNG.uniform(7, 12, NECHO)
ALPS = [f"a_{i:02d}" for i in range(NECHO)]
ESPS = [f"e_{i:02d}" for i in range(NECHO)]
T1v = np.array([600.0, 1400.0])
T2v = np.array([45.0, 110.0])
NS = 2 * NECHO
BIG = 64
T1g = np.linspace(400.0, 1600.0, BIG)
T2g = np.linspace(30.0, 130.0, BIG)
KEYS = ("sig", "dT1", "dT2", "dalpha", "desp", "dT1dalpha", "dT2dalpha",
        "dT1desp", "dT2desp")


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(ref, got, tol):
    scale = max(np.abs(ref).max(), 1e-9)
    assert np.abs(ref - got).max() / scale < tol, (
        np.abs(ref - got).max() / scale)


@pytest.fixture(scope="module")
def jax_design():
    return cpmg_design_pallas((90.0, 90.0), FA, 0.0, ESP, T1g, T2g,
                              nstate=NS, second_order=True, interpret=True)


@pytest.fixture(scope="module")
def twin_design():
    return cuda_msedesign.cpmg_design_plain((90.0, 90.0), FA, 0.0, ESP,
                                            _t(T1g), _t(T2g), nstate=NS,
                                            second_order=True)


@pytest.mark.parametrize("key", KEYS)
def test_twin_matches_jax_kernel(jax_design, twin_design, key):
    got, want = cplx(*twin_design[key]), cplx(*jax_design[key])
    assert got.shape == want.shape
    _close(want, got, 5e-6)


def test_causal_zeros_and_first_order(twin_design):
    """Echo j cannot depend on later controls: i > j entries are exact
    zeros; the first-order run equals the second-order run's groups."""
    for key in KEYS[3:]:
        m = cplx(*twin_design[key])
        for j in range(NECHO):
            assert np.all(m[:, j, j + 1:] == 0), key
    first = cuda_msedesign.cpmg_design_plain(
        (90.0, 90.0), FA, 0.0, ESP, _t(T1g), _t(T2g), nstate=NS)
    assert set(first) == set(KEYS[:5])
    for key in first:
        for a, b in zip(first[key], twin_design[key]):
            assert torch.equal(a, b), key
    assert cuda_msedesign.design_kernel_fits(168)
    assert not cuda_msedesign.design_kernel_fits(169)
    assert cuda_msedesign.design_kernel_fits(386, second_order=False)
    # lane-warps per block (one warp per design lane), 4 tiles of 8
    assert cuda_msedesign.design_tile(32, 64) == 8
    assert cuda_msedesign.design_tile(32, 64, second_order=False) == 8


# -- what the warp-row design kernel's chunk skip and geometry rest on --


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("second_order", [True, False])
def test_twin_ladder_stays_within_reach(monkeypatch, second_order, dtype):
    """After half-stage h (0-based, two per echo) every lane group and
    every per-atom group of the design twin is exactly zero past row
    min(h + 1, nstate) -- with per-echo phases and spacings -- the
    invariant by which the kernel skips the 32-row chunks beyond the
    reach; and a train cut to j + 1 echoes gives the same outputs at
    nstate 2 (j + 1) and deeper."""
    phi = np.random.default_rng(8).uniform(0.0, 40.0, NECHO)
    args = ((90.0, 90.0), FA, phi, ESP, _t(T1g[:6], dtype),
            _t(T2g[:6], dtype))
    rec = ShiftRecorder(monkeypatch)
    cuda_msedesign.cpmg_design_plain(*args, nstate=NS,
                                     second_order=second_order)
    per_half = (6 if second_order else 2) + 3
    assert len(rec.sets) == 2 * NECHO * per_half
    for q, s in enumerate(rec.sets):
        h = q // per_half
        assert rows_beyond(s, min(h + 1, NS)) == 0.0, (q, h)
    for j in (0, 3):
        cut = args[:1] + tuple(np.asarray(a)[:j + 1] for a in args[1:4]) \
            + args[4:]
        want = cuda_msedesign.cpmg_design_plain(
            *cut, nstate=2 * (j + 1), second_order=second_order)
        for n in (2 * (j + 1) + 1, 2 * (j + 1) + 9, 40):
            got = cuda_msedesign.cpmg_design_plain(
                *cut, nstate=n, second_order=second_order)
            assert set(got) == set(want)
            for key in got:
                for a, b in zip(got[key], want[key]):
                    assert torch.equal(a, b), (j, n, key)


#: the design gates as the one-thread-per-lane layout set them: the
#: warp-row kernel keeps them, so no design changes route
DESIGN_GATE = {True: 168, False: 386}


@pytest.mark.parametrize("second_order", [True, False])
def test_design_gate_unchanged(second_order):
    """design_kernel_fits over nstate 1-400 is the pinned table: nstate
    <= 168 at second order, <= 386 at first."""
    got = [cuda_msedesign.design_kernel_fits(n, second_order)
           for n in range(1, 401)]
    assert got == [n <= DESIGN_GATE[second_order] for n in range(1, 401)]


@pytest.mark.parametrize("second_order", [True, False])
def test_design_launch_geometry_fits(second_order):
    """For every ladder the gate admits and echo counts from 1 to 100: 1
    to 8 lane-warps per block, no more than the echoes, whose row records
    (6 G plane values per lane-warp and one more) and three per-atom
    buffers (19 floats per row) fit one block's shared memory."""
    G = 6 if second_order else 2
    for E in (1, 2, 7, 8, 9, 31, 32, 33, 64, 100):
        for n in range(1, DESIGN_GATE[second_order] + 1):
            tile = cuda_msedesign.design_tile(E, n, second_order)
            assert 1 <= tile <= min(E, 8), (E, n)
            smem = 4 * (n + 1) * ((6 * G + 1) * tile + 3 * 19)
            assert cuda_msedesign.design_block_smem(
                n, tile, second_order) == smem, (E, n)
            assert smem <= SMEM_PER_BLOCK, (E, n)


def _alias_train(e, esp=ESP):
    """The design train with per-echo aliases (tests/test_msedesign.py)."""
    seq = [e.T(90, 90)]
    for i in range(NECHO):
        o_e = {"T1": {"T1": 1.0}, "T2": {"T2": 1.0}, ESPS[i]: {"tau": 0.5}}
        seq += [e.E(esp[i] / 2, T1v, T2v, order1=dict(o_e)), e.S(1),
                e.T(FA[i], 0.0, order1={ALPS[i]: "alpha"}),
                e.E(esp[i] / 2, T1v, T2v, order1=dict(o_e)), e.S(1), e.ADC]
    return seq


def test_twin_float64_matches_general_diff_path(port_f64):
    sig, jac, hes = tepg.simulate(
        _alias_train(tepg), max_nstate=NS, fisp_kernel=False,
        probe=[tepg.ADC, tepg.Jacobian(["T1", "T2"] + ALPS + ESPS),
               tepg.Hessian(["T1", "T2"], ALPS + ESPS)])
    out = cuda_msedesign.cpmg_design_plain(
        (90.0, 90.0), FA, 0.0, ESP, _t(T1v, torch.float64),
        _t(T2v, torch.float64), nstate=NS, second_order=True)

    def blk(key):                               # (B, E, E) -> (E, B, E)
        return np.moveaxis(cplx(*out[key]), 0, 1)

    _close(sig, cplx(*out["sig"]).T, 1e-10)
    _close(jac[..., 0], cplx(*out["dT1"]).T, 1e-10)
    _close(jac[..., 1], cplx(*out["dT2"]).T, 1e-10)
    _close(jac[..., 2:2 + NECHO], blk("dalpha"), 1e-10)
    _close(jac[..., 2 + NECHO:], blk("desp"), 1e-10)
    for key, c, half in (("dT1dalpha", 0, 0), ("dT2dalpha", 1, 0),
                         ("dT1desp", 0, 1), ("dT2desp", 1, 1)):
        ref = hes[:, :, c, half * NECHO:(half + 1) * NECHO]
        _close(ref, blk(key), 1e-10)


def test_desp_central_difference(port_f64):
    """desp column 3 of the float32 twin against a central difference of
    the float64 general path (pins the 1/2 half-spacing chain
    coefficient)."""
    out = cuda_msedesign.cpmg_design_plain((90.0, 90.0), FA, 0.0, ESP,
                                           _t(T1v), _t(T2v), nstate=NS)
    eps = 1e-3

    def primal(esp3):
        esp = ESP.copy()
        esp[3] = esp3
        seq = [op for op in _alias_train(tepg, esp)]
        for op in seq:
            op.order1, op.order2 = {}, {}
        return tepg.simulate(seq, max_nstate=NS, fisp_kernel=False)

    fd = (primal(ESP[3] + eps) - primal(ESP[3] - eps)) / (2 * eps)
    _close(fd, cplx(*out["desp"])[:, :, 3].T, 2e-5)


def test_loss_grad_matches_jax(port_f32):
    from epgpy_tpu.parallel import (
        mse_design_loss_grad_fused as jax_loss_grad)

    f32 = np.float32
    want = jax_loss_grad(np.asarray(FA, f32), np.asarray(ESP, f32), T1v, T2v,
                         nstate=NS, interpret=True)
    got = mse_design_loss_grad_fused(FA, ESP, T1v, T2v, nstate=NS)
    assert got[0].dtype == torch.float32
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    # the atom-sharded form (once refused): the two atoms on a 2-entry CPU
    # mesh, the mean of the shards' means (1e-6 relative in float32)
    mesh = make_mesh([torch.device("cpu")] * 2)
    sharded = mse_design_loss_grad_fused(FA, ESP, T1v, T2v, mesh, nstate=NS)
    for a, b in zip(sharded, got):
        assert np.abs(a.numpy() - b.numpy()).max() <= \
            1e-6 * np.abs(b.numpy()).max()


def test_loss_grad_finite_difference(port_f64):
    """The analytic gradient vs a central difference of the loss, in
    float64 (tests/test_msedesign.py:160 takes it in float32, where the
    loss's rounding makes the difference scatter by ~2%: in float64 the
    central difference converges, so the bound is 2e-6 relative); and the
    float32 gradient against the float64 one."""
    tol, eps = 2e-6, 0.05
    _, gfa, gesp = mse_design_loss_grad_fused(FA, ESP, T1v, T2v, nstate=NS)
    assert gfa.dtype == torch.float64

    def loss(fa, esp):
        return float(mse_design_loss_grad_fused(fa, esp, T1v, T2v,
                                                nstate=NS)[0])

    for i in (1, 5):
        fa_p, fa_m = FA.copy(), FA.copy()
        fa_p[i] += eps
        fa_m[i] -= eps
        fd = (loss(fa_p, ESP) - loss(fa_m, ESP)) / (2 * eps)
        assert abs(fd - float(gfa[i])) < tol * abs(fd), (i, fd)
    esp_p, esp_m = ESP.copy(), ESP.copy()
    esp_p[3] += eps
    esp_m[3] -= eps
    fd = (loss(FA, esp_p) - loss(FA, esp_m)) / (2 * eps)
    assert abs(fd - float(gesp[3])) < tol * abs(fd), fd

    tepg.config.set_precision("float32")
    _, gfa32, gesp32 = mse_design_loss_grad_fused(FA, ESP, T1v, T2v,
                                                  nstate=NS)
    for g32, g64 in ((gfa32, gfa), (gesp32, gesp)):
        assert (g32.double() - g64).abs().max() <= 1e-4 * g64.abs().max()


def test_tse_design_slsqp_keeps_constraints(port_f64):
    """3 SLSQP iterations of the example's flip-only design at 8 echoes:
    every iterate keeps |FA_i - FA_{i-1}| <= dfa_max (the JAX constraint
    form; here it binds), the result the SAR budget, and the designed
    loss is below the constant train's at the same SAR (the start is
    over budget, so the loss itself rises from it)."""
    T1s = np.array([800.0, 1200.0, 1600.0, 1100.0])
    T2s = np.array([70.0, 95.0, 140.0, 55.0])
    esp, fa0 = np.full(NECHO, 8.0), np.full(NECHO, 120.0)
    budget = 0.7 * np.mean((fa0 / 180.0) ** 2)
    iterates = []
    fa, esp1, res = tse_design_slsqp(
        fa0, esp, T1s, T2s, maxiter=3, fix_esp=True, fa_bounds=(40.0, 180.0),
        sar_budget=budget, dfa_max=5.0, callback=iterates.append)
    assert res.nit == 3 and len(iterates) == 3
    for x in iterates:
        assert np.abs(np.diff(x[:NECHO])).max() <= 5.0 + 1e-9
    assert np.mean((fa / 180.0) ** 2) <= budget * 1.001
    assert np.array_equal(esp1, esp)
    flat = np.full(NECHO, 120.0 * np.sqrt(0.7))
    v_flat = float(mse_design_loss_grad_fused(flat, esp, T1s, T2s)[0])
    assert res.fun < v_flat
