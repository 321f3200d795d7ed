"""The EPG-X GRE family of epgpy_torch vs epgpy_tpu: the kernels' plain
twins, simulate(density=) dispatch, fall-through, goldens, Jacobian.

* ``xgre_dictionary_plain`` / ``xgre_jacobian_plain`` (float32) vs the JAX
  Pallas kernels in interpret mode over ``chip_smoke.XGRE_CASES`` (spoiled
  and balanced, 1 to 4 pools, two stages, df, a rank-1 B1 batch, complex
  saturation, a deep ladder), 8 atoms x 16 TRs (8 for three and four
  pools and for the Jacobian; the Jacobian over one to three pools, four
  pools being left to the card's kernel-vs-twin check): signals 2e-6
  absolute, tangent columns 1e-5 of the column's scale; the primal's three
  and four pools mix by ``torch.linalg.matrix_exp`` against the JAX f32
  Pade exponential, whose stage matrices differ by ~1e-6: 1e-5 there (the
  Jacobian takes its stage matrices as inputs: 2e-6 at any pool count);
* ``simulate(density=..., fisp_kernel="force")`` (the twin, float64) vs
  the float64 general path at 1e-10 over the JAX tests' trains, with the
  dispatch counted; the JAX matcher's fall-through cases
  (``tests/test_xgre_dispatch.py:182-285``) fall through here too;
* the goldens ``xgre_parity.npz`` and ``xbssfp.npz`` at 1e-10 (float64);
* the Jacobian twin in float64 vs central finite differences of the
  primal twin (bound-pool fraction f, which moves the kinetic matrix and
  the densities, and the free pool's T2), 1e-6 relative;
* ``match_xgre`` returns the JAX matcher's dict, and a JAX dict carried
  through ``convert.from_numpy_xparams`` runs the port's runner to the same
  values;
* the segmented Jacobian kernel's lane map (``epg::seg_shift_blocked``
  replayed in numpy at ``xgre_jac_geometry``'s rows per lane) leaves the
  float64 twin exactly as it was; its launch geometry for every ladder the gate admits,
  and the gate as before; its identity-stage-A skip, emulated in float64
  per warp, within 1e-12 of the twin;
* the segmented primal kernel's lane map (``epg::seg_shift_blocked`` and
  the one-lane ``epg::lane_shift`` replayed in numpy at ``xgre_geometry``'s
  rows per lane) leaves the float64 primal twin exactly as it was, for one
  to four pools on both sides of every change of the rows per lane, at
  the gate's deepest ladders and at nstate 0; its geometry for every
  ladder the gate admits, and the primal gate's table as before.
"""

import os

import numpy as np
import pytest
import torch

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch.convert import from_numpy_xparams
from epgpy_torch.models import cuda_xgre
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu.models import pallas_xgre

from chip_smoke import (X_ROW_EDGES, XGRE_CASES, XGRE_EDGE_CASES,
                        make_xgre_case,
                        make_xgre_jac_case, xbssfp_golden_train,
                        xgre_parity_train, xgre_stage_a_passthrough,
                        xgre_tensors)
from epgpy_torch.models import planes
from torch_support import (GOLDEN_DIR, cplx, port_f32,  # noqa: F401
                           port_f64, same_match, seg_owned_atoms,
                           seg_shift_emulated, to_f64, warps_all)

B, NTR = 8, 16


def _tol(case):
    return 2e-6 if case.get("C", 2) <= 2 else 1e-5


def _ntr(case, jac=False):
    """TRs of a JAX interpret-mode comparison: its cost grows with the
    groups and the square of the pools."""
    return NTR // 2 if jac or case.get("C", 2) > 2 else NTR


@pytest.mark.parametrize("case", XGRE_CASES, ids=lambda c: c["name"])
def test_xgre_twin_matches_jax_kernel(case):
    args, kw = make_xgre_case(case, B, _ntr(case))
    want = pallas_xgre.xgre_dictionary_pallas(*args, interpret=True,
                                              btile=128, **kw)
    got = cuda_xgre.xgre_dictionary_plain(*xgre_tensors(torch, args, "cpu"),
                                          **kw)
    C = case.get("C", 2)
    assert got[0].shape == (_ntr(case), C, B)
    assert got[0].dtype == torch.float32
    assert np.abs(cplx(*got) - cplx(*want)).max() < _tol(case)


@pytest.mark.parametrize("case", [c for c in XGRE_CASES
                                  if c.get("C", 2) <= 3],
                         ids=lambda c: c["name"])
def test_xgre_jacobian_twin_matches_jax_kernel(case):
    args, kw = make_xgre_jac_case(torch, case, B, _ntr(case, True))
    (wre, wim), (wjre, wjim) = pallas_xgre.xgre_jacobian_pallas(
        *args, interpret=True, btile=128, **kw)
    (gre, gim), (gjre, gjim) = cuda_xgre.xgre_jacobian_plain(
        *xgre_tensors(torch, args, "cpu", jac=True), **kw)
    assert np.abs(cplx(gre, gim) - cplx(wre, wim)).max() < 2e-6
    got, want = cplx(gjre, gjim), cplx(wjre, wjim)
    assert got.shape == want.shape == (_ntr(case, True), 2,
                                       case.get("C", 2), B)
    for v in range(2):
        scale = np.abs(want[:, v]).max()
        if scale == 0:          # one pool: no exchange rate to move
            assert np.abs(got[:, v]).max() == 0
            continue
        assert np.abs(got[:, v] - want[:, v]).max() < 1e-5 * scale


def _mt_train(e, N=10, B=5, *, sat=True, order="adc_first", g=None, C=2,
              vary=False, two_stage=False, dens=(0.8, 0.2), balanced=False,
              b1=None, csat=False):
    """tests/test_xgre_dispatch.py's two-pool MT-GRE train in package `e`
    (with a rank-1 B1 batch and a complex saturation rate as options)."""
    dens = np.asarray(dens[:C]) / np.sum(dens[:C])
    khi = e.exchange_matrix(0.005, ncomp=C, densities=dens)
    T2 = np.stack([np.linspace(40.0, 120.0, B)]
                  + [np.full(B, 0.012 * (c + 1)) for c in range(C - 1)])
    T1 = np.linspace(800.0, 1200.0, C)
    gv = None if g is None else np.asarray(g)
    X1 = e.X(3.0, khi, axis=0, T1=T1, T2=T2, g=gv) if two_stage else None
    X2 = e.X(7.0 if two_stage else 10.0, khi, axis=0, T1=T1, T2=T2, g=gv)
    rng = np.random.default_rng(7)
    seq = []
    for i in range(N):
        if sat:
            rL = np.zeros(C)
            rL[-1] = 0.25 + (0.1 * rng.uniform() if vary else 0.0)
            rT = np.zeros(C, complex)
            if csat:
                rT[0] = 0.02 + 0.3j
            seq.append(e.R(rT, rL=rL, r0=None))
        a = np.asarray([12.0 + (3.0 * np.sin(i) if vary else 0.0)]
                       + [0.0] * (C - 1))
        alpha = a if b1 is None else np.outer(a, b1)
        phi = float((58.5 * i * (i + 1)) % 360) if vary else 0.0
        seq.append(e.T(alpha, phi))
        if order == "adc_first":
            seq += ([X1] if X1 is not None else []) + [e.ADC, X2]
        else:
            seq += ([X1] if X1 is not None else []) + [X2, e.ADC]
        if not balanced:
            seq.append(e.S(1))
    return seq, list(dens)


TRAINS = {
    "mt": dict(N=12, B=7),
    "two_stage": dict(B=4, two_stage=True),
    "no_sat": dict(sat=False),
    "vary": dict(N=12, B=4, vary=True),
    "df": dict(B=4, g=[0.05, -0.02]),
    "three_pools": dict(N=8, B=4, C=3, dens=(0.6, 0.25, 0.15)),
    "rank1_b1": dict(B=4, b1=np.linspace(0.85, 1.15, 4)),
    "complex_sat": dict(B=3, csat=True),
    "balanced": dict(N=12, B=5, balanced=True, two_stage=True, vary=True),
    "balanced_df": dict(B=4, balanced=True, sat=False, g=[0.02, -0.01]),
}


@pytest.mark.parametrize("name", sorted(TRAINS))
def test_simulate_density_dispatch_matches_general_path(port_f64, name):
    """simulate(density=...) sends the train to the xgre family (the twin
    here, float64) and equals the general path; the match equals the JAX
    matcher's dict."""
    kw = TRAINS[name]
    seq, dens = _mt_train(tepg, **kw)
    C = kw.get("C", 2)
    shape = (C, kw.get("B", 5))
    params = tfd.match_xgre(seq, shape, dens)
    assert params is not None and params["balanced"] == bool(
        kw.get("balanced"))
    jseq, _ = _mt_train(jepg, **kw)
    same_match(params, jfd.match_xgre(jseq, shape, dens))
    tfd.clear_cache()
    tfd.DISPATCH_COUNTS.clear()
    out = tepg.simulate(seq, max_nstate=5, density=dens, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS == {"xgre": 1}
    ref = tepg.simulate(seq, max_nstate=5, density=dens, fisp_kernel=False)
    assert out.shape == ref.shape == (kw.get("N", 10),) + shape
    assert np.abs(out - ref).max() < 1e-10


def _bench_block(e, X, sat=None, s=None, adc=None):
    blk = [] if sat is None else [sat]
    return blk + [e.T(np.asarray([10.0, 0.0]), 0.0), adc or e.ADC, X,
                  s or e.S(1)]


def _mk_x(e, khi=None, **kw):
    if khi is None:
        khi = e.exchange_matrix(0.005, densities=[0.8, 0.2])
    kw.setdefault("T1", np.asarray([1000.0, 1000.0]))
    kw.setdefault("T2", np.stack([np.linspace(40, 120, 4),
                                  np.full(4, 0.012)], 0))
    axis = kw.pop("axis", 0)
    return e.X(10.0, khi, axis=axis, **kw)


def _fallthrough(e, case):
    """The off-pattern trains of tests/test_xgre_dispatch.py:182-285 (and
    :459) in package `e`: (sequence, shape, density)."""
    X, seq, shape, dens = _mk_x(e), [], (2, 4), [0.8, 0.2]
    for i in range(6):
        if case == "distinct_x":
            seq += _bench_block(e, _mk_x(e))
        elif case == "nonunit_shift":
            seq += _bench_block(e, X, s=e.S(2))
        elif case == "adc_phase":
            seq += _bench_block(e, X, adc=e.Adc(phase=30.0))
        elif case == "nonconserving":
            seq += _bench_block(e, _mk_x(e, e.exchange_matrix(0.005))
                                if i == 0 else seq[2])
        elif case == "tracked_sat":
            sat = e.R(0, rL=np.asarray([0.0, 0.3]), r0=None, order1="rL")
            seq += _bench_block(e, X, sat=sat)
        elif case == "sat_recovery":
            sat = e.R(0, rL=np.asarray([0.0, 0.3]),
                      r0=np.asarray([0.0, 0.1]))
            seq += _bench_block(e, X, sat=sat)
        elif case == "non_rank1":
            row = (np.linspace(8, 12, 4) if i % 2 == 0
                   else np.linspace(12, 8, 4))
            seq += [e.T(np.stack([row, np.zeros(4)], 0), 0.0), e.ADC, X,
                    e.S(1)]
        elif case == "complex_density":
            seq += _bench_block(e, X)
            dens = [0.8 + 0.1j, 0.2 - 0.1j]
        elif case == "mixed_balanced":
            blk = _bench_block(e, X)
            seq += blk if i % 2 == 0 else blk[:-1]
        elif case == "nonzero_axis":
            khi = e.exchange_matrix(0.005, densities=[0.8, 0.2])[None]
            Xa = seq[2] if i else _mk_x(
                e, khi, axis=1, T2=np.stack([np.linspace(40, 120, 4),
                                             np.full(4, 0.012)], 1))
            seq += [e.T(10.0, 0.0), e.ADC, Xa, e.S(1)]
            shape = (4, 2)
    return seq, shape, dens


FALLTHROUGH = ["distinct_x", "nonunit_shift", "adc_phase", "nonconserving",
               "tracked_sat", "sat_recovery", "non_rank1", "complex_density",
               "mixed_balanced", "nonzero_axis"]


@pytest.mark.parametrize("case", FALLTHROUGH)
def test_fall_through(port_f64, case):
    seq, shape, dens = _fallthrough(tepg, case)
    jseq, _, _ = _fallthrough(jepg, case)
    assert jfd.match_xgre(jseq, shape, dens) is None
    assert tfd.match_xgre(seq, shape, dens) is None


def test_nonconserving_density_matches_balanced_density():
    seq, shape, _ = _fallthrough(tepg, "nonconserving")
    assert tfd.match_xgre(seq, shape, [0.5, 0.5]) is not None


def test_match_memoized():
    seq, dens = _mt_train(tepg, N=8, B=4)
    assert tfd.match_xgre(seq, (2, 4), dens) is tfd.match_xgre(seq, (2, 4),
                                                                dens)


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


@pytest.mark.parametrize("name", ["xgre_parity", "xbssfp"])
def test_goldens(port_f64, name):
    g = _golden(name)
    if name == "xgre_parity":
        seq, kw = xgre_parity_train(tepg), dict(max_nstate=10,
                                                density=[0.8, 0.2])
    else:
        seq, kw = xbssfp_golden_train(tepg, g), dict(density=[0.85, 0.15])
    tfd.DISPATCH_COUNTS.clear()
    for fk in (False, "force"):
        sig = tepg.simulate(seq, fisp_kernel=fk, **kw)
        assert np.abs(sig - g["signal"]).max() < 1e-10
    assert tfd.DISPATCH_COUNTS == {"xgre": 1}


K_EX, T1C = 0.004, np.array([900.0, 1100.0])


def _qmt_stage(f, T2f, tau):
    """(mr, mi, ml, dens) of a bound-pool fraction f and free-pool T2
    (tests/test_xgre_jacobian.py:44-53), differentiable."""
    d0, d1 = 1.0 - f, f
    khi = torch.stack([torch.stack([K_EX / d0, -K_EX / d1]),
                       torch.stack([-K_EX / d0, K_EX / d1])])
    T2 = torch.stack([T2f, torch.full_like(T2f, 0.012)])
    T1 = torch.as_tensor(T1C, dtype=f.dtype)[:, None].expand(2, f.shape[0])
    return cuda_xgre.exchange_stage_mats(khi, T1, T2, None, tau) \
        + (torch.stack([d0, d1]),)


def _qmt_jacobian(f, T2f, train):
    """Signals and (df, dT2f) tangents through the Jacobian twin."""
    one, zero = torch.ones_like(f), torch.zeros_like(f)
    vals, tans = [], []
    for tau in (3.0, 9.0):
        v, tf = torch.func.jvp(lambda a, b: _qmt_stage(a, b, tau), (f, T2f),
                               (one, zero))
        _, tt = torch.func.jvp(lambda a, b: _qmt_stage(a, b, tau), (f, T2f),
                               (zero, one))
        vals.append(v)
        tans.append(tuple(torch.stack([a, b]) for a, b in zip(tf, tt)))
    return cuda_xgre.xgre_jacobian_plain(
        *train, vals[0][3], vals[0][:3], vals[1][:3], tans[0][:3],
        tans[1][:3], tans[0][3], nstate=5)


def test_jacobian_twin_finite_differences(port_f64):
    """The float64 Jacobian twin vs central differences of the primal twin
    over a per-atom bound-pool fraction (kinetic matrix and densities) and
    free-pool T2."""
    rng = np.random.default_rng(3)
    N, n = 10, 4
    train = (8.0 + 40.0 * np.abs(np.sin(np.arange(N) * 0.7))[:, None]
             * np.array([1.0, 0.0]), np.zeros((N, 2)), np.ones((N, 2)),
             np.zeros((N, 2)),
             np.stack([np.ones(N), np.full(N, np.exp(-0.25))], 1),
             np.zeros((N, 2)))
    f = torch.as_tensor(rng.uniform(0.1, 0.3, n), dtype=torch.float64)
    T2f = torch.as_tensor(rng.uniform(40, 110, n), dtype=torch.float64)
    (re, im), (jre, jim) = _qmt_jacobian(f, T2f, train)
    jac = cplx(jre, jim)

    def primal(ff, tt):
        (r, i), _ = _qmt_jacobian(ff, tt, train)
        return cplx(r, i)

    for v, (x, h) in enumerate(((f, 1e-6), (T2f, 1e-4))):
        dx = torch.zeros_like(x) + h
        args = [(f + dx, T2f), (f - dx, T2f)] if v == 0 \
            else [(f, T2f + dx), (f, T2f - dx)]
        fd = (primal(*args[0]) - primal(*args[1])) / (2 * h)
        assert np.abs(jac[:, v] - fd).max() < 1e-6 * np.abs(fd).max()


def test_converted_jax_match_runs_to_jax_values(port_f32):
    """A JAX match dict carried through convert runs the port's runner (the
    twin on the CPU) to the JAX runner's values (interpret mode)."""
    seq, dens = _mt_train(jepg, N=10, B=4, two_stage=True, g=[0.03, 0.0],
                          b1=np.linspace(0.9, 1.1, 4))
    jparams = jfd.match_xgre(seq, (2, 4), dens)
    want = jfd.run_xgre_kernel(jparams, 5, interpret=True)
    params = from_numpy_xparams(jparams, "cpu")
    got = tfd.run_xgre_kernel(params, 5)
    w = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == w.shape
    assert np.abs(got.numpy() - w).max() < 2e-6
    mats = pallas_xgre.exchange_stage_mats(
        jparams["khiB"], np.broadcast_to(np.asarray(jparams["T1B"])[:, None],
                                         (2, 4)), jparams["T2B"], None, 7.0)
    tm = from_numpy_xparams(mats, "cpu")
    assert all(t.dtype == torch.float32 and t.shape == (4, 2, 2) for t in tm)


def test_echo_layout_and_launch_counters():
    """The echo-layout wrappers take the twins for CPU tensors and count no
    launch; the CUDA entry points raise on CPU tensors; the gates count
    6 C and 6 C G planes at 32 threads; the Jacobian's guard raises."""
    args, kw = make_xgre_case(XGRE_CASES[0], 4, 6)
    targs = xgre_tensors(torch, args, "cpu")
    jargs, jkw = make_xgre_jac_case(torch, XGRE_CASES[0], 4, 6)
    tj = xgre_tensors(torch, jargs, "cpu", jac=True)
    before = (cuda_xgre.LAUNCHES, cuda_xgre.JAC_LAUNCHES)
    re, _ = cuda_xgre.xgre_dictionary_echoes(*targs, **kw)
    (jre, _), _ = cuda_xgre.xgre_jacobian_echoes(*tj, **jkw)
    assert (cuda_xgre.LAUNCHES, cuda_xgre.JAC_LAUNCHES) == before
    assert torch.allclose(re, jre, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_xgre.xgre_dictionary_cuda(*targs, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_xgre.xgre_jacobian_cuda(*tj, **jkw)
    assert cuda_xgre.xgre_kernel_fits(150, 2)
    assert not cuda_xgre.xgre_kernel_fits(151, 2)
    assert cuda_xgre.xgre_jac_kernel_fits(49, 2, 3)
    assert not cuda_xgre.xgre_jac_kernel_fits(50, 2, 3)
    with pytest.raises(ValueError, match="budget"):
        cuda_xgre._check_jac_fits("xgre_jac", 2, 3, 50)
    with pytest.raises(ValueError, match="variables per pass"):
        cuda_xgre._check_jac_fits("xgre_jac", 2, 6, 5)


# -- the segmented layout of xgre_jac.cu: lane map, geometry, gate, skip --

#: (C, G, H) of the lane-map replay: pools and groups (1, 2), (2, 3),
#: (3, 4), (4, 3) at ladders of H = 2, 11, 33, 50 rows where the gate
#: admits them, and 151 (5 rows per lane) at (1, 2)
XGRE_LANE_RUNS = [(C, G, H) for C, G in ((1, 2), (2, 3), (3, 4), (4, 3))
                  for H in (2, 11, 33, 50, 151)
                  if (H < 151 or (C, G) == (1, 2))
                  and cuda_xgre.xgre_jac_kernel_fits(H - 1, C, G)]


def _jac64(case, natoms, ntr, seed=9):
    args, kw = make_xgre_jac_case(torch, case, natoms, ntr, seed=seed)
    return to_f64(xgre_tensors(torch, args, "cpu", jac=True)), kw


@pytest.mark.parametrize("C,G,H", XGRE_LANE_RUNS,
                         ids=lambda v: str(v))
def test_xgre_jac_lane_map_matches_twin(monkeypatch, C, G, H):
    """The float64 Jacobian twin with every folded shift replayed through
    the kernel's lane map at its rows per lane (epg::seg_shift_blocked,
    emulated in numpy with NaN in the idle lanes and padding rows) equals
    the twin exactly, every group, pool and TR: two stages, df, a B1 batch, complex
    saturation, over more TRs than the ladder has rows."""
    case = dict(name="lane_map", C=C, V=G - 1, nstate=H - 1, two_stage=True,
                g=True, b1=True, csat=True)
    targs, kw = _jac64(case, 37, H + 6)
    want = cuda_xgre.xgre_jacobian_plain(*targs, **kw)
    R = cuda_xgre.xgre_jac_geometry(H - 1, C, G)["R"]
    monkeypatch.setattr(planes, "shift_fold",
                        lambda x: seg_shift_emulated(x, R,
                                                   blocked=True))
    got = cuda_xgre.xgre_jacobian_plain(*targs, **kw)
    assert got[0][0].dtype == torch.float64
    assert got[1][0].shape == (H + 6, G - 1, C, 37)
    for g_, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.isfinite(g_).all() and torch.equal(g_, w)


def test_seg_shift_blocked_emulation():
    """epg::seg_shift_blocked, replayed in numpy (NaN in the idle lanes,
    past the last atom and in the padding rows), equals planes.shift_fold
    exactly for every H from 2 to 151 and every R from 1 to 5 that the
    layout takes (W = ceil(H / R) <= 32), and leaves the padding rows' A
    and B planes zero."""
    rng = np.random.default_rng(5)
    ran = 0
    for H in range(2, 152):
        s = tuple(torch.as_tensor(rng.normal(size=(H, 7))) for _ in range(6))
        for R in range(1, 6):
            if -(-H // R) > 32:
                continue
            got, pad = seg_shift_emulated(s, R, padding=True, blocked=True)
            for g_, w in zip(got, planes.shift_fold(s)):
                assert torch.equal(g_, w), (H, R)
            assert (pad == 0.0).all(), (H, R)
            ran += 1
    assert ran == 466


#: the rows per lane a (C, G) instance of the kernel takes at most (its
#: max_rows): the rule at the gate's deepest ladder
XGRE_MAX_ROWS = {2: 5, 3: 4, 4: 3, 5: 2, 6: 2, 8: 2, 9: 2, 10: 1, 12: 1}


def test_xgre_jac_geometry():
    """For every (nstate, C, G) the gate admits: 1 row per lane up to 3
    rows, else ceil(H / 32), at least 2 while C G <= 6 (at most the
    kernel's instance, XGRE_MAX_ROWS); a segment of W = ceil(H / R) <= 32
    lanes, as many ladders per warp as fit, 1-4 warps per block (4 unless
    the coefficient table needs fewer), 1-32 TRs per chunk, the
    coefficient table, TR table and staged echoes within 48 KB, and a
    grid whose (block, warp, segment) slots store each of 1, 2, 3, 33 and
    4,097 atoms exactly once."""
    seen = 0
    for C in range(1, 5):
        for G in range(2, 6):
            if C * G > 12:
                continue
            for n in range(0, 401):
                if not cuda_xgre.xgre_jac_kernel_fits(n, C, G):
                    continue
                geo = cuda_xgre.xgre_jac_geometry(n, C, G)
                H, R, W, L = n + 1, geo["R"], geo["W"], geo["L"]
                assert R == (1 if H <= 3 else max(-(-H // 32),
                                                  2 if C * G <= 6 else 1))
                assert R <= XGRE_MAX_ROWS[C * G]
                assert W == -(-H // R) <= 32 and W * R >= H
                assert L == 32 // W and geo["atoms"] == geo["warps"] * L
                coef = (6 * C * C * G + C * G) | 1     # odd record stride
                per = cuda_xgre.XGRE_JAC_TABLE * C + 2 * G * C * geo["atoms"]
                assert geo["coef"] == coef
                assert 1 <= geo["warps"] <= 4
                assert geo["warps"] == 4 or (
                    coef * 2 * geo["atoms"] + per + 2 * G * C * geo["atoms"]
                    > 12288)
                assert 1 <= geo["pulses"] <= 32
                assert geo["smem"] == 4 * (coef * geo["atoms"]
                                           + geo["pulses"] * per) <= 48 * 1024
                for B_ in (1, 2, 3, 33, 4097):
                    owned, grid = seg_owned_atoms(geo, B_)
                    assert sorted(owned) == list(range(B_)), (n, C, G, B_)
                seen += 1
    assert seen == 748
    main = cuda_xgre.xgre_jac_geometry(10, 2, 3)
    assert (main["R"], main["W"], main["L"], main["warps"]) == (2, 6, 5, 4)


def test_xgre_jac_gate_unchanged():
    """The gate answers as the thread-per-atom layout set it: 6 C G planes
    of nstate + 1 rows at 32 threads in 232,448 bytes, for nstate 0-400,
    C 1-4, G 2-5 (C = 1, G = 2 up to nstate 150)."""
    for n in range(401):
        for C in range(1, 5):
            for G in range(2, 6):
                assert cuda_xgre.xgre_jac_kernel_fits(n, C, G) == (
                    4 * 6 * C * G * (n + 1) * 32 <= 232448)
    assert cuda_xgre.xgre_jac_kernel_fits(150, 1, 2)
    assert not cuda_xgre.xgre_jac_kernel_fits(151, 1, 2)


@pytest.mark.parametrize("which", ["all", "mixed"])
def test_xgre_jac_identity_skip_emulated(which):
    """The kernel's warps whose atoms all have the identity stage A with
    zero tangents skip stage A's mix: emulated in float64 -- the twin with
    stage A passed through for the atoms of those warps, the full twin
    for the others -- it is within 1e-12 of the twin (the identity mix
    around the densities changes a value by a rounding at most); with
    every atom's stage A the identity every warp skips, with the mixed
    batch of XGRE_EDGE_CASES some do and some do not."""
    case = next(c for c in XGRE_EDGE_CASES if c["name"] == "mixed_identity")
    B_ = 97
    targs, kw = _jac64(case, B_, 24)
    mats = targs[7]
    eye = torch.eye(2, dtype=torch.float64)
    ident = ((mats[0] == eye).all((1, 2)) & (mats[1] == 0).all((1, 2))
             & (mats[2] == eye).all((1, 2))
             & torch.stack([(d == 0).all(0).all((1, 2)) for d in targs[9]])
             .all(0)).numpy()
    if which == "all":
        n = targs[7][0].shape[0]
        targs = list(targs)
        targs[7] = (eye.expand(n, 2, 2).clone(),
                    torch.zeros((n, 2, 2), dtype=torch.float64),
                    eye.expand(n, 2, 2).clone())
        targs[9] = tuple(torch.zeros_like(d) for d in targs[9])
        targs = tuple(targs)
        ident = np.ones(B_, bool)
    skip = warps_all(cuda_xgre.xgre_jac_geometry(kw["nstate"], 2, 3), ident)
    assert skip.any() and (which == "all") == skip.all()
    full = cuda_xgre.xgre_jacobian_plain(*targs, **kw)
    with xgre_stage_a_passthrough():
        passed = cuda_xgre.xgre_jacobian_plain(*targs, **kw)
    sk = torch.as_tensor(skip)
    for f, p in zip(full[0] + full[1], passed[0] + passed[1]):
        emulated = torch.where(sk, p, f)
        scale = max(float(f.abs().max()), 1.0)
        assert float((emulated - f).abs().max()) <= 1e-12 * scale
        assert torch.equal(emulated[..., ~sk], f[..., ~sk])


# -- the segmented layout of xgre.cu (blocked rows, every pool of a row on
# one lane): lane map, row edges, geometry, gate --

#: the primal gate's deepest ladder per pool count (nstate)
XGRE_PRIMAL_TOP = {1: 301, 2: 150, 3: 99, 4: 74}


def test_x_row_edges_cover_every_change():
    """chip_smoke.X_ROW_EDGES, the nstates the card's edge runs take, are
    both sides of every change of the primal kernels' rows per lane
    (cuda_xgre.x_rows) and the gate's deepest ladder, at one to four
    pools."""
    for C, top in XGRE_PRIMAL_TOP.items():
        want = {top}
        for n in range(1, top + 1):
            if cuda_xgre.x_rows(n, C) != cuda_xgre.x_rows(n - 1, C):
                want |= {n - 1, n}
        assert set(X_ROW_EDGES[C]) == want, C


@pytest.mark.parametrize("C,nstate", [(C, n) for C, ns in X_ROW_EDGES.items()
                                      for n in ns], ids=str)
def test_xgre_lane_map_matches_twin(monkeypatch, C, nstate):
    """The float64 primal twin with every folded shift replayed through
    the kernel's lane map at its rows per lane (xgre_geometry; blocked rows,
    epg::seg_shift_blocked -- epg::lane_shift for a ladder on one lane --
    emulated in numpy with NaN in the idle lanes, past the last atom and in
    the padding rows) equals the twin, every pool and TR: two stages, df, a
    B1 batch, complex saturation, over 7 TRs more than the ladder has rows;
    nstate 0 is the balanced train, which never shifts."""
    case = dict(name="lane_map", C=C, nstate=nstate, balanced=nstate == 0,
                two_stage=True, g=True, b1=True, csat=True)
    ntr = nstate + 7
    args, kw = make_xgre_case(case, 37, ntr, seed=4)
    targs = to_f64(xgre_tensors(torch, args, "cpu"))
    want = cuda_xgre.xgre_dictionary_plain(*targs, **kw)
    R = cuda_xgre.xgre_geometry(nstate, C)["R"]
    calls = [0]

    def shift(x):
        calls[0] += 1
        return seg_shift_emulated(x, R, blocked=True)

    monkeypatch.setattr(planes, "shift_fold", shift)
    got = cuda_xgre.xgre_dictionary_plain(*targs, **kw)
    assert calls[0] == (0 if nstate == 0 else C * ntr)
    for g_, w in zip(got, want):
        assert g_.dtype == torch.float64 and g_.shape == (ntr, C, 37)
        assert torch.isfinite(g_).all() and torch.equal(g_, w)


def test_xgre_geometry():
    """For every (nstate, C) the gate admits: x_rows' rows per lane, at
    most 6 C R = 72 floats of state, the ladder's own length on one lane
    while it fits (the kernel's one-lane instance), else ceil(H / W) on
    the fewest lanes W, above 12 / C / 2 rows (the kernel's general
    instances); a segment of W = ceil(H / R) <= 32 lanes, R W >= H, as
    many ladders per warp as fit, 1-4 warps per block (4 unless the coefficient table needs fewer), 1-32
    TRs per chunk, the coefficient table, TR table and staged echoes within
    48 KB, and a grid whose (block, warp, segment) slots store each of 1,
    2, 33 and 4,097 atoms exactly once."""
    seen = 0
    for C, deepest in XGRE_PRIMAL_TOP.items():
        top = 12 // C
        for n in range(0, 302):
            if not cuda_xgre.xgre_kernel_fits(n, C):
                continue
            geo = cuda_xgre.xgre_geometry(n, C)
            H, R, W, L = n + 1, geo["R"], geo["W"], geo["L"]
            assert R == cuda_xgre.x_rows(n, C) and 6 * C * R <= 72
            assert geo["one"] == (H <= top) == (R == H) == (W == 1)
            assert geo["one"] or 2 * R > top      # an instance of the kernel
            assert R == -(-H // W)
            assert W == -(-H // R) == -(-H // min(H, top)) <= 32
            assert W * R >= H
            assert L == 32 // W and geo["atoms"] == geo["warps"] * L
            coef = (6 * C * C) | 1                 # odd record stride
            per = cuda_xgre.X_TABLE * C + 2 * C * geo["atoms"]
            assert geo["coef"] == coef
            assert 1 <= geo["warps"] <= 4
            assert geo["warps"] == 4 or (
                coef * 2 * geo["atoms"] + per + 2 * C * geo["atoms"]
                > 12288)
            assert 1 <= geo["pulses"] <= 32
            assert geo["smem"] == 4 * (coef * geo["atoms"]
                                       + geo["pulses"] * per) <= 48 * 1024
            for B_ in (1, 2, 33, 4097):
                owned, _ = seg_owned_atoms(geo, B_)
                assert sorted(owned) == list(range(B_)), (n, C, B_)
            seen += 1
    assert seen == sum(t + 1 for t in XGRE_PRIMAL_TOP.values())
    main = cuda_xgre.xgre_geometry(10, 2)
    assert (main["R"], main["W"], main["L"], main["warps"], main["one"],
            main["pulses"]) == (6, 2, 16, 4, False, 32)
    flat = cuda_xgre.xgre_geometry(0, 2)
    assert (flat["R"], flat["W"], flat["L"], flat["one"]) == (1, 1, 32, True)


def test_xgre_gate_unchanged():
    """The primal kernels' gate (xgre_kernel_fits, which the composite
    EPG-X kernel shares) answers as the thread-per-atom layout set it: 6 C
    planes of nstate + 1 rows at 32 threads in 232,448 bytes -- nstate <=
    301, 150, 99 and 74 for C = 1, 2, 3, 4 -- over nstate 0-301; and the
    dispatch's gate takes every balanced train."""
    from epgpy_torch.models import cuda_fisp

    assert cuda_fisp.SMEM_PER_BLOCK == 232448
    table = {C: [cuda_xgre.xgre_kernel_fits(n, C) for n in range(302)]
             for C in range(1, 5)}
    for C, top in XGRE_PRIMAL_TOP.items():
        assert table[C] == [n <= top for n in range(302)], C
    for C in range(1, 5):
        assert tfd.xgre_kernel_fits(dict(balanced=True, C=C), 400)
        assert not tfd.xgre_kernel_fits(dict(balanced=False, C=C),
                                        XGRE_PRIMAL_TOP[C] + 1)
