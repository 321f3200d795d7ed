"""The composite EPG-X family of epgpy_torch vs epgpy_tpu: the kernels'
plain twins, simulate(density=) dispatch, fall-through, the golden, the
Jacobian and the family table.

* ``xcomposite_plain`` / ``xcomposite_jacobian_plain`` (float32) vs the
  JAX Pallas kernels in interpret mode over ``chip_smoke.XCOMP_CASES`` (MT
  prep, IR-MT with adiabatic stages beside a B1 batch, balanced, shifts up
  and down with ADC phases over three pools, sparse readouts with df), 8
  atoms x 24 stages (12 for three pools and for the Jacobian): signals
  2e-6 absolute (1e-5 for the primal over three pools, whose tables come
  from torch.linalg.matrix_exp against the JAX f32 Pade; the Jacobian
  takes its tables as inputs), tangent columns 1e-5 of the column's scale;
* ``simulate(density=..., fisp_kernel="force")`` (the twin, float64) vs
  the float64 general path at 1e-10 on the JAX tests' prepared trains, the
  dispatch counted; ``match_xcomposite`` == the JAX matcher's dict; the
  fall-through cases of ``tests/test_xcomposite_dispatch.py:123`` fall
  through; the exact-pattern xgre family keeps its trains;
* the golden ``xcomp_gre.npz`` at 1e-10 (float64);
* the float64 Jacobian twin vs central finite differences of the general
  path (free-pool T2 and the exchange rate), 1e-6 relative;
* the segmented kernels' lane maps (``epg::seg_shift_blocked``,
  ``epg::seg_shift_blocked_down`` and the one-lane ``epg::lane_shift``
  replayed in numpy) leave the float64 twins exactly as they were; their
  launch geometries (rows per lane, warps, chunk and table mode) for every
  ladder the gates admit, and the gates as before.
"""

import os

import numpy as np
import pytest
import torch

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch.convert import from_numpy_xparams
from epgpy_torch.models import cuda_xcomposite
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu.models import pallas_xcomposite

from chip_smoke import (X_ROW_EDGES, XCOMP_CASES, make_xcomp_case,
                        make_xcomp_jac_case, xcomp_golden_train,
                        xcomp_tensors)
from epgpy_torch.models import cuda_fisp, cuda_xgre, planes
from torch_support import (GOLDEN_DIR, cplx, port_f32,  # noqa: F401
                           port_f64, same_match, seg_owned_atoms,
                           seg_shift_emulated, to_f64)

B, NSTAGE = 8, 24


def _tol(case):
    return 2e-6 if case.get("C", 2) <= 2 else 1e-5


def _nstage(case, jac=False):
    """Stages of a JAX interpret-mode comparison: its cost grows with the
    groups and the square of the pools."""
    return NSTAGE // 2 if jac or case.get("C", 2) > 2 else NSTAGE


@pytest.mark.parametrize("case", XCOMP_CASES, ids=lambda c: c["name"])
def test_xcomposite_twin_matches_jax_kernel(case):
    args, kw = make_xcomp_case(case, B, _nstage(case))
    want = pallas_xcomposite.xcomposite_pallas(*args, interpret=True,
                                               btile=128, **kw)
    got = cuda_xcomposite.xcomposite_plain(
        *xcomp_tensors(torch, args, "cpu"), **kw)
    assert got[0].shape == (kw["nadc"], case.get("C", 2), B)
    assert np.abs(cplx(*got) - cplx(*want)).max() < _tol(case)


@pytest.mark.parametrize("case", XCOMP_CASES, ids=lambda c: c["name"])
def test_xcomposite_jacobian_twin_matches_jax_kernel(case):
    args, kw = make_xcomp_jac_case(torch, case, B, _nstage(case, True))
    want = pallas_xcomposite.xcomposite_jacobian_pallas(
        *args, interpret=True, btile=128, **kw)
    got = cuda_xcomposite.xcomposite_jacobian_plain(
        *xcomp_tensors(torch, args, "cpu", jac=True), **kw)
    g, w = cplx(*got), cplx(*want)
    assert g.shape == w.shape == (kw["nadc"], 3, case.get("C", 2), B)
    assert np.abs(g[:, 0] - w[:, 0]).max() < 2e-6
    for v in (1, 2):
        scale = np.abs(w[:, v]).max()
        assert scale > 0
        assert np.abs(g[:, v] - w[:, v]).max() < 1e-5 * scale


def _pools(e, B=4, C=2, k=0.005):
    dens = np.asarray([0.85, 0.15][:C])
    dens = dens / dens.sum()
    khi = (np.zeros((C, C)) if k == 0
           else e.exchange_matrix(k, ncomp=C, densities=dens))
    T2 = np.stack([np.linspace(40.0, 120.0, B)]
                  + [np.full(B, 0.012 * (c + 1)) for c in range(C - 1)])
    return dens, khi, np.linspace(800.0, 1200.0, C), T2


def _mt_prep_train(e, nseg=3, nread=5, B=4, *, balanced=False, ir=False,
                   b1=None, seed=11, k=0.005, T2=None):
    """tests/test_xcomposite_dispatch.py's segmented MT-GRE in package `e`:
    per segment a saturation block (or an adiabatic inversion) and a
    recovery X, nread readouts, a recovery delay."""
    dens, khi, T1, T2_ = _pools(e, B, k=k)
    T2 = T2_ if T2 is None else T2
    rng = np.random.default_rng(seed)
    Xte = e.X(3.0, khi, axis=0, T1=T1, T2=T2)
    Xtr = e.X(7.0, khi, axis=0, T1=T1, T2=T2)
    Xrec = e.X(120.0, khi, axis=0, T1=T1, T2=T2)
    seq = []
    for s in range(nseg):
        if ir:
            seq += [e.T(np.asarray([180.0, 0.0]), 0.0), Xrec]
        else:
            seq += [e.R(0, rL=np.asarray([0.0, 0.3 + 0.05 * s]), r0=None),
                    Xrec]
        for i in range(nread):
            fa = float(rng.uniform(8, 15))
            al = (np.asarray([fa, 0.0]) if b1 is None
                  else np.stack([fa * b1, np.zeros(B)]))
            seq += [e.T(al, 0.0), Xte, e.ADC, Xtr]
            if not balanced:
                seq.append(e.S(1))
        seq += [Xrec]
    return seq, list(dens)


TRAINS = {
    "mt_prep": dict(),
    "ir_mt": dict(nseg=2, nread=6, B=3, ir=True),
    "balanced": dict(nseg=2, nread=5, B=3, balanced=True),
    "ir_b1": dict(nseg=2, nread=5, B=4, ir=True,
                  b1=np.linspace(0.85, 1.15, 4)),
}


@pytest.mark.parametrize("name", sorted(TRAINS))
def test_simulate_density_dispatch_matches_general_path(port_f64, name):
    kw = TRAINS[name]
    seq, dens = _mt_prep_train(tepg, **kw)
    shape = (2, kw.get("B", 4))
    params = tfd.match_xcomposite(seq, shape, dens)
    assert params is not None
    assert tfd.match_xgre(seq, shape, dens) is None
    jseq, _ = _mt_prep_train(jepg, **kw)
    same_match(params, jfd.match_xcomposite(jseq, shape, dens))
    if kw.get("ir") and kw.get("b1") is not None:
        assert (np.asarray(params["b1u"]) == 0.0).sum() >= 2
    tfd.clear_cache()
    tfd.DISPATCH_COUNTS.clear()
    ns = 1 if kw.get("balanced") else 5
    out = tepg.simulate(seq, max_nstate=ns, density=dens,
                        fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS == {"xcomp": 1}
    ref = tepg.simulate(seq, max_nstate=ns, density=dens, fisp_kernel=False)
    assert out.shape == ref.shape == (params["nadc"],) + shape
    assert np.abs(out - ref).max() < 1e-10


def test_match_extracts_params():
    seq, dens = _mt_prep_train(tepg)
    params = tfd.match_xcomposite(seq, (2, 4), dens)
    assert params["C"] == 2 and params["nadc"] == 15 and params["has_sat"]
    assert sorted(params["taus"]) == [0.0, 3.0, 7.0, 120.0]
    assert np.all(np.asarray(params["b1u"]) == 1.0)


@pytest.mark.parametrize("mutate", ["mixed_generator", "z0_adc",
                                    "batched_tau"])
def test_fall_through(port_f64, mutate):
    out = []
    for e in (tepg, jepg):
        seq, dens = _mt_prep_train(e, nseg=2, nread=4, B=3)
        i = next(j for j, op in enumerate(seq) if type(op) is e.X)
        x = seq[i]
        if mutate == "mixed_generator":
            seq[i] = e.X(3.0, e.exchange_matrix(0.004, ncomp=2,
                                                densities=dens), axis=0,
                         T1=np.asarray([800.0, 1200.0]), T2=x.T2)
        elif mutate == "z0_adc":
            j = next(j for j, op in enumerate(seq) if isinstance(op, e.Adc))
            seq[j] = e.Adc(attr="Z0")
        else:
            seq[i] = e.X(np.asarray([3.0, 3.0]), x.khi, axis=0, T1=x.T1,
                         T2=x.T2)
        fd = tfd if e is tepg else jfd
        out.append(fd.match_xcomposite(seq, (2, 3), dens))
        if e is tepg and mutate != "batched_tau":
            got = tepg.simulate(seq, fisp_kernel="force", max_nstate=4,
                                density=dens)
            assert np.isfinite(got).all()
    assert out == [None, None]


def test_exact_xgre_still_wins(port_f64):
    """A canonical per-TR train stays with the exact-pattern xgre family
    (first in the table), which the composite matcher would also take."""
    dens, khi, T1, T2 = _pools(tepg, 3)
    X2 = tepg.X(10.0, khi, axis=0, T1=T1, T2=T2)
    seq = []
    for _ in range(6):
        seq += [tepg.T(np.asarray([12.0, 0.0]), 0.0), tepg.ADC, X2,
                tepg.S(1)]
    dens = list(dens)
    assert tfd.match_xgre(seq, (2, 3), dens) is not None
    assert tfd.match_xcomposite(seq, (2, 3), dens) is not None
    tfd.DISPATCH_COUNTS.clear()
    out = tepg.simulate(seq, max_nstate=5, density=dens, fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS == {"xgre": 1}
    ref = tepg.simulate(seq, max_nstate=5, density=dens, fisp_kernel=False)
    assert np.abs(out - ref).max() < 1e-10


def test_xcomp_gre_golden(port_f64):
    """tests/golden/xcomp_gre.npz (tools/make_golden.py:1103)."""
    g = np.load(os.path.join(GOLDEN_DIR, "xcomp_gre.npz"))
    seq = xcomp_golden_train(tepg)
    tfd.DISPATCH_COUNTS.clear()
    for fk in (False, "force"):
        sig = tepg.simulate(seq, max_nstate=8, density=[0.85, 0.15],
                            fisp_kernel=fk)
        assert np.abs(sig - g["signal"]).max() < 1e-10
    assert tfd.DISPATCH_COUNTS == {"xcomp": 1}


def test_jacobian_twin_finite_differences(port_f64):
    """The float64 Jacobian twin vs central differences of the general path
    over the free pool's T2 (per atom) and the exchange rate
    (tests/test_xcomposite_dispatch.py:179's problem, tighter)."""
    Bn = 4
    seq, dens = _mt_prep_train(tepg, nseg=2, nread=4, B=Bn)
    params = tfd.match_xcomposite(seq, (2, Bn), dens)
    d = np.asarray(dens)
    kron = np.asarray([[1.0, -1.0], [-1.0, 1.0]]) / d
    T1m = np.broadcast_to(np.asarray([800.0, 1200.0])[:, None], (2, Bn))
    T2f0, k0 = np.linspace(40.0, 120.0, Bn), 0.005

    def tables(t2f, k):
        T2 = torch.stack([t2f, torch.full_like(t2f, 0.012)])
        return cuda_xcomposite.xcomposite_stage_mat_tables(
            k * torch.as_tensor(kron), T1m, T2, None, params["taus"])

    t2 = torch.as_tensor(T2f0)
    k = torch.tensor(k0, dtype=torch.float64)
    mats = tables(t2, k)
    _, dm_t2 = torch.func.jvp(lambda t: tables(t, k), (t2,),
                              (torch.ones_like(t2),))
    _, dm_k = torch.func.jvp(lambda kk: tables(t2, kk), (k,),
                             (torch.ones_like(k),))
    zeros = np.zeros((2, Bn))
    re, im = cuda_xcomposite.xcomposite_jacobian_plain(
        *(params[n] for n in ("alpha", "phi", "satf_re", "satf_im",
                              "satz_re", "satz_im", "adci", "shift", "aph",
                              "mia", "mib")),
        d, mats, [dm_t2, dm_k], [zeros, zeros], nadc=params["nadc"],
        nstate=5, has_up=True, has_sat=True)
    got = cplx(re, im)

    def general(t2f, kk):
        s, _ = _mt_prep_train(tepg, nseg=2, nread=4, B=Bn, k=kk,
                              T2=np.stack([t2f, np.full(Bn, 0.012)]))
        return tepg.simulate(s, max_nstate=5, density=dens,
                             fisp_kernel=False)

    assert np.abs(got[:, 0] - general(T2f0, k0)).max() < 1e-10
    for v, (dx, h) in enumerate(((np.ones(Bn), 1e-4), (None, 1e-7)), 1):
        if dx is not None:
            fd = (general(T2f0 + h, k0) - general(T2f0 - h, k0)) / (2 * h)
        else:
            fd = (general(T2f0, k0 + h) - general(T2f0, k0 - h)) / (2 * h)
        assert np.abs(got[:, v] - fd).max() < 1e-6 * np.abs(fd).max()


def test_converted_jax_match_runs_to_jax_values(port_f32):
    seq, dens = _mt_prep_train(jepg, nseg=2, nread=4, B=4, ir=True,
                               b1=np.linspace(0.9, 1.1, 4))
    jparams = jfd.match_xcomposite(seq, (2, 4), dens)
    want = jfd.run_xcomposite_kernel(jparams, 5, interpret=True)
    got = tfd.run_xcomposite_kernel(from_numpy_xparams(jparams, "cpu"), 5)
    w = np.asarray(want["__c_re"]) + 1j * np.asarray(want["__c_im"])
    assert got.shape == w.shape
    assert np.abs(got.numpy() - w).max() < 2e-6


def test_echo_layout_and_launch_counters():
    args, kw = make_xcomp_case(XCOMP_CASES[-1], 4, 12)
    targs = xcomp_tensors(torch, args, "cpu")
    jargs, jkw = make_xcomp_jac_case(torch, XCOMP_CASES[-1], 4, 12)
    tj = xcomp_tensors(torch, jargs, "cpu", jac=True)
    before = (cuda_xcomposite.LAUNCHES, cuda_xcomposite.JAC_LAUNCHES)
    re, _ = cuda_xcomposite.xcomposite_echoes(*targs, **kw)
    jre, _ = cuda_xcomposite.xcomposite_jacobian_echoes(*tj, **jkw)
    assert (cuda_xcomposite.LAUNCHES, cuda_xcomposite.JAC_LAUNCHES) == before
    assert torch.allclose(re, jre[:, 0], atol=1e-6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_xcomposite.xcomposite_cuda(*targs, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_xcomposite.xcomposite_jacobian_cuda(*tj, **jkw)


# -- the segmented layout of xcomposite_jac.cu: down shift, lane map,
# geometry, gate --


@pytest.mark.parametrize("H", [2, 3, 9, 10, 25, 151])
def test_seg_shift_blocked_down_emulation(H):
    """epg::seg_shift_blocked_down, replayed in numpy (NaN in the idle
    lanes, past the last atom and in the padding rows), equals
    planes.shift_down exactly at every R from 1 to 5 that the layout takes
    (W = ceil(H / R) <= 32), and leaves the padding rows' A and B planes
    zero."""
    rng = np.random.default_rng(H)
    s = tuple(torch.as_tensor(rng.normal(size=(H, 7))) for _ in range(6))
    ran = 0
    for R in range(1, 6):
        if -(-H // R) > 32:
            continue
        got, pad = seg_shift_emulated(s, R, down=True, padding=True,
                                      blocked=True)
        for g_, w in zip(got, planes.shift_down(s)):
            assert torch.equal(g_, w), R
        assert (pad == 0.0).all(), R
        ran += 1
    assert ran == (1 if H == 151 else 5)


def _deepest(C, G):
    """The gate's deepest ladder for (C, G): its largest H = nstate + 1."""
    return max(n for n in range(401)
               if cuda_xgre.xgre_jac_kernel_fits(n, C, G)) + 1


#: (C, G, H) of the lane-map replay: one to four pools, at the exchange-rate
#: fit's ladder (H = 9) and at the gate's deepest for each (C, G)
XCOMP_LANE_RUNS = [(C, G, H) for C, G in ((1, 2), (2, 2), (2, 3), (3, 4),
                                          (4, 3))
                   for H in (9, _deepest(C, G))]


@pytest.mark.parametrize("C,G,H", XCOMP_LANE_RUNS, ids=lambda v: str(v))
def test_xcomp_jac_lane_map_matches_twin(monkeypatch, C, G, H):
    """The float64 Jacobian twin with every up and down shift replayed
    through the kernel's blocked lane map at its rows per lane
    (epg::seg_shift_blocked and epg::seg_shift_blocked_down, emulated in
    numpy with NaN in the idle lanes and padding rows) is within 1e-12 of
    the twin (equal), every group, pool and readout: up, down and
    unshifted stages, ADC phases, saturation, adiabatic stages, sparse
    readouts, over more stages than the ladder has rows."""
    case = dict(name="lane_map", C=C, V=G - 1, nstate=H - 1, shift="mixed",
                adcph=True, sat=True, b1u=True, g=True, sparse=True)
    jargs, kw = make_xcomp_jac_case(torch, case, 37, H + 6, seed=4)
    assert {-1.0, 0.0, 1.0} <= set(np.asarray(jargs[7]).tolist())
    targs = to_f64(xcomp_tensors(torch, jargs, "cpu", jac=True))
    want = cuda_xcomposite.xcomposite_jacobian_plain(*targs, **kw)
    geo = cuda_xcomposite.xcomp_jac_geometry(H - 1, C, G,
                                             len(jargs[12][0]))
    R = geo["R"]
    monkeypatch.setattr(planes, "shift_fold",
                        lambda x: seg_shift_emulated(x, R, blocked=True))
    monkeypatch.setattr(planes, "shift_down",
                        lambda x: seg_shift_emulated(x, R, down=True,
                                                     blocked=True))
    got = cuda_xcomposite.xcomposite_jacobian_plain(*targs, **kw)
    assert got[0].dtype == torch.float64
    assert got[0].shape == (kw["nadc"], G, C, 37)
    for g_, w in zip(got, want):
        assert torch.isfinite(g_).all()
        assert float((g_ - w).abs().max()) <= 1e-12
        assert torch.equal(g_, w)


#: the rows per lane a (C, G) instance of the kernel takes at most (its
#: max_rows): the rule at the gate's deepest ladder
XCOMP_MAX_ROWS = {2: 5, 3: 4, 4: 3, 5: 2, 6: 2, 8: 2, 9: 2, 10: 1, 12: 1}


def _global_nmat(nstate, C, G):
    """The fewest table entries whose records pass one warp's share of the
    block (the kernel's global-read mode)."""
    _, _, L = cuda_fisp.seg_layout(nstate,
                                   cuda_xcomposite.xcomp_jac_rows(nstate, C,
                                                                  G))
    per = (cuda_xcomposite.XCOMP_JAC_TABLE * C
           + cuda_xcomposite.XCOMP_JAC_STAGE + 2 * G * C * L)
    nmat = 1
    while ((nmat * G * 3 * C * C + C * G) | 1) * L + per <= 12288:
        nmat += 1
    return nmat


def test_xcomp_jac_geometry():
    """For every (nstate, C, G) the gate admits, at 4 table entries (the
    exchange-rate fit's) and at the fewest entries that pass one warp's
    share of the block, and at one fewer: 1 row per lane up to 3 rows,
    else ceil(H / 32), at least 3 while C G <= 4 and 2 while C G <= 6 (at
    most the kernel's instance, XCOMP_MAX_ROWS); a segment of W = ceil(H / R)
    <= 32 lanes, as many ladders per warp as fit; the mode reported --
    the records in shared memory while one warp's records and one stage's
    table and echoes fit 48 KB, else read from device memory -- 1-4 warps
    per block (4 unless the records need fewer), 1-32 stages per chunk,
    the block's tables and staged echoes within 48 KB, and a grid whose
    (block, warp, segment) slots store each of 1, 2, 3, 33 and 4,097
    atoms exactly once."""
    seen = dict(shared=0, device=0)
    for C in range(1, 5):
        for G in range(2, 6):
            if C * G > 12:
                continue
            for n in range(0, 401):
                if not cuda_xgre.xgre_jac_kernel_fits(n, C, G):
                    continue
                big = _global_nmat(n, C, G)
                for nmat in sorted({4, big - 1, big} - {0}):
                    geo = cuda_xcomposite.xcomp_jac_geometry(n, C, G, nmat)
                    H, R, W, L = n + 1, geo["R"], geo["W"], geo["L"]
                    assert R == (1 if H <= 3 else max(
                        -(-H // 32), 3 if C * G <= 4 else
                        2 if C * G <= 6 else 1))
                    assert R <= XCOMP_MAX_ROWS[C * G]
                    assert W == -(-H // R) <= 32 and W * R >= H
                    assert L == 32 // W
                    assert geo["atoms"] == geo["warps"] * L
                    coef = (nmat * G * 3 * C * C + C * G) | 1
                    per = (cuda_xcomposite.XCOMP_JAC_TABLE * C
                           + cuda_xcomposite.XCOMP_JAC_STAGE
                           + 2 * G * C * geo["atoms"])
                    assert geo["coef"] == coef
                    assert geo["shared"] == (nmat < big)
                    table = coef * geo["atoms"] if geo["shared"] else 0
                    assert 1 <= geo["warps"] <= 4
                    assert geo["warps"] == 4 or (
                        geo["shared"] and coef * 2 * geo["atoms"]
                        + per + 2 * G * C * geo["atoms"] > 12288)
                    assert 1 <= geo["pulses"] <= 32
                    assert geo["smem"] == 4 * (table + geo["pulses"] * per)
                    assert geo["smem"] <= 48 * 1024
                    assert geo["smem"] <= cuda_fisp.SMEM_PER_BLOCK
                    for B_ in (1, 2, 3, 33, 4097):
                        owned, _ = seg_owned_atoms(geo, B_)
                        assert sorted(owned) == list(range(B_)), (n, C, G)
                    seen["shared" if geo["shared"] else "device"] += 1
    assert seen == dict(shared=1492, device=749)
    kfit = cuda_xcomposite.xcomp_jac_geometry(8, 2, 2, 4)
    assert (kfit["R"], kfit["W"], kfit["L"], kfit["warps"], kfit["coef"],
            kfit["shared"]) == (3, 3, 10, 4, 101, True)


def test_xcomp_jac_gate_unchanged():
    """The Jacobian entry point's gate (cuda_xgre._check_jac_fits) answers
    as the thread-per-atom layout set it: 1-4 pools, 2-5 groups with C G
    <= 12, and 6 C G planes of nstate + 1 rows at 32 threads in 232,448
    bytes, for nstate 0-400."""
    for n in range(401):
        for C in range(0, 6):
            for G in range(1, 7):
                fits = (1 <= C <= 4 and 2 <= G <= 5 and C * G <= 12
                        and 4 * 6 * C * G * (n + 1) * 32 <= 232448)
                try:
                    cuda_xcomposite._check_jac_fits("x", C, G, n)
                    took = True
                except ValueError:
                    took = False
                assert took == fits, (n, C, G)


# -- the segmented layout of xcomposite.cu (blocked rows, every pool of a
# row on one lane): lane map, geometry --


@pytest.mark.parametrize("C,nstate", [(C, n) for C, ns in X_ROW_EDGES.items()
                                      for n in ns], ids=str)
def test_xcomp_lane_map_matches_twin(monkeypatch, C, nstate):
    """The float64 primal twin with every up and down shift replayed
    through the kernel's lane map at its rows per lane (xcomp_geometry;
    blocked rows, epg::seg_shift_blocked and epg::seg_shift_blocked_down --
    epg::lane_shift for a ladder on one lane -- emulated in numpy with NaN
    in the idle lanes, past the last atom and in the padding rows) equals
    the twin, every pool and readout: up, down and unshifted stages in one
    train (none at nstate 0), ADC phases, saturation, adiabatic stages,
    sparse readouts, df, over 21 stages more than the ladder has rows."""
    case = dict(name="lane_map", C=C, nstate=nstate,
                shift="mixed" if nstate else "none", adcph=True, sat=True,
                b1u=True, g=True, sparse=True)
    args, kw = make_xcomp_case(case, 5, nstate + 21, seed=2)
    shifts = np.asarray(args[7])
    assert set(shifts.tolist()) == ({-1.0, 0.0, 1.0} if nstate else {0.0})
    targs = to_f64(xcomp_tensors(torch, args, "cpu"))
    want = cuda_xcomposite.xcomposite_plain(*targs, **kw)
    geo = cuda_xcomposite.xcomp_geometry(nstate, C, len(args[12]))
    calls = [0]

    def shift(down):
        def run(x):
            calls[0] += 1
            return seg_shift_emulated(x, geo["R"], down=down, blocked=True)
        return run

    monkeypatch.setattr(planes, "shift_fold", shift(False))
    monkeypatch.setattr(planes, "shift_down", shift(True))
    got = cuda_xcomposite.xcomposite_plain(*targs, **kw)
    assert calls[0] == C * int((shifts != 0).sum())
    for g_, w in zip(got, want):
        assert g_.dtype == torch.float64 and g_.shape == (kw["nadc"], C, 5)
        assert torch.isfinite(g_).all() and torch.equal(g_, w)


def test_xcomp_geometry():
    """For every (nstate, C) the primal gate admits (xgre_kernel_fits), at
    1, 4 and 6 table entries (the MT-prepared train's 4, the option cases'
    6) and at the fewest entries whose records pass one warp's share of the
    block, and one fewer: cuda_xgre.x_rows' rows per lane (xgre.cu's
    layout), a segment of W = ceil(H / R) <= 32 lanes; the mode -- the
    records in shared memory while one warp's records and one stage's
    table and echoes fit 48 KB, else read from device memory -- 1-4 warps
    per block (4 unless the records need fewer), 1-32 stages per chunk,
    the block's tables and staged echoes within 48 KB, and a grid whose
    slots store each of 1, 33 and 4,097 atoms exactly once."""
    seen = dict(shared=0, device=0)
    for C in range(1, 5):
        for n in range(0, 302):
            if not cuda_xgre.xgre_kernel_fits(n, C):
                continue
            R, W, L = cuda_fisp.seg_layout(n, cuda_xgre.x_rows(n, C))
            per = (cuda_xgre.X_TABLE * C + cuda_xcomposite.XCOMP_STAGE
                   + 2 * C * L)
            big = 1
            while ((big * 3 * C * C) | 1) * L + per <= 12288:
                big += 1
            for nmat in sorted({1, 4, 6, big - 1, big} - {0}):
                geo = cuda_xcomposite.xcomp_geometry(n, C, nmat)
                assert (geo["R"], geo["W"], geo["L"]) == (R, W, L)
                assert geo["one"] == (R == n + 1) and W <= 32
                coef = (nmat * 3 * C * C) | 1
                per = (cuda_xgre.X_TABLE * C + cuda_xcomposite.XCOMP_STAGE
                       + 2 * C * geo["atoms"])
                assert geo["coef"] == coef
                assert geo["shared"] == (nmat < big)
                assert geo["atoms"] == geo["warps"] * L
                table = coef * geo["atoms"] if geo["shared"] else 0
                assert 1 <= geo["warps"] <= 4
                assert geo["warps"] == 4 or (
                    geo["shared"] and coef * 2 * geo["atoms"] + per
                    + 2 * C * geo["atoms"] > 12288)
                assert 1 <= geo["pulses"] <= 32
                assert geo["smem"] == 4 * (table + geo["pulses"] * per)
                assert geo["smem"] <= 48 * 1024
                for B_ in (1, 33, 4097):
                    owned, _ = seg_owned_atoms(geo, B_)
                    assert sorted(owned) == list(range(B_)), (n, C, nmat)
                seen["shared" if geo["shared"] else "device"] += 1
    assert seen["device"] == sum(t + 1 for t in (301, 150, 99, 74))
    mtp = cuda_xcomposite.xcomp_geometry(8, 2, 4)
    assert (mtp["R"], mtp["W"], mtp["L"], mtp["warps"], mtp["coef"],
            mtp["shared"], mtp["pulses"]) == (5, 2, 16, 4, 49, True, 32)
