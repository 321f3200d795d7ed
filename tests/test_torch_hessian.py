"""The per-pulse Hessian kernel's plain twin and dispatch vs epgpy_tpu.

Modelled on tests/test_hessian_dispatch.py (the JAX package's own tests of
the same path):

* ``fisp_hessian_plain`` (what ``fisp_hessian_cuda`` runs for CPU
  tensors) equals ``fisp_hessian_pallas(interpret=True)`` in float32 on
  the 4-op form, the 5-op form with TE and inversion, and second_order on
  and off, to 1e-6 of each output block's largest magnitude (same
  operation order; XLA and torch round some steps differently); entries
  with pulse > echo are exact zeros, and the first-order outputs of the
  order-1 and order-2 runs are identical;
* ``simulate(fisp_kernel="force")`` (the twin in float32) equals the
  port's general order-2 path (nested forward mode) in float64 to 5e-6
  of each output's largest magnitude, the JAX test's budget;
* ``match_fisp_hessian`` and ``match_hessian_probes`` return the JAX
  matchers' results, and off-pattern trains fall through in both;
* a JAX Hessian match dict carried through ``convert.from_numpy_params``
  runs in the port's ``run_fisp_hessian`` to the port's own result.
"""

import logging

import numpy as np
import pytest
import torch

import epgpy_torch as tepg
import epgpy_tpu as jepg
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch.convert import from_numpy_params
from epgpy_torch.models import cuda_fisp, cuda_hessian
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu.models.pallas_hessian import fisp_hessian_pallas

from torch_support import (hessian_two_pass, port_f32,  # noqa: F401
                           port_f64, seg_shift_emulated)

NTR = 10
RNG = np.random.default_rng(7)
FA = RNG.uniform(10, 60, NTR)
TAU = RNG.uniform(11, 16, NTR)
TR5 = np.random.default_rng(11).uniform(11, 16, NTR)
ALPHAS = [f"alpha_{i:03d}" for i in range(NTR)]
TAUS = [f"tau_{i:03d}" for i in range(NTR)]


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- the plain twin vs the JAX kernel --

KERNEL_CASES = [
    dict(name="4op", T1=[1380.0], T2=[80.0]),
    dict(name="4op_order1", T1=[1380.0], T2=[80.0], second_order=False),
    dict(name="5op_te_inv", te=5.0, inversion=20.0, tau=TR5 - 5.0),
    dict(name="5op_te_inv_order1", te=5.0, inversion=20.0, tau=TR5 - 5.0,
         second_order=False),
    dict(name="4op_inv_phi30_nstate10", inversion=25.0, phi=30.0, nstate=10),
]


def _kernel_args(case):
    T1 = np.asarray(case.get("T1", [800.0, 1380.0, 1900.0]))
    T2 = np.asarray(case.get("T2", [45.0, 80.0, 110.0]))
    kw = dict(te=case.get("te"), inversion=case.get("inversion"),
              nstate=case.get("nstate", 6),
              second_order=case.get("second_order", True))
    return (FA, case.get("phi", 90.0), case.get("tau", TAU), T1, T2), kw


def _f32(x):
    return x if np.ndim(x) == 0 else torch.as_tensor(
        np.asarray(x, np.float32))


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: c["name"])
def test_plain_twin_matches_pallas_kernel(case):
    args, kw = _kernel_args(case)
    want = fisp_hessian_pallas(*args, interpret=True, **kw)
    got = cuda_hessian.fisp_hessian_cuda(*map(_f32, args), **kw)
    assert set(got) == set(want)
    for key in want:
        for c in (0, 1):
            assert got[key][c].dtype == torch.float32
            assert rel_err(got[key][c], want[key][c]) < 1e-6, (key, c)


@pytest.mark.parametrize("case", KERNEL_CASES[::2], ids=lambda c: c["name"])
def test_causality_and_first_order_outputs(case):
    args, kw = _kernel_args(case)
    targs = tuple(map(_f32, args))
    o2 = cuda_hessian.fisp_hessian_plain(*targs, **{**kw,
                                                    "second_order": True})
    o1 = cuda_hessian.fisp_hessian_plain(*targs, **{**kw,
                                                    "second_order": False})
    assert set(o2) - set(o1) == {"dT1dalpha", "dT2dalpha", "dT1dtau",
                                 "dT2dtau"}
    for key in o1:
        for c in (0, 1):
            assert torch.equal(o1[key][c], o2[key][c]), key
    for key, pair in o2.items():
        for part in pair:
            if part.ndim == 3:
                assert float(torch.triu(part, diagonal=1).abs().max()) == 0.0
                assert float(part.abs().max()) > 0.0


# -- the two-pass decomposition of csrc/fisp_hess.cu --


def _f64(x):
    return x if np.ndim(x) == 0 else torch.as_tensor(
        np.asarray(x, np.float64))


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: c["name"])
def test_two_pass_matches_plain_twin(case):
    """The kernel's decomposition -- an atom pass, the seeds, then each
    lane's two chains started at its own pulse and stepped in the m = 0
    form -- equals fisp_hessian_plain in float64 to 1e-12 of each output
    block's largest magnitude."""
    args, kw = _kernel_args(case)
    want = cuda_hessian.fisp_hessian_plain(*map(_f64, args), **kw)
    got = hessian_two_pass(*args, **kw)
    assert set(got) == set(want)
    for key in want:
        for c in (0, 1):
            assert got[key][c].dtype == torch.float64
            assert rel_err(got[key][c], want[key][c]) < 1e-12, (key, c)


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: c["name"])
def test_two_pass_matches_pallas_kernel(case):
    """The decomposition against the JAX kernel in interpret mode, at the
    plain twin's tolerance: 1e-6 of each output block's largest magnitude,
    a block being the (re, im) pair (the JAX kernel computes in float32,
    so a part that is zero up to rounding -- dT1's imaginary part at phi
    90 -- is compared on its block's scale)."""
    args, kw = _kernel_args(case)
    want = fisp_hessian_pallas(*args, interpret=True, **kw)
    got = hessian_two_pass(*args, **kw)
    for key in want:
        scale = max(np.abs(np.asarray(w)).max() for w in want[key])
        for c in (0, 1):
            err = np.abs(np.asarray(got[key][c]) - np.asarray(want[key][c]))
            assert err.max() < 1e-6 * scale, (key, c)


@pytest.mark.parametrize("second_order", [True, False])
def test_chains_are_closed(second_order):
    """Zeroing one chain's seeds leaves the other chain's outputs
    bit-identical and its own exactly zero: after its pulse a lane's
    {A, W1, W2} and {T, X1, X2} groups never read each other."""
    args, kw = _kernel_args(dict(name="closure", te=5.0, inversion=20.0,
                                 tau=TR5 - 5.0, second_order=second_order))
    full = hessian_two_pass(*args, **kw)
    chains = {"A": ("dalpha", "dT1dalpha", "dT2dalpha"),
              "T": ("dtau", "dT1dtau", "dT2dtau")}
    for seeded, other in (("A", "T"), ("T", "A")):
        part = hessian_two_pass(*args, seeds=(seeded,), **kw)
        for key in chains[seeded]:
            if key in full:
                for c in (0, 1):
                    assert torch.equal(part[key][c], full[key][c]), key
        for key in chains[other]:
            if key in full:
                assert float(part[key][0].abs().max()) == 0.0
                assert float(full[key][0].abs().max()) > 0.0


@pytest.mark.parametrize("second_order,nstate", [
    (True, 1), (True, 2), (True, 3), (True, 46),
    (False, 1), (False, 63), (False, 64), (False, 95), (False, 96),
    (False, 126)])
def test_two_pass_lane_map(monkeypatch, second_order, nstate):
    """The decomposition with every folded shift replayed through the
    kernel's segmented lane map at its rows per lane (hess_geometry: 1, 2,
    3 and 4 rows; epg::seg_shift emulated in numpy with NaN in the idle
    lanes and padding rows) equals it exactly, the gates' deepest ladders
    included, over a train longer than the ladder."""
    geo = cuda_hessian.hess_geometry(nstate, second_order)
    rng = np.random.default_rng(nstate)
    N = nstate + 4
    args = (rng.uniform(10, 60, N), 30.0, rng.uniform(11, 16, N),
            np.array([800.0, 1500.0]), np.array([45.0, 110.0]))
    kw = dict(inversion=20.0, nstate=nstate, second_order=second_order)
    want = hessian_two_pass(*args, **kw)

    def lane_map(s):
        shape = s[0].shape
        flat = seg_shift_emulated(tuple(p.reshape(shape[0], -1) for p in s),
                                  geo["R"])
        return tuple(p.reshape(shape) for p in flat)

    monkeypatch.setattr(cuda_hessian.planes, "shift_fold", lane_map)
    got = hessian_two_pass(*args, **kw)
    for key in want:
        for c in (0, 1):
            assert torch.equal(got[key][c], want[key][c]), key


def test_hess_geometry_and_gate():
    """For every ladder the gate admits (nstate 1-46 at second order,
    1-126 at first; the gate answers as before): rows per lane 2 (1 for H
    <= 3, ceil(H / 32) past 64 rows), at most 2 at second order and 4 at
    first, a segment of 2 <= W <= 32 lanes holding the H rows, L = 32 // W
    ladders per warp, a lane-pass block within SMEM_PER_BLOCK and a seed
    of 6 C planes x W R rows."""
    assert cuda_hessian.hess_kernel_fits(46)
    assert not cuda_hessian.hess_kernel_fits(47)
    assert cuda_hessian.hess_kernel_fits(126, False)
    assert not cuda_hessian.hess_kernel_fits(127, False)
    for so, top in ((True, 46), (False, 126)):
        for n in range(1, top + 1):
            geo = cuda_hessian.hess_geometry(n, so)
            H, R, W, L = n + 1, geo["R"], geo["W"], geo["L"]
            assert R == (1 if H <= 3 else 2 if H <= 64 else -(-H // 32))
            assert R <= (2 if so else 4)
            assert 2 <= W <= 32 and W == -(-H // R) and W * R >= H
            assert L == 32 // W and geo["atoms"] == L
            assert geo["lanes"] == cuda_hessian.HESS_WARPS * L
            assert geo["seed"] == 6 * (3 if so else 1) * W * R
            assert geo["smem"] <= cuda_fisp.SMEM_PER_BLOCK


def _lane_pass_writes(N, B, geo, C):
    """How often the lane pass writes each (plane, atom, echo j, lane i)
    of the (2G, B, N, N) output, replaying hess_lane_kernel's loops: per
    block (atom b, chain ch, lanes I0 .. I0 + A - 1) the rows j < I0 as
    zeros, then chunks of HESS_PULSES pulses from I0 flushed over the
    block's lanes below N."""
    A, T = geo["lanes"], cuda_hessian.HESS_PULSES
    grps = ((0, 2, 3), (1, 4, 5)) if C == 3 else ((0,), (1,))
    count = np.zeros((2 * (6 if C == 3 else 2), B, N, N), int)
    nI = -(-N // A)
    for blk in range(nI * 2 * B):
        ig, rem = divmod(blk, 2 * B)
        b, ch = divmod(rem, 2)
        I0 = ig * A
        nA = min(A, N - I0)
        planes = [2 * g + part for g in grps[ch] for part in (0, 1)]
        for o in planes:
            count[o, b, :I0, I0:I0 + nA] += 1
        for n0 in range(I0, N, T):
            nc = min(T, N - n0)
            for o in planes:
                count[o, b, n0:n0 + nc, I0:I0 + nA] += 1
    return count


@pytest.mark.parametrize("N,B,nstate,second_order", [
    (1, 1, 1, True), (2, 3, 10, True), (33, 2, 10, True),
    (70, 2, 46, True), (45, 1, 126, False), (97, 2, 1, False)])
def test_lane_pass_writes_every_output_once(N, B, nstate, second_order):
    geo = cuda_hessian.hess_geometry(nstate, second_order)
    count = _lane_pass_writes(N, B, geo, 3 if second_order else 1)
    assert (count == 1).all()


# -- the dispatch: trains, probes, matchers --


def build(e, T1=1380.0, T2=80.0, *, track_tau=True, phi=90.0):
    """The flagship 4-op per-pulse train in package `e`."""
    seq = []
    for i in range(NTR):
        o1 = {"T1": "T1", "T2": "T2"}
        if track_tau:
            o1[TAUS[i]] = "tau"
        seq += [e.T(FA[i], phi, order1={ALPHAS[i]: "alpha"}),
                e.E(TAU[i], T1, T2, order1=o1), e.ADC, e.S(1)]
    return seq


def build5(e, TE=5.0, TI=None, T1=1380.0, T2=80.0):
    """The 5-op constant-TE design form, optionally after an inversion."""
    tr = {"T1": "T1", "T2": "T2"}
    seq = [] if TI is None else [e.T(180, 0), e.E(TI, T1, T2, order1=tr)]
    for i in range(NTR):
        seq += [e.T(FA[i], 90, order1={ALPHAS[i]: "alpha"}),
                e.E(TE, T1, T2, order1=tr), e.ADC,
                e.E(TR5[i] - TE, T1, T2, order1={**tr, TAUS[i]: "tau"}),
                e.S(1)]
    return seq


def _prep4(e):
    return [e.T(180, 0), e.E(25.0, 1380., 80., order1={"T1": "T1",
                                                        "T2": "T2"})] + build(e)


FLAGSHIP = lambda e: [e.ADC, e.Jacobian(["magnitude", "T1", "T2"]),  # noqa
                      e.Hessian(["magnitude", "T1", "T2"], ALPHAS + TAUS)]
TRAINS = {
    "flagship": (build, FLAGSHIP),
    "scrambled_subset": (build, lambda e: [
        e.Jacobian([ALPHAS[3], "T2", TAUS[7], "magnitude"]),
        e.Hessian(["T2", "magnitude"], [TAUS[2], ALPHAS[5], ALPHAS[0]])]),
    "atom_vector": (lambda e: build(e, T1=np.array([800.0, 1380.0, 2000.0])),
                    lambda e: [e.ADC, e.Hessian(["T1", "T2"], ALPHAS)]),
    "no_tau_order1": (lambda e: build(e, track_tau=False),
                      lambda e: [e.Jacobian(["magnitude"] + ALPHAS)]),
    "5op": (build5, FLAGSHIP),
    "5op_prep": (lambda e: build5(e, TI=20.0), lambda e: [
        e.Hessian(["magnitude", "T1", "T2"], ALPHAS + TAUS)]),
    "4op_prep": (_prep4, lambda e: [e.ADC, e.Hessian(["T1", "T2"], ALPHAS)]),
}


@pytest.mark.parametrize("name", TRAINS)
def test_dispatch_equals_general_path(port_f64, name):
    """simulate(force): the twin in float32 == the general order-2 path
    in float64 to 5e-6 of each output's largest magnitude."""
    seq_fn, probes = TRAINS[name]
    before = tfd.DISPATCH_COUNTS.get("hessian", 0)
    got = tepg.simulate(seq_fn(tepg), probe=probes(tepg), max_nstate=10,
                        fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("hessian", 0) == before + 1
    ref = tepg.simulate(seq_fn(tepg), probe=probes(tepg), max_nstate=10,
                        fisp_kernel=False)
    assert tfd.DISPATCH_COUNTS.get("hessian", 0) == before + 1
    got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
    for g, r in zip(got, ref):
        assert g.dtype == np.complex64 and r.dtype == np.complex128
        assert rel_err(g, r) < 5e-6


def test_flagship_shapes_and_tensors(port_f32):
    sig, jac, hes = tepg.simulate(build(tepg), probe=FLAGSHIP(tepg),
                                  max_nstate=10, fisp_kernel="force",
                                  asarray=False)
    assert tuple(hes.shape) == (NTR, 1, 3, 2 * NTR)
    assert tuple(jac.shape) == (NTR, 1, 3) and tuple(sig.shape) == (NTR, 1)
    assert hes.dtype == torch.complex64
    # the magnitude column of the Jacobian is the signal; pulse i > echo j
    # is an exact zero
    assert torch.equal(jac[..., 0], sig)
    assert float(torch.triu(hes[:, 0, 1, :NTR], diagonal=1).abs().max()) \
        == 0.0


def test_fd_spot_check(port_f64):
    """d2S/dT2 dalpha_5 (fused, float32) against a central difference of
    the general path's alpha_5 Jacobian in T2 (the flagship example's
    check)."""
    got = tepg.simulate(build(tepg), probe=[tepg.Hessian(["T2"],
                                                         [ALPHAS[5]])],
                        max_nstate=10, fisp_kernel="force")
    eps = 1e-4

    def jac5(T2x):
        j = tepg.simulate(build(tepg, T2=T2x), max_nstate=10,
                          fisp_kernel=False,
                          probe=[tepg.Jacobian([ALPHAS[5]])])
        return j[..., 0]

    fd = (jac5(80.0 + eps) - jac5(80.0 - eps)) / (2 * eps)
    assert np.abs(got[..., 0, 0] - fd).max() < 1e-6


MATCH_TRAINS = {
    "flagship": (build, FLAGSHIP),
    "scrambled_subset": TRAINS["scrambled_subset"],
    "5op": (build5, FLAGSHIP),
    "5op_prep": TRAINS["5op_prep"],
    "4op_prep": TRAINS["4op_prep"],
}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("name", MATCH_TRAINS)
def test_matchers_equal_jax(name):
    seq_fn, probes = MATCH_TRAINS[name]
    jp = jfd.match_fisp_hessian(seq_fn(jepg))
    tp = tfd.match_fisp_hessian(seq_fn(tepg))
    assert jp is not None and tp is not None
    assert set(tp) - {"_dev"} == set(jp)
    for k in jp:
        assert _same(jp[k], tp[k]), k
    assert (tfd.match_hessian_probes(tuple(probes(tepg)), tp)
            == jfd.match_hessian_probes(tuple(probes(jepg)), jp))


def _mutate(e, name):
    seq = build(e)
    if name == "dup_alias":
        seq[4] = e.T(FA[1], 90, order1={ALPHAS[0]: "alpha"})
    elif name == "coeff":
        seq[0] = e.T(FA[0], 90, order1={ALPHAS[0]: {"alpha": 2.0}})
    elif name == "order2":
        seq[0] = e.T(FA[0], 90, order1={ALPHAS[0]: "alpha"},
                     order2=[(ALPHAS[0], ALPHAS[0])])
    elif name == "g":
        seq[1] = e.E(TAU[0], 1380., 80., g=0.01,
                     order1={"T1": "T1", "T2": "T2", TAUS[0]: "tau"})
    elif name == "shift2":
        seq[3] = e.S(2)
    elif name == "adc_phase":
        seq[2] = e.Adc(phase=30.0)
    elif name == "alias_reserved":
        seq[0] = e.T(FA[0], 90, order1={"T1": "alpha"})
    elif name == "tau_partial":
        seq[1] = e.E(TAU[0], 1380., 80., order1={"T1": "T1", "T2": "T2"})
    elif name == "no_alpha_alias":
        seq[0] = e.T(FA[0], 90)
    elif name == "prep_untracked_e":
        seq = [e.T(180, 0), e.E(25.0, 1380., 80.)] + seq
    elif name == "prep_non180":
        seq = [e.T(90, 0), e.E(25.0, 1380., 80.,
                               order1={"T1": "T1", "T2": "T2"})] + seq
    return seq


MUTATIONS = ["dup_alias", "coeff", "order2", "g", "shift2", "adc_phase",
             "alias_reserved", "tau_partial", "no_alpha_alias",
             "prep_untracked_e", "prep_non180"]


@pytest.mark.parametrize("mutate", MUTATIONS)
def test_matcher_fallthrough(mutate, caplog):
    """Off-pattern trains match in neither package; the port logs why."""
    assert jfd.match_fisp_hessian(_mutate(jepg, mutate)) is None
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        assert tfd.match_fisp_hessian(_mutate(tepg, mutate)) is None
    assert any("not a per-pulse train" in r.getMessage()
               for r in caplog.records)


PROBE_FALLTHROUGH = {
    "global_vars2": lambda e: [e.Hessian(["T1"], ["T1", ALPHAS[0]])],
    "alias_rows": lambda e: [e.Hessian([ALPHAS[1]], [ALPHAS[0]])],
    "z0_jacobian": lambda e: [e.Jacobian(["T1"], probe="Z0")],
    "no_diff": lambda e: [e.ADC],
}


@pytest.mark.parametrize("name", PROBE_FALLTHROUGH)
def test_probe_fallthrough_equals_jax(name):
    tp, jp = tfd.match_fisp_hessian(build(tepg)), jfd.match_fisp_hessian(
        build(jepg))
    probes = PROBE_FALLTHROUGH[name]
    assert tfd.match_hessian_probes(tuple(probes(tepg)), tp) is None
    assert jfd.match_hessian_probes(tuple(probes(jepg)), jp) is None


def test_global_vars2_takes_the_general_path(port_f64, caplog):
    """A Hessian whose vars2 holds a global variable falls through to the
    general path, which still answers (== JAX's general path)."""
    probes = lambda e: [e.Hessian(["T1"], ["T1", ALPHAS[0]])]  # noqa: E731
    before = tfd.DISPATCH_COUNTS.get("hessian", 0)
    with caplog.at_level(logging.INFO, logger="epgpy_torch"):
        got = tepg.simulate(build(tepg), probe=probes(tepg), max_nstate=10,
                            fisp_kernel="force")
    assert tfd.DISPATCH_COUNTS.get("hessian", 0) == before
    assert any("Hessian kernel not used" in r.getMessage()
               for r in caplog.records)
    want = jepg.simulate(build(jepg), probe=probes(jepg), max_nstate=10,
                         fisp_kernel=False)
    assert np.abs(got - np.asarray(want)).max() < 1e-10


@pytest.mark.parametrize("name", ["flagship", "5op_prep"])
def test_jax_hessian_params_through_port_runner(port_f32, name):
    seq_fn, probes = MATCH_TRAINS[name]
    jp = jfd.match_fisp_hessian(seq_fn(jepg))
    tp = from_numpy_params(jp, "cpu")
    specs = tfd.match_hessian_probes(tuple(probes(tepg)), tp)
    assert specs == jfd.match_hessian_probes(tuple(probes(jepg)), jp)
    got = tfd.run_fisp_hessian(tp, 10, *specs)
    own = tepg.simulate(seq_fn(tepg), probe=probes(tepg), max_nstate=10,
                        fisp_kernel="force", asarray=False)
    own = own if isinstance(own, tuple) else (own,)
    assert len(got) == len(own)
    for g, o in zip(got, own):
        assert torch.equal(g, o)
