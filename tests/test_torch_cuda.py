"""The CUDA kernels (FISP dictionary, full ladder, Jacobian, per-pulse
Hessian; CPMG dictionary, Jacobian, per-echo design; bSSFP, DESS, ME-GRE,
composite-GRE, EPG-X GRE and composite EPG-X dictionary and Jacobian) vs
their plain twins, on the card.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -m cuda

(``-k "xgre or dess"`` selects the EPG-X GRE and DESS kernels' tests.)
"""

import pytest
import torch

from chip_smoke import (BSSFP_CASES, COMP_CASES, COMP_EDGE_ATOMS,
                        COMP_EDGE_CASES, COMP_GROUP_SETS, COMP_SHAPES,
                        DESIGN_CASES, DESIGN_SHAPES, DESS_CASES, FULL_CASES,
                        HESS_CASES, HESS_EDGE_ATOMS, HESS_EDGE_CASES,
                        HESS_SHAPES, JAC_CASES, JAC_EDGE_CASES, MEGRE_CASES,
                        MEGRE_EDGE_CASES, MSE_CASES, MSE_JAC_SHAPES,
                        MSE_RAGGED_CASES, OPTION_CASES, SEG_EDGE_SHAPE,
                        SEG_RAGGED_CASES, SEG_SHAPES,
                        _atom_tensors, _causal_max, _pair_errors,
                        comp_jac_draws, comp_jac_sequence, comp_tensors,
                        hess_block_errors, hessian_sequence, make_bssfp_case,
                        make_case, make_comp_case, make_design_case,
                        make_dess_case, make_full_case, make_hess_case,
                        make_jac_case, make_megre_case, make_mse_case,
                        megre_sequence, mse_grid, mse_sequence, _tensors,
                        XCOMP_CASES, XGRE_CASES, _x_errors, make_xcomp_case,
                        make_xcomp_jac_case, make_xgre_case,
                        make_xgre_jac_case, xcomp_tensors, xgre_tensors,
                        DESS_EDGE_CASES, DESS_EDGE_SHAPE, DESS_SHAPES,
                        XGRE_EDGE_CASES, XGRE_EDGE_SHAPE, XGRE_RAGGED_CASE,
                        XGRE_SHAPES, dess_jac_vs_twin, xgre_jac_vs_twin,
                        CPMG_EDGE_CASES, CPMG_EDGE_SHAPE, CPMG_SHAPES,
                        XCOMP_EDGE_CASES, XCOMP_EDGE_SHAPE,
                        XCOMP_RAGGED_CASE, XCOMP_SHAPES, xcomp_jac_vs_twin,
                        COMP_PRIMAL_EDGE_CASES, COMP_PRIMAL_SHAPE_NSTATES,
                        COMP_PRIMAL_TOP_N, COMP_EDGE_N, HALF_EDGE_ATOMS,
                        HALF_EDGE_CASES, HALF_EDGE_PULSES, HALF_RAGGED_CASE,
                        HALF_SHAPES, comp_vs_twin, half_vs_twin,
                        x_primal_repeat, x_primal_runs, xcomp_vs_twin,
                        xgre_vs_twin, BSSFP_EDGE_CASES, BSSFP_EDGE_SHAPE,
                        BSSFP_RAGGED_CASE, BSSFP_SHAPES, MEGRE_EDGE_ATOMS,
                        MEGRE_EDGE_PULSES, MEGRE_PRIMAL_CASES,
                        MEGRE_PRIMAL_EDGE_CASES)
from epgpy_torch import config
from epgpy_torch.models import (cuda_bssfp, cuda_composite, cuda_dess,
                                cuda_fisp, cuda_hessian, cuda_megre,
                                cuda_mse, cuda_msedesign, cuda_xcomposite,
                                cuda_xgre)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (config.precision(), config.device())
    config.set_device("cuda")
    config.set_precision("float32")
    yield
    config.set_precision(old[0])
    config.set_device(old[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", OPTION_CASES, ids=lambda c: c["name"])
def test_cuda_kernel_matches_plain_twin(card, case):
    """On the card: the CUDA kernel == its plain twin to 2e-6 (float32
    both, same operation order; FMA contraction and libm differ)."""
    targs, tkw = _tensors(torch, *make_case(case, 1000, 500), "cuda")
    before = cuda_fisp.LAUNCHES
    k = cuda_fisp.fisp_dictionary_cuda(*targs, **tkw)
    torch.cuda.synchronize()
    assert cuda_fisp.LAUNCHES == before + 1
    p = cuda_fisp.fisp_dictionary_plain(*targs, **tkw)
    assert max(float((k[i] - p[i]).abs().max()) for i in (0, 1)) < 2e-6


#: the segmented FISP dictionary kernel's edges and ragged shapes:
#: (case, atoms, pulses)
HALF_RUNS = [(c, HALF_EDGE_ATOMS, c.get("nstate", 10) + 1 + HALF_EDGE_PULSES)
             for c in HALF_EDGE_CASES] + [
    (dict(HALF_RAGGED_CASE, name=f"ragged_n{n}_{b}x{p}", nstate=n), b, p)
    for b, p in HALF_SHAPES for n in (10, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,natoms,npulse", HALF_RUNS,
                         ids=lambda v: v["name"] if isinstance(v, dict)
                         else str(v))
def test_cuda_fisp_half_segmented_edges(card, case, natoms, npulse):
    """The segmented FISP dictionary kernel at the gate's deepest ladder
    (nstate 301, with and without DW-FISP), on TR / TE runs, on both sides
    of every change of the rows per lane, and at ragged shapes (1, 33,
    4,097 atoms; 1 and 33 pulses; one and four lanes per ladder): echoes
    to 2e-6 of the twin's, one launch."""
    delta, ok = half_vs_twin(torch, case, natoms, npulse)
    assert ok and delta < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in JAC_CASES if c["name"] in (
    "base", "inv_df", "all")], ids=lambda c: c["name"])
def test_cuda_jacobian_kernel_matches_plain_twin(card, case):
    """On the card: the Jacobian kernel == its plain twin, fingerprints to
    2e-6 and tangent columns to 1e-5 of the column's largest value
    (float32 both, same operation order; FMA contraction and libm
    differ, and the tangents sum more terms)."""
    targs, tkw = _tensors(torch, *make_jac_case(case, 1000, 500), "cuda")
    before = cuda_fisp.JAC_LAUNCHES
    (kre, kim), (kdre, kdim) = cuda_fisp.fisp_jacobian_cuda(*targs, **tkw)
    torch.cuda.synchronize()
    assert cuda_fisp.JAC_LAUNCHES == before + 1
    (pre, pim), (pdre, pdim) = cuda_fisp.fisp_jacobian_plain(*targs, **tkw)
    assert max(float((kre - pre).abs().max()),
               float((kim - pim).abs().max())) < 2e-6
    for c in range(pdre.shape[-1]):
        scale = max(float(pdre[..., c].abs().max()),
                    float(pdim[..., c].abs().max()))
        err = max(float((kdre[..., c] - pdre[..., c]).abs().max()),
                  float((kdim[..., c] - pdim[..., c]).abs().max()))
        assert err < 1e-5 * scale, (c, err, scale)


def _fisp_jac_vs_twin(case, natoms, npulse):
    """fisp_jac (one launch) vs its twin: fingerprints to 2e-6, tangent
    columns to 1e-5 of the column's largest value (an all-zero column
    exactly)."""
    targs, tkw = _tensors(torch, *make_jac_case(case, natoms, npulse),
                          "cuda")
    before = cuda_fisp.JAC_LAUNCHES
    (kre, kim), (kdre, kdim) = cuda_fisp.fisp_jacobian_cuda(*targs, **tkw)
    torch.cuda.synchronize()
    assert cuda_fisp.JAC_LAUNCHES == before + 1
    (pre, pim), (pdre, pdim) = cuda_fisp.fisp_jacobian_plain(*targs, **tkw)
    assert max(float((kre - pre).abs().max()),
               float((kim - pim).abs().max())) <= 2e-6
    for c in range(pdre.shape[-1]):
        scale = max(float(pdre[..., c].abs().max()),
                    float(pdim[..., c].abs().max()))
        err = max(float((kdre[..., c] - pdre[..., c]).abs().max()),
                  float((kdim[..., c] - pdim[..., c]).abs().max()))
        assert err <= 1e-5 * scale, (c, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", JAC_EDGE_CASES, ids=lambda c: c["name"])
def test_cuda_jacobian_segmented_edges(card, case):
    """On the card, at the segmented layout's edges (the gate's nstate 74
    and 59 with the dD group, nstate 31 / 32 / 33 where the rows per lane
    change, nstate 1), over a train longer than the ladder: the Jacobian
    kernel == its twin."""
    _fisp_jac_vs_twin(case, *SEG_EDGE_SHAPE)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEG_SHAPES, ids=str)
def test_cuda_jacobian_ragged_shapes(card, shape):
    """On the card, at 1, 2, 3, 33 and 4,097 atoms and a one-pulse train:
    the Jacobian kernel == its twin (every option at once)."""
    case = next(c for c in JAC_CASES
                if c["name"] == SEG_RAGGED_CASES["fisp_jac"])
    _fisp_jac_vs_twin(case, *shape)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HESS_CASES[::5], ids=lambda c: c["name"])
def test_cuda_hessian_kernel_matches_plain_twin(card, case):
    """On the card: the per-pulse Hessian kernel == its plain twin to 1e-5
    of each output block's largest magnitude (float32 both, same operation
    order), and its pulse > echo entries are exact zeros."""
    args, kw = make_hess_case(case, 24, 150)
    targs, _ = _tensors(torch, args, {}, "cuda")
    before = cuda_hessian.HESS_LAUNCHES
    k = cuda_hessian.fisp_hessian_cuda(*targs, **kw)
    torch.cuda.synchronize()
    assert cuda_hessian.HESS_LAUNCHES == before + 1
    p = cuda_hessian.fisp_hessian_plain(*targs, **kw)
    assert max(hess_block_errors(k, p).values()) < 1e-5
    for pair in k.values():
        for t in pair:
            if t.ndim == 3:
                assert float(torch.triu(t, diagonal=1).abs().max()) == 0.0


def _hess_vs_twin(case, natoms, npulse):
    args, kw = make_hess_case(case, natoms, npulse)
    targs, _ = _tensors(torch, args, {}, "cuda")
    before = cuda_hessian.HESS_LAUNCHES
    k = cuda_hessian.fisp_hessian_cuda(*targs, **kw)
    torch.cuda.synchronize()
    assert cuda_hessian.HESS_LAUNCHES == before + 1
    p = cuda_hessian.fisp_hessian_plain(*targs, **kw)
    assert max(hess_block_errors(k, p).values()) < 1e-5
    for pair in k.values():
        for t in pair:
            assert bool(torch.isfinite(t).all())
            if t.ndim == 3:
                assert float(torch.triu(t, diagonal=1).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", HESS_EDGE_CASES, ids=lambda c: c["name"])
def test_cuda_hessian_two_pass_edges(card, case):
    """The two-pass kernel at its own edges (the gates' deepest ladders,
    rows per lane changing, nstate 1) == its twin to 1e-5 per block over a
    train longer than the ladder; pulse > echo entries exactly zero."""
    _hess_vs_twin(case, HESS_EDGE_ATOMS, max(100, case["nstate"] + 10))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HESS_SHAPES, ids=str)
@pytest.mark.parametrize("nstate", [1, 10])
def test_cuda_hessian_ragged_shapes(card, nstate, shape):
    """1, 33 and 4,097 atoms, 1, 2 and 33 pulses, at nstate 1 (5-op form
    after an inversion) and 10 (4-op)."""
    case = dict(name="ragged", nstate=nstate, te=5.0 if nstate == 1 else None,
                inversion=20.0 if nstate == 1 else None)
    _hess_vs_twin(case, *shape)


@pytest.mark.cuda
def test_cuda_hessian_through_simulate(card):
    """simulate() routes the flagship probes to the kernel; the float32
    blocks equal the float64 twin to 1e-5 per block."""
    import numpy as np

    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch

    rng = np.random.default_rng(4)
    N, B = 60, 6
    FA, TAU = rng.uniform(10, 60, N), rng.uniform(11, 16, N)
    T1, T2 = rng.uniform(400, 1600, B), rng.uniform(40, 120, B)
    seq, probes = hessian_sequence(epg, FA, TAU, T1, T2)
    before = fisp_dispatch.DISPATCH_COUNTS.get("hessian", 0)
    launches = cuda_hessian.HESS_LAUNCHES
    sig, jac, hes = epg.simulate(seq, max_nstate=10, probe=probes,
                                 asarray=False)
    assert fisp_dispatch.DISPATCH_COUNTS.get("hessian", 0) == before + 1
    assert cuda_hessian.HESS_LAUNCHES == launches + 1
    d64 = lambda x: torch.as_tensor(x, dtype=torch.float64,  # noqa: E731
                                    device="cuda")
    ref = cuda_hessian.fisp_hessian_plain(d64(FA), 90.0, d64(TAU), d64(T1),
                                          d64(T2), nstate=10)
    h = hes.permute(1, 0, 2, 3)
    got = {"sig": (sig.real.T, sig.imag.T),
           "dT1": (jac[..., 1].real.T, jac[..., 1].imag.T),
           "dT2": (jac[..., 2].real.T, jac[..., 2].imag.T)}
    for r, pre in enumerate(("d", "dT1d", "dT2d")):
        got[pre + "alpha"] = (h[:, :, r, :N].real, h[:, :, r, :N].imag)
        got[pre + "tau"] = (h[:, :, r, N:].real, h[:, :, r, N:].imag)
    assert max(hess_block_errors(got, ref).values()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", MSE_CASES, ids=lambda c: c["name"])
def test_cuda_cpmg_kernels_match_plain_twins(card, case):
    """On the card: the CPMG kernel == its twin to 2e-6; the CPMG Jacobian
    kernel's echoes to 2e-6 and tangent columns to 1e-5 of the column's
    largest value (float32 both, same operation order)."""
    args, kw = _atom_tensors(torch, *make_mse_case(case, 600), 5, "cuda")
    before = (cuda_mse.LAUNCHES, cuda_mse.JAC_LAUNCHES)
    kre, kim = cuda_mse.cpmg_dictionary_cuda(*args, **kw)
    (jre, jim), (kdre, kdim) = cuda_mse.cpmg_jacobian_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert (cuda_mse.LAUNCHES, cuda_mse.JAC_LAUNCHES) == (before[0] + 1,
                                                          before[1] + 1)
    pre, pim = cuda_mse.cpmg_dictionary_plain(*args, **kw)
    (_, _), (pdre, pdim) = cuda_mse.cpmg_jacobian_plain(*args, **kw)
    for got in ((kre, kim), (jre, jim)):
        assert max(float((got[0] - pre).abs().max()),
                   float((got[1] - pim).abs().max())) < 2e-6
    for c in range(3):
        scale = max(float(pdre[..., c].abs().max()),
                    float(pdim[..., c].abs().max()))
        err = max(float((kdre[..., c] - pdre[..., c]).abs().max()),
                  float((kdim[..., c] - pdim[..., c]).abs().max()))
        assert err < 1e-5 * scale, (c, err, scale)


def _cpmg_vs_twin(case, natoms, necho):
    args, kw = _atom_tensors(torch, *make_mse_case(case, natoms, necho), 5,
                             "cuda")
    before = cuda_mse.LAUNCHES
    kre, kim = cuda_mse.cpmg_dictionary_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_mse.LAUNCHES == before + 1
    pre, pim = cuda_mse.cpmg_dictionary_plain(*args, **kw)
    assert bool(torch.isfinite(kre).all() and torch.isfinite(kim).all())
    assert max(float((kre - pre).abs().max()),
               float((kim - pim).abs().max())) < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case", CPMG_EDGE_CASES, ids=lambda c: c["name"])
def test_cuda_cpmg_segmented_edges(card, case):
    """The segmented CPMG kernel at the gate's deepest ladders (nstate 301:
    10 rows on 31 lanes; 150 with DW-TSE: 10 rows on 16 lanes) and on
    truncated ladders (nstate 8 < 2 x 18 echoes): echoes to 2e-6, one
    launch."""
    _cpmg_vs_twin(case, CPMG_EDGE_SHAPE[0],
                  case.get("necho", CPMG_EDGE_SHAPE[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CPMG_SHAPES, ids=str)
@pytest.mark.parametrize("name", MSE_RAGGED_CASES)
def test_cuda_cpmg_ragged_shapes(card, name, shape):
    """1, 33 and 4,097 atoms and a one-echo train: the segmented CPMG
    kernel == its twin to 2e-6, one launch."""
    _cpmg_vs_twin(next(c for c in MSE_CASES if c["name"] == name), *shape)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DESIGN_CASES, ids=lambda c: c["name"])
def test_cuda_design_kernel_matches_plain_twin(card, case):
    """On the card: the per-echo design kernel == its twin to 1e-5 of
    each block's largest magnitude; variable > echo entries exact zeros."""
    args, kw = _atom_tensors(torch, *make_design_case(case, 12), 4, "cuda")
    before = cuda_msedesign.DESIGN_LAUNCHES
    k = cuda_msedesign.cpmg_design_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_msedesign.DESIGN_LAUNCHES == before + 1
    p = cuda_msedesign.cpmg_design_plain(*args, **kw)
    assert max(hess_block_errors(k, p).values()) < 1e-5
    assert _causal_max(torch, k) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MSE_JAC_SHAPES, ids=str)
@pytest.mark.parametrize("name", MSE_RAGGED_CASES)
def test_cuda_cpmg_jac_ragged_shapes(card, name, shape):
    """On the card, at ragged atom counts and a one-echo train: the
    warp-row Jacobian kernel == its twin, echoes to 2e-6 and tangent
    columns to 1e-5 of the column's largest value."""
    case = next(c for c in MSE_CASES if c["name"] == name)
    args, kw = _atom_tensors(torch, *make_mse_case(case, *shape), 5, "cuda")
    before = cuda_mse.JAC_LAUNCHES
    (kre, kim), (kdre, kdim) = cuda_mse.cpmg_jacobian_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_mse.JAC_LAUNCHES == before + 1
    (pre, pim), (pdre, pdim) = cuda_mse.cpmg_jacobian_plain(*args, **kw)
    assert max(float((kre - pre).abs().max()),
               float((kim - pim).abs().max())) < 2e-6
    for c in range(3):
        scale = max(float(pdre[..., c].abs().max()),
                    float(pdim[..., c].abs().max()))
        err = max(float((kdre[..., c] - pdre[..., c]).abs().max()),
                  float((kdim[..., c] - pdim[..., c]).abs().max()))
        assert err <= 1e-5 * scale, (c, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DESIGN_SHAPES, ids=str)
@pytest.mark.parametrize("second_order", [True, False])
def test_cuda_design_ragged_shapes(card, second_order, shape):
    """On the card, at ragged atom counts, a one-echo train and echo
    counts no multiple of the tile: the warp-row design kernel == its
    twin to 1e-5 of each block; variable > echo entries exact zeros."""
    case = dict(name="ragged", second_order=second_order)
    args, kw = _atom_tensors(torch, *make_design_case(case, *shape), 4,
                             "cuda")
    before = cuda_msedesign.DESIGN_LAUNCHES
    k = cuda_msedesign.cpmg_design_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_msedesign.DESIGN_LAUNCHES == before + 1
    p = cuda_msedesign.cpmg_design_plain(*args, **kw)
    assert max(hess_block_errors(k, p).values()) <= 1e-5
    assert _causal_max(torch, k) == 0.0


@pytest.mark.cuda
def test_cuda_cpmg_through_simulate(card):
    """simulate() routes the published CPMG train and its Jacobian probe to
    the kernels; both equal the float64 general path."""
    import numpy as np

    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch

    T2, att = mse_grid(12, 5)
    before = {k: fisp_dispatch.DISPATCH_COUNTS.get(k, 0)
              for k in ("mse", "jac:mse")}
    sig = epg.simulate(mse_sequence(epg, T2, att))
    names = ["magnitude", "T1", "T2"]
    seq = mse_sequence(epg, T2, att, tracked=True)
    jsig, jac = epg.simulate(seq, probe=[epg.ADC, epg.Jacobian(names)])
    assert fisp_dispatch.DISPATCH_COUNTS.get("mse", 0) == before["mse"] + 1
    assert fisp_dispatch.DISPATCH_COUNTS.get("jac:mse", 0) \
        == before["jac:mse"] + 1
    config.set_device("cpu")
    config.set_precision("float64")
    ref, rjac = epg.simulate(seq, probe=[epg.ADC, epg.Jacobian(names)],
                             fisp_kernel=False)
    assert np.abs(sig - ref).max() < 1e-6
    assert np.abs(jsig - ref).max() < 1e-6
    for c in range(3):
        assert np.abs(jac[..., c] - rjac[..., c]).max() \
            < 1e-4 * np.abs(rjac[..., c]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("case", BSSFP_CASES, ids=lambda c: c["name"])
def test_cuda_bssfp_kernels_match_plain_twins(card, case):
    """On the card: the bSSFP kernel == its twin to 2e-6; the bSSFP
    Jacobian kernel's echoes to 2e-6 and its (T1, T2, B1, df) columns to
    1e-5 of the column's largest value (float32 both, same operation
    order)."""
    args, kw = _tensors(torch, *make_bssfp_case(case, 1000, 300), "cuda")
    jkw = dict(demodulate=kw["demodulate"], inversion=kw["inversion"],
               track_df=True)
    before = (cuda_bssfp.LAUNCHES, cuda_bssfp.JAC_LAUNCHES)
    k = cuda_bssfp.bssfp_dictionary_cuda(*args, **kw)
    kj = cuda_bssfp.bssfp_jacobian_echoes(*args, **jkw)
    torch.cuda.synchronize()
    assert (cuda_bssfp.LAUNCHES, cuda_bssfp.JAC_LAUNCHES) == (before[0] + 1,
                                                              before[1] + 1)
    sig, _ = _pair_errors(torch, k,
                          cuda_bssfp.bssfp_dictionary_plain(*args, **kw),
                          False)
    jsig, cols = _pair_errors(
        torch, kj, cuda_bssfp.bssfp_jacobian_echoes_plain(*args, **jkw), True)
    assert max(sig, jsig) < 2e-6 and max(cols) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", DESS_CASES, ids=lambda c: c["name"])
def test_cuda_dess_kernels_match_plain_twins(card, case):
    """On the card: the DESS kernel's two echo trains == its twin's to
    2e-6; the DESS Jacobian kernel's echoes to 2e-6 and both echoes'
    (T1, T2, B1) columns to 1e-5 of the column's largest value."""
    args, kw = _tensors(torch, *make_dess_case(case, 1000, 120), "cuda")
    before = (cuda_dess.LAUNCHES, cuda_dess.JAC_LAUNCHES)
    k = cuda_dess.dess_echoes(*args, **kw)
    kj = cuda_dess.dess_jacobian_echoes(*args, **kw)
    torch.cuda.synchronize()
    assert (cuda_dess.LAUNCHES, cuda_dess.JAC_LAUNCHES) == (before[0] + 1,
                                                            before[1] + 1)
    sig, _ = _pair_errors(torch, k, cuda_dess.dess_echoes_plain(*args, **kw),
                          False)
    jsig, cols = _pair_errors(
        torch, kj, cuda_dess.dess_jacobian_echoes_plain(*args, **kw), True)
    assert max(sig, jsig) < 2e-6 and max(cols) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", DESS_EDGE_CASES, ids=lambda c: c["name"])
def test_cuda_dess_jacobian_segmented_edges(card, case):
    """The segmented DESS Jacobian kernel at nstate 1, 2, 64, 65 and 74 (1,
    2 and 3 rows per lane, the gate's deepest ladder) with every option:
    signals to 2e-6, columns to 1e-5, one launch."""
    dess_jac_vs_twin(torch, case, *DESS_EDGE_SHAPE)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DESS_SHAPES, ids=str)
def test_cuda_dess_jacobian_ragged_shapes(card, shape):
    """1, 33 and 4,097 atoms, 1 and 2 pulses, every option at nstate 8."""
    dess_jac_vs_twin(torch, DESS_CASES[-1], *shape)


@pytest.mark.cuda
def test_cuda_bssfp_and_dess_through_simulate(card):
    """simulate() routes a bSSFP and a DESS train and their Jacobian probes
    to the kernels; each equals the float64 general path."""
    import numpy as np

    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch

    T1, T2 = np.array([500.0, 900.0, 1400.0]), np.array([40.0, 70.0, 110.0])
    FA = 10 + 40 * np.abs(np.sin(np.arange(60) / 7.0))
    trains = {
        "bssfp": lambda o1: epg.bssfp_sequence(
            FA, 12.0, T1=T1, T2=T2, df=np.array([0.01, -0.02, 0.03]),
            inversion=18.0, order1=o1 or None),
        "dess": lambda o1: sum((
            [epg.T(float(fa), 0.0), epg.E(5.0, T1, T2, order1=o1), epg.ADC,
             epg.E(8.0, T1, T2, order1=o1), epg.S(1),
             epg.E(5.0, T1, T2, order1=o1), epg.ADC] for fa in FA), []),
    }
    names = ["magnitude", "T1", "T2"]
    got = {}
    before = dict(fisp_dispatch.DISPATCH_COUNTS)
    for fam, train in trains.items():
        got[fam] = (epg.simulate(train(False), max_nstate=8),
                    *epg.simulate(train(["T1", "T2"]), max_nstate=8,
                                  probe=[epg.ADC, epg.Jacobian(names)]))
    for tag in ("bssfp", "jac:bssfp", "dess", "jac:dess"):
        assert fisp_dispatch.DISPATCH_COUNTS.get(tag, 0) \
            == before.get(tag, 0) + 1, tag
    config.set_device("cpu")
    config.set_precision("float64")
    for fam, train in trains.items():
        ref = epg.simulate(train(["T1", "T2"]), max_nstate=8,
                           probe=[epg.ADC, epg.Jacobian(names)],
                           fisp_kernel=False)
        sig, jsig, jac = got[fam]
        assert np.abs(sig - ref[0]).max() < 1e-6
        assert np.abs(jsig - ref[0]).max() < 1e-6
        for c in range(3):
            assert np.abs(jac[..., c] - ref[1][..., c]).max() \
                < 1e-4 * np.abs(ref[1][..., c]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("case", MEGRE_CASES, ids=lambda c: c["name"])
def test_cuda_megre_kernels_match_plain_twins(card, case):
    """On the card: the ME-GRE kernel's echoes == its twin's to 2e-6; the
    ME-GRE Jacobian kernel's echoes to 2e-6 and its (T1, T2, B1, df)
    columns to 1e-5 of the column's largest value (the df column at
    dfs=None included)."""
    args, kw = _tensors(torch, *make_megre_case(case, 1000, 120), "cuda")
    before = (cuda_megre.LAUNCHES, cuda_megre.JAC_LAUNCHES)
    k = cuda_megre.megre_echoes(*args, **kw)
    kj = cuda_megre.megre_jacobian_echoes(*args, **kw)
    torch.cuda.synchronize()
    assert (cuda_megre.LAUNCHES, cuda_megre.JAC_LAUNCHES) == (before[0] + 1,
                                                              before[1] + 1)
    sig, _ = _pair_errors(torch, k,
                          cuda_megre.megre_echoes_plain(*args, **kw), False)
    jsig, cols = _pair_errors(
        torch, kj, cuda_megre.megre_jacobian_echoes_plain(*args, **kw), True)
    assert max(sig, jsig) < 2e-6 and max(cols) < 1e-5


def _primal_twice(fn, twin, args, kw, counter):
    """The primal kernel launched twice (both through the kernel, the same
    bits) against its twin: max |delta|."""
    before = counter()
    k, again = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    assert counter() == before + 2
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    assert all(bool(torch.isfinite(x).all()) for x in k)
    return _pair_errors(torch, k, twin(*args, **kw), False)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case,natoms,npulse", [
    (c, MEGRE_EDGE_ATOMS, c["nstate"] + 1 + MEGRE_EDGE_PULSES)
    for c in MEGRE_PRIMAL_EDGE_CASES] + MEGRE_PRIMAL_CASES,
    ids=lambda c: c["name"] if isinstance(c, dict) else str(c))
def test_cuda_megre_primal_segmented_edges(card, case, natoms, npulse):
    """On the card: the segmented ME-GRE primal kernel == its twin to 2e-6
    on both sides of every change of its instance or rows per lane, at
    1-1,000 echoes, over TR and echo-time runs, ragged shapes and chunk
    edges; a second launch gives the same bits."""
    args, kw = _tensors(torch, *make_megre_case(case, natoms, npulse),
                        "cuda")
    assert _primal_twice(cuda_megre.megre_echoes,
                         cuda_megre.megre_echoes_plain, args, kw,
                         lambda: cuda_megre.LAUNCHES) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case,natoms,npulse", [
    (c, *BSSFP_EDGE_SHAPE) for c in BSSFP_EDGE_CASES] + [
    (BSSFP_RAGGED_CASE, n, p) for n, p in BSSFP_SHAPES],
    ids=lambda c: c["name"] if isinstance(c, dict) else str(c))
def test_cuda_bssfp_primal_edges(card, case, natoms, npulse):
    """On the card: the bSSFP primal kernel == its twin to 2e-6 over TR
    and TE runs across its 32-pulse chunks, inversion with and without
    df, a large df t and ragged shapes; a second launch gives the same
    bits."""
    args, kw = _tensors(torch, *make_bssfp_case(case, natoms, npulse),
                        "cuda")
    kw.pop("normalize")
    assert _primal_twice(cuda_bssfp.bssfp_echoes,
                         cuda_bssfp.bssfp_echoes_plain, args, kw,
                         lambda: cuda_bssfp.LAUNCHES) <= 2e-6


def _megre_jac_vs_twin(case, natoms, npulse):
    """megre_jac (one launch) vs its twin: echoes to 2e-6, the (T1, T2,
    B1, df) columns to 1e-5 of the column's largest value."""
    args, kw = _tensors(torch, *make_megre_case(case, natoms, npulse),
                        "cuda")
    before = cuda_megre.JAC_LAUNCHES
    kj = cuda_megre.megre_jacobian_echoes(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_megre.JAC_LAUNCHES == before + 1
    sig, cols = _pair_errors(
        torch, kj, cuda_megre.megre_jacobian_echoes_plain(*args, **kw), True)
    assert sig <= 2e-6 and max(cols) <= 1e-5, (sig, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MEGRE_EDGE_CASES, ids=lambda c: c["name"])
def test_cuda_megre_jacobian_segmented_edges(card, case):
    """On the card, at the segmented layout's edges (the gate's nstate 59,
    nstate 31 / 32 / 33, nstate 1 with more echoes than lanes per
    segment), over a train longer than the ladder: the ME-GRE Jacobian
    kernel == its twin."""
    _megre_jac_vs_twin(case, *SEG_EDGE_SHAPE)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEG_SHAPES, ids=str)
def test_cuda_megre_jacobian_ragged_shapes(card, shape):
    """On the card, at 1, 2, 3, 33 and 4,097 atoms and a one-pulse train:
    the ME-GRE Jacobian kernel == its twin (every option at once)."""
    case = next(c for c in MEGRE_CASES
                if c["name"] == SEG_RAGGED_CASES["megre_jac"])
    _megre_jac_vs_twin(case, *shape)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FULL_CASES, ids=lambda c: c["name"])
def test_cuda_full_ladder_kernel_matches_plain_twin(card, case):
    """On the card: the full-ladder FISP kernel == its twin to 2e-6, and ==
    the folded kernel at nstate >= 1; fisp_dictionary_cuda at nstate 0
    launches it."""
    args, kw = _tensors(torch, *make_full_case(case, 1000, 300), "cuda")
    before = cuda_fisp.FULL_LAUNCHES
    k = cuda_fisp.fisp_dictionary_cuda(*args, **kw)
    torch.cuda.synchronize()
    if kw["nstate"] == 0:
        assert cuda_fisp.FULL_LAUNCHES == before + 1
        k = (k[0].T, k[1].T)
    else:
        f = cuda_fisp.fisp_full_echoes(*args, **kw)
        assert cuda_fisp.FULL_LAUNCHES == before + 1
        fold, _ = _pair_errors(torch, f, (k[0].T, k[1].T), False)
        assert fold < 2e-6
        k = f
    sig, _ = _pair_errors(torch, k,
                          cuda_fisp.fisp_full_echoes_plain(*args, **kw),
                          False)
    assert sig < 2e-6


@pytest.mark.cuda
def test_cuda_megre_and_dwfisp_through_simulate(card):
    """simulate() routes an ME-GRE and a DW-FISP train and their Jacobian
    probes to the kernels (dispatch counts megre, jac:megre, dw, jac:dw);
    each equals the float64 general path."""
    import numpy as np

    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch

    T1, T2 = np.array([500.0, 900.0, 1400.0]), np.array([40.0, 70.0, 110.0])
    df = np.array([0.01, -0.02, 0.03])
    FA = 10 + 40 * np.abs(np.sin(np.arange(40) / 7.0))
    kv = 2 * np.pi / 1e-3

    def dw(o1):
        d = epg.D(7.0, 1.1e-3, k=1, order1=["Dcoef"] if o1 else False)
        return sum(([epg.T(float(fa), 90.0), epg.E(5.0, T1, T2, order1=o1),
                     epg.ADC, epg.E(7.0, T1, T2, order1=o1), epg.S(1), d]
                    for fa in FA), [])

    trains = {
        "megre": (lambda o1: megre_sequence(epg, FA, T1, T2, df,
                                            order1=o1),
                  ["magnitude", "T2", "g"], ["T2", "g"]),
        "dw": (dw, ["magnitude", "T1", "Dcoef"], ["T1", "T2"]),
    }
    got = {}
    before = dict(fisp_dispatch.DISPATCH_COUNTS)
    for fam, (train, names, o1) in trains.items():
        got[fam] = (epg.simulate(train(False), max_nstate=8, kvalue=kv),
                    *epg.simulate(train(o1), max_nstate=8, kvalue=kv,
                                  probe=[epg.ADC, epg.Jacobian(names)]))
    for tag in ("megre", "jac:megre", "dw", "jac:dw"):
        assert fisp_dispatch.DISPATCH_COUNTS.get(tag, 0) \
            == before.get(tag, 0) + 1, tag
    config.set_device("cpu")
    config.set_precision("float64")
    for fam, (train, names, o1) in trains.items():
        ref = epg.simulate(train(o1), max_nstate=8, kvalue=kv,
                           probe=[epg.ADC, epg.Jacobian(names)],
                           fisp_kernel=False)
        sig, jsig, jac = got[fam]
        assert np.abs(sig - ref[0]).max() < 1e-6
        assert np.abs(jsig - ref[0]).max() < 1e-6
        for c in range(len(names)):
            assert np.abs(jac[..., c] - ref[1][..., c]).max() \
                < 1e-4 * np.abs(ref[1][..., c]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("case", COMP_CASES, ids=lambda c: c["name"])
def test_cuda_composite_kernels_match_plain_twins(card, case):
    """On the card: the composite kernel's echoes == its twin's to 2e-6; the
    composite Jacobian kernel's echoes to 2e-6 and its (T1, T2, B1, df)
    columns to 1e-5 of the column's largest value, over every group set
    on the case with every option."""
    args, kw = comp_tensors(torch, *make_comp_case(case, 1000, 200), "cuda")
    sets = COMP_GROUP_SETS if case["name"] == "all" else COMP_GROUP_SETS[-1:]
    before = (cuda_composite.LAUNCHES, cuda_composite.JAC_LAUNCHES)
    k = cuda_composite.composite_echoes(*args, **kw)
    kj = [cuda_composite.composite_jacobian_echoes(*args, groups=g, **kw)
          for g in sets]
    torch.cuda.synchronize()
    assert (cuda_composite.LAUNCHES, cuda_composite.JAC_LAUNCHES) == (
        before[0] + 1, before[1] + len(sets))
    sig, _ = _pair_errors(torch, k, cuda_composite.composite_plain(*args,
                                                                  **kw), False)
    assert sig < 2e-6
    for g, got in zip(sets, kj):
        jsig, cols = _pair_errors(torch, got, cuda_composite.
                                  composite_jacobian_plain(*args, groups=g,
                                                           **kw), True)
        assert jsig < 2e-6 and len(cols) == len(g)
        assert max(cols, default=0.0) < 1e-5


def _comp_jac_vs_twin(case, groups, natoms, nstage):
    args, kw = comp_tensors(torch, *make_comp_case(case, natoms, nstage),
                            "cuda")
    before = cuda_composite.JAC_LAUNCHES
    got = cuda_composite.composite_jacobian_echoes(*args, groups=groups, **kw)
    torch.cuda.synchronize()
    assert cuda_composite.JAC_LAUNCHES == before + 1
    sig, cols = _pair_errors(torch, got, cuda_composite.
                             composite_jacobian_plain(*args, groups=groups,
                                                      **kw), True)
    assert sig < 2e-6 and len(cols) == len(groups)
    assert max(cols, default=0.0) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case,groups", COMP_EDGE_CASES,
                         ids=lambda c: c["name"] if isinstance(c, dict)
                         else ",".join(c))
def test_cuda_composite_jacobian_segmented_edges(card, case, groups):
    """The segmented Jacobian kernel at the gate's deepest ladder for each
    group count (2 to 5 rows per lane), rows per lane changing and nstate
    1, with every option: signals to 2e-6, columns to 1e-5."""
    _comp_jac_vs_twin(case, groups, COMP_EDGE_ATOMS, COMP_EDGE_N)


@pytest.mark.cuda
def test_cuda_primal_kernels_repeat_exactly(card):
    """The FISP dictionary and composite primal kernels give bitwise the
    same echoes on a second launch over the same inputs (4,097 atoms, 300
    pulses or stages: ten chunks, so that a chunk's table, staged echoes
    and flush follow each other in every block), one launch each."""
    targs, tkw = _tensors(torch, *make_case(dict(name="repeat", df=True),
                                            4097, 300), "cuda")
    first = cuda_fisp.fisp_dictionary_cuda(*targs, **tkw)
    again = cuda_fisp.fisp_dictionary_cuda(*targs, **tkw)
    args, kw = comp_tensors(torch, *make_comp_case(COMP_CASES[-1], 4097,
                                                   300), "cuda")
    c1 = cuda_composite.composite_echoes(*args, **kw)
    c2 = cuda_composite.composite_echoes(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first + c1, again + c2):
        assert torch.equal(a, b)


#: the segmented composite primal kernel's edges and ragged shapes:
#: (case, atoms, stages)
COMP_PRIMAL_RUNS = [(c, COMP_EDGE_ATOMS, COMP_PRIMAL_TOP_N if c["shift"] ==
                     "up" else COMP_EDGE_N) for c in COMP_PRIMAL_EDGE_CASES] \
    + [(dict(COMP_CASES[-1], name=f"ragged_n{n}_{b}x{ns}", nstate=n), b, ns)
       for b, ns in COMP_SHAPES for n in COMP_PRIMAL_SHAPE_NSTATES]


@pytest.mark.cuda
@pytest.mark.parametrize("case,natoms,nstage", COMP_PRIMAL_RUNS,
                         ids=lambda v: v["name"] if isinstance(v, dict)
                         else str(v))
def test_cuda_composite_segmented_edges(card, case, natoms, nstage):
    """The segmented composite primal kernel at the gate's deepest ladder
    (nstate 301, mixed shifts and every stage shifting up), on both sides
    of every change of the rows per lane, and at ragged shapes (1, 33,
    4,097 atoms; 1, 2 and 33 stages; nstate 1, 8 and 40), every option:
    echoes to 2e-6 of the twin's, one launch."""
    sig, ok = comp_vs_twin(torch, case, natoms, nstage)
    assert ok and sig < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COMP_SHAPES, ids=str)
@pytest.mark.parametrize("nstate", [1, 8])
def test_cuda_composite_jacobian_ragged_shapes(card, nstate, shape):
    """1, 33 and 4,097 atoms, 1, 2 and 33 stages, every group and option."""
    case = dict(COMP_CASES[-1], nstate=nstate)
    _comp_jac_vs_twin(case, COMP_GROUP_SETS[-1], *shape)


@pytest.mark.cuda
def test_cuda_megre_jacobian_echo_count_edge(card):
    """The ME-GRE Jacobian kernel takes 360 echoes per TR at nstate 1 (==
    its twin) and its guard refuses 361; simulate() sends a 361-echo train
    to the general diff path, whose answer it returns."""
    import numpy as np

    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch

    for m, fits in ((360, True), (361, False)):
        case = dict(name=f"m{m}", m=m, nstate=1, df=True, var_te=True)
        args, kw = _tensors(torch, *make_megre_case(case, 33, 2), "cuda")
        assert cuda_megre.megre_jac_kernel_fits(1, m) == fits
        if not fits:
            with pytest.raises(ValueError):
                cuda_megre.megre_jacobian_echoes(*args, **kw)
            continue
        got = cuda_megre.megre_jacobian_echoes(*args, **kw)
        sig, cols = _pair_errors(torch, got, cuda_megre.
                                 megre_jacobian_echoes_plain(*args, **kw),
                                 True)
        assert sig < 2e-6 and max(cols) < 1e-5
    T1, T2 = np.array([800.0, 1300.0]), np.array([40.0, 90.0])
    seq = []
    for i in range(2):
        seq.append(epg.T(15.0 + i, 0.0))
        for j in range(361):
            seq += [epg.E(3.0, T1, T2, 0.01, order1=["T2", "g"]), epg.ADC]
        seq += [epg.E(4.0, T1, T2, 0.01, order1=["T2", "g"]), epg.S(1)]
    probes = [epg.ADC, epg.Jacobian(["T2", "g"])]
    before = dict(fisp_dispatch.DISPATCH_COUNTS)
    sig, jac = epg.simulate(seq, max_nstate=1, probe=probes)
    assert fisp_dispatch.DISPATCH_COUNTS.get("jac:megre", 0) == before.get(
        "jac:megre", 0)
    want_sig, want_jac = epg.simulate(seq, max_nstate=1, probe=probes,
                                      fisp_kernel=False)
    assert np.array_equal(sig, want_sig) and np.array_equal(jac, want_jac)


@pytest.mark.cuda
def test_cuda_composite_through_simulate(card):
    """simulate() routes an MPRAGE train and its (T1, T2, B1, g) Jacobian
    probe to the composite kernels (dispatch counts comp, jac:comp); each
    equals the float64 general path."""
    import numpy as np

    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch

    FA, T1, T2, B1, df = comp_jac_draws()
    n = 6
    names = ["magnitude", "T1", "T2", "B1", "g"]

    def train():
        return comp_jac_sequence(epg, FA[:2, :8], T1[:n], T2[:n], B1[:n],
                                 df[:n])

    before = dict(fisp_dispatch.DISPATCH_COUNTS)
    probes = [epg.ADC, epg.Jacobian(names)]
    sig = epg.simulate(train(), max_nstate=8)
    jsig, jac = epg.simulate(train(), max_nstate=8, probe=probes)
    for tag in ("comp", "jac:comp"):
        assert fisp_dispatch.DISPATCH_COUNTS.get(tag, 0) \
            == before.get(tag, 0) + 1, tag
    config.set_device("cpu")
    config.set_precision("float64")
    ref = epg.simulate(train(), max_nstate=8, probe=probes, fisp_kernel=False)
    assert np.abs(sig - ref[0]).max() < 1e-6
    assert np.abs(jsig - ref[0]).max() < 1e-6
    for c in range(len(names)):
        assert np.abs(jac[..., c] - ref[1][..., c]).max() \
            < 1e-4 * np.abs(ref[1][..., c]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("family,case", [("xgre", c) for c in XGRE_CASES]
                         + [("xcomp", c) for c in XCOMP_CASES],
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_cuda_exchange_kernels_match_plain_twins(card, family, case):
    """On the card: the EPG-X GRE and composite EPG-X kernels' echoes ==
    their twins' to 2e-6; their Jacobian kernels' echoes to 2e-6 and each
    variable's column to 1e-5 of its largest value; one launch each."""
    if family == "xgre":
        mod, mk, mkj, tens = cuda_xgre, make_xgre_case, make_xgre_jac_case, \
            xgre_tensors
        fns = (mod.xgre_dictionary_echoes, mod.xgre_dictionary_plain,
               mod.xgre_jacobian_echoes, mod.xgre_jacobian_plain)
    else:
        mod, mk, mkj, tens = cuda_xcomposite, make_xcomp_case, \
            make_xcomp_jac_case, xcomp_tensors
        fns = (mod.xcomposite_echoes, mod.xcomposite_plain,
               mod.xcomposite_jacobian_echoes, mod.xcomposite_jacobian_plain)
    args, kw = mk(case, 1000, 60)
    targs = tens(torch, args, "cuda")
    jargs, jkw = mkj(torch, case, 1000, 60)
    tj = tens(torch, jargs, "cuda", jac=True)
    before = (mod.LAUNCHES, mod.JAC_LAUNCHES)
    k, kj = fns[0](*targs, **kw), fns[2](*tj, **jkw)
    torch.cuda.synchronize()
    assert (mod.LAUNCHES, mod.JAC_LAUNCHES) == (before[0] + 1,
                                                 before[1] + 1)
    sig, _ = _x_errors(torch, k, fns[1](*targs, **kw), False)
    jsig, cols = _x_errors(torch, kj, fns[3](*tj, **jkw), True)
    assert sig < 2e-6 and jsig < 2e-6
    assert len(cols) == 2 and max(cols) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", XGRE_EDGE_CASES, ids=lambda c: c["name"])
def test_cuda_xgre_jacobian_segmented_edges(card, case):
    """The segmented xgre Jacobian kernel at the gate's deepest ladders
    ((C, G) = (1, 2) at nstate 150, (2, 3) at 49, (4, 3) at 24, (2, 5) at
    29), the balanced family at four pools, and a batch mixing identity
    and non-identity stage-A atoms inside warps: signals to 2e-6, columns
    to 1e-5, one launch."""
    xgre_jac_vs_twin(torch, case, *XGRE_EDGE_SHAPE)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", XGRE_SHAPES, ids=str)
def test_cuda_xgre_jacobian_ragged_shapes(card, shape):
    """1, 33 and 4,097 atoms, 1 and 2 TRs, two stages with df, a B1 batch
    and complex saturation."""
    xgre_jac_vs_twin(torch, XGRE_RAGGED_CASE, *shape)


@pytest.mark.cuda
@pytest.mark.parametrize("case", XCOMP_EDGE_CASES, ids=lambda c: c["name"])
def test_cuda_xcomposite_jacobian_segmented_edges(card, case):
    """The segmented composite EPG-X Jacobian kernel at the gate's deepest
    ladders ((C, G) = (1, 2) at nstate 150, (2, 3) at 49, (4, 3) at 24,
    (2, 5) at 29, (3, 4) at 24) with shifts up, down and none, and with
    26 table entries (the global-read mode): signals to 2e-6, columns to
    1e-5, one launch."""
    xcomp_jac_vs_twin(torch, case, *XCOMP_EDGE_SHAPE)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", XCOMP_SHAPES, ids=str)
def test_cuda_xcomposite_jacobian_ragged_shapes(card, shape):
    """1, 33 and 4,097 atoms, 1 and 2 stages, every option of the
    composite EPG-X train."""
    xcomp_jac_vs_twin(torch, XCOMP_RAGGED_CASE, *shape)


def _x_run_id(v):
    return v["name"] if isinstance(v, dict) else str(v)


@pytest.mark.cuda
@pytest.mark.parametrize("case,natoms,ntr", x_primal_runs("xgre"),
                         ids=_x_run_id)
def test_cuda_xgre_segmented_edges(card, case, natoms, ntr):
    """The segmented xgre primal kernel on both sides of every change of
    its rows per lane at one to four pools up to the gate's deepest
    ladders (and those shifted to their top rows), the balanced train at
    nstate 0, chunk edges at 31, 32 and 33 TRs, identity stages (every
    mix skipped) and none, the unflipped bound pool, and the ragged shapes
    (1, 33, 4,097 atoms; 1, 2, 33 TRs): echoes to 2e-6 of the twin's, one
    launch."""
    xgre_vs_twin(torch, case, natoms, ntr)


@pytest.mark.cuda
@pytest.mark.parametrize("case,natoms,nstage", x_primal_runs("xcomp"),
                         ids=_x_run_id)
def test_cuda_xcomposite_segmented_edges(card, case, natoms, nstage):
    """The segmented composite EPG-X primal kernel over the same row edges
    with up, down and no shifts (none at nstate 0), chunk edges at 31, 32
    and 33 stages, every mix with the identity entry and none, the
    unflipped bound pool, the options off, both table modes and the ragged
    shapes: echoes to 2e-6 of the twin's, one launch."""
    xcomp_vs_twin(torch, case, natoms, nstage)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["xgre", "xcomp"])
def test_cuda_x_primal_kernels_repeat_exactly(card, family):
    """Both primal EPG-X kernels give bitwise the same echoes on a second
    launch over the same inputs (4,097 atoms, 100 TRs or stages: four
    chunks, so that a chunk's table, staged echoes and flush follow each
    other in every block)."""
    assert x_primal_repeat(torch, family)


@pytest.mark.cuda
def test_cuda_exchange_through_simulate(card):
    """simulate(density=...) routes a spoiled and a balanced MT-GRE train to
    the xgre kernel and a segmented MT-prepared train to the composite
    EPG-X kernel (dispatch counts xgre, xcomp); each equals the float64
    general path."""
    import numpy as np

    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch

    dens = [0.85, 0.15]
    khi = epg.exchange_matrix(0.005, densities=dens)
    T2 = np.stack([np.linspace(40.0, 120.0, 6), np.full(6, 0.012)])
    T1 = np.array([1000.0, 1100.0])
    sat = epg.R(0, rL=np.asarray([0.0, 0.3]))

    def trains():
        Xa, Xb = epg.X(3.0, khi, axis=0, T1=T1, T2=T2), \
            epg.X(7.0, khi, axis=0, T1=T1, T2=T2)
        Xr = epg.X(150.0, khi, axis=0, T1=T1, T2=T2)
        spoiled, balanced, prep = [], [], []
        for i in range(20):
            spoiled += [sat, epg.T(np.asarray([10.0 + i, 0.0]), 0), Xa,
                        epg.ADC, Xb, epg.S(1)]
            balanced += [epg.T(np.asarray([20.0, 0.0]), 180.0 * (i % 2)),
                         Xa, epg.ADC, Xb]
        for seg in range(3):
            prep += [sat, Xr] + [op for i in range(6) for op in (
                epg.T(np.asarray([8.0 + i, 0.0]), 0.0), Xa, epg.ADC, Xb,
                epg.S(1))] + [Xr]
        return spoiled, balanced, prep

    before = dict(fisp_dispatch.DISPATCH_COUNTS)
    got = [epg.simulate(s, max_nstate=8, density=dens) for s in trains()]
    counts = fisp_dispatch.DISPATCH_COUNTS
    assert counts.get("xgre", 0) == before.get("xgre", 0) + 2
    assert counts.get("xcomp", 0) == before.get("xcomp", 0) + 1
    config.set_device("cpu")
    config.set_precision("float64")
    for g, s in zip(got, trains()):
        ref = epg.simulate(s, max_nstate=8, density=dens, fisp_kernel=False)
        assert np.abs(g - ref).max() < 1e-6
