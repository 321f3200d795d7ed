"""The CUDA FISP kernels (dictionary, Jacobian, per-pulse Hessian) vs
their plain twins, on the card.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from chip_smoke import (HESS_CASES, JAC_CASES, OPTION_CASES,
                        hess_block_errors, hessian_sequence, make_case,
                        make_hess_case, make_jac_case, _tensors)
from epgpy_torch import config
from epgpy_torch.models import cuda_fisp, cuda_hessian


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
