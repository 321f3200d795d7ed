"""The CUDA FISP kernels (dictionary and Jacobian) vs their plain twins,
on the card.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from chip_smoke import (JAC_CASES, OPTION_CASES, make_case, make_jac_case,
                        _tensors)
from epgpy_torch import config
from epgpy_torch.models import cuda_fisp


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
