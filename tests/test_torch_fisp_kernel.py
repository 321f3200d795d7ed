"""The FISP dictionary kernel's plain twin vs the JAX Pallas kernel.

On the CPU ``fisp_dictionary_cuda`` runs its plain PyTorch twin, which is
held here against ``fisp_dictionary_pallas(interpret=True)`` over the
covering set of option cases (chip_smoke.OPTION_CASES), both in float32:
atol 1e-5, since the two sides round differently (operation order, libm)
and the difference grows with the pulse count.  In float64 the folded
twin equals the port's full-ladder model (models/mrf.py) to 1e-11, which
proves the fold.  The CUDA kernel itself is held against the twin on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import OPTION_CASES, make_case, _tensors
from epgpy_torch.models import cuda_fisp, mrf
from epgpy_tpu.models.pallas_fisp import fisp_dictionary_pallas

from torch_support import cplx, port_f32, port_f64  # noqa: F401

NATOMS, NPULSE = 200, 120     # 200 atoms: a ragged 128-atom tile in JAX


def _jax(args, kw):
    re, im = fisp_dictionary_pallas(*args, interpret=True, btile=128, **kw)
    return cplx(re, im)


@pytest.mark.parametrize("case", OPTION_CASES, ids=lambda c: c["name"])
def test_plain_twin_matches_pallas_kernel(port_f32, case):
    args, kw = make_case(case, NATOMS, NPULSE, seed=3)
    want = _jax(args, kw)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    got = cplx(*cuda_fisp.fisp_dictionary_cuda(*targs, **tkw))
    assert got.shape == want.shape == (NATOMS, NPULSE)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-5


FOLD_CASES = [c for c in OPTION_CASES
              if c["name"] in ("base", "var_te", "inv", "inv_df", "df_demod",
                               "normalize", "nstate6")]


@pytest.mark.parametrize("case", FOLD_CASES, ids=lambda c: c["name"])
def test_fold_matches_full_ladder(port_f64, case):
    """The folded half-ladder twin == the full (2N+1)-row model, f64."""
    (FA, phi, TR, TE, T1, T2, B1, df), kw = make_case(case, 16, 80, seed=4)
    re, im = mrf.fisp_mrf_dictionary(
        FA, TR, TE, T1, T2, B1, df, phi=phi, nstate=kw["nstate"],
        demodulate=kw["demodulate"], inversion=kw["inversion"],
        normalize=kw["normalize"])
    t = lambda x: None if x is None else torch.as_tensor(x)  # noqa: E731
    fre, fim = cuda_fisp.fisp_dictionary_plain(
        t(FA), t(phi), t(TR), TE if np.ndim(TE) == 0 else t(TE), t(T1),
        t(T2), t(B1), t(df), **kw)
    assert fre.dtype == torch.float64
    assert np.abs(cplx(fre, fim) - cplx(re, im)).max() < 1e-11


def test_cpu_tensors_take_the_plain_twin(port_f32):
    args, kw = make_case(OPTION_CASES[0], 40, 30)
    targs, tkw = _tensors(torch, args, kw, "cpu")
    before = cuda_fisp.LAUNCHES
    a = cuda_fisp.fisp_dictionary_cuda(*targs, **tkw)
    b = cuda_fisp.fisp_dictionary_plain(*targs, **tkw)
    assert cuda_fisp.LAUNCHES == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # (B, P) views of the (P, B) echo train
    assert a[0].shape == (40, 30) and a[0].T.is_contiguous()
    with pytest.raises(TypeError):
        cuda_fisp.fisp_dictionary_cuda(*args, **kw)     # numpy T1s
    with pytest.raises(ValueError, match="nstate"):
        cuda_fisp.fisp_dictionary_plain(*targs, **{**tkw, "nstate": 0})


def test_shared_memory_gate():
    # 6 planes x (nstate+1) rows x 32 atoms x 4 B within 227 KB per block
    assert cuda_fisp.kernel_fits(301) and not cuda_fisp.kernel_fits(302)
    assert cuda_fisp.block_size(10) == 128
    assert cuda_fisp.block_size(100) == 64
    assert cuda_fisp.block_size(301) == 32
    for n in (1, 10, 40, 150, 301):
        assert (24 * (n + 1) * cuda_fisp.block_size(n)
                <= cuda_fisp.SMEM_PER_BLOCK)
