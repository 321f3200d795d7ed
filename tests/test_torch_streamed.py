"""Streamed dictionary compression and dictionary-free serving of
epgpy_torch (``parallel/match.py``: streamed_compress_dictionary,
save_compression, load_compression) against the JAX package, and the
FISP dictionary function that feeds it (``models/mrf.fisp_mrf_dictionary``,
which takes the kernel on the card and keeps the full-ladder program on
the CPU), in float64 on the CPU.
"""

import numpy as np
import pytest
import torch

from epgpy_torch import common
from epgpy_torch.models import cuda_fisp, mrf as tmrf
from epgpy_torch.parallel import (load_compression, mrf_reconstruct,
                                  save_compression,
                                  streamed_compress_dictionary)
from epgpy_tpu.models import mrf as jmrf
from epgpy_tpu.parallel import match as jmatch, recon as jrecon

from torch_support import port_f32, port_f64  # noqa: F401

FA = 10 + 50 * np.abs(np.sin(np.arange(40) * 2 * np.pi / 100))
TR, TE = 12.0, 5.0


def _grid():
    """A (T1, T2, B1) grid of 8 x 6 x 3 = 144 atoms, T2 <= 0.8 T1."""
    g = np.stack(np.meshgrid(np.geomspace(300, 2000, 8),
                             np.geomspace(20, 200, 6),
                             np.linspace(0.8, 1.2, 3), indexing="ij"),
                 -1).reshape(-1, 3)
    g[:, 1] = np.minimum(g[:, 1], 0.8 * g[:, 0])
    return g


#: three uneven blocks of the grid
CHUNKS = np.split(np.arange(144), [37, 100])


def _blocks():
    """The blocks as host arrays, from the JAX dictionary function (both
    packages get the same numbers)."""
    g = _grid()
    out = []
    for idx in CHUNKS:
        re, im = jmrf.fisp_mrf_dictionary(FA, TR, TE, g[idx, 0], g[idx, 1],
                                          g[idx, 2], nstate=8)
        out.append((np.asarray(re), np.asarray(im)))
    return out


def _signals(blocks, rng):
    """Voxels drawn from the atoms, complex PD, light noise."""
    D = np.concatenate([re + 1j * im for re, im in blocks])
    pick = rng.integers(0, len(D), 24)
    pd = rng.uniform(0.5, 2.0, 24) * np.exp(2j * np.pi * rng.random(24))
    sig = pd[:, None] * D[pick]
    sig += 1e-4 * (rng.standard_normal(sig.shape)
                   + 1j * rng.standard_normal(sig.shape))
    return np.ascontiguousarray(sig.real), np.ascontiguousarray(sig.imag)


def test_streamed_matches_jax(port_f64):
    blocks = _blocks()
    rank = 6
    want = jmatch.streamed_compress_dictionary(lambda i: blocks[i], 3, rank)
    got = streamed_compress_dictionary(lambda i: blocks[i], 3, rank)
    assert abs(got["energy"] - want["energy"]) <= 1e-10

    def proj(c):
        B = np.asarray(c["basis_re"]) + 1j * np.asarray(c["basis_im"])
        return B @ B.conj().T

    assert np.abs(proj(got) - proj(want)).max() <= 1e-8
    assert got["cdict_re"].shape == (144, rank)
    np.testing.assert_allclose(got["norms"].numpy(),
                               np.asarray(want["norms"]), rtol=1e-12)
    # the compressed atoms' |inner products| do not depend on the basis's
    # per-vector phase
    cg = got["cdict_re"].numpy() + 1j * got["cdict_im"].numpy()
    cw = np.asarray(want["cdict_re"]) + 1j * np.asarray(want["cdict_im"])
    assert np.abs(np.abs(cg @ cg.conj().T)
                  - np.abs(cw @ cw.conj().T)).max() <= 1e-8

    grid = _grid()
    sre, sim = _signals(blocks, np.random.default_rng(4))
    rj = jrecon.mrf_reconstruct(sre, sim, None, None, grid, compression=want,
                                atom_chunk=50)
    rt = mrf_reconstruct(sre, sim, None, None, grid, compression=got,
                         atom_chunk=50)
    assert np.array_equal(rt["index"].numpy(), np.asarray(rj["index"]))
    assert np.array_equal(rt["maps"].numpy(), np.asarray(rj["maps"]))
    pd_t = rt["pd_re"].numpy() + 1j * rt["pd_im"].numpy()
    pd_j = np.asarray(rj["pd_re"]) + 1j * np.asarray(rj["pd_im"])
    assert np.abs(np.abs(pd_t) - np.abs(pd_j)).max() <= 1e-8


def test_streamed_equals_materialized_compression(port_f64):
    """The streamed Gram is the normalized full dictionary's: the same
    subspace and energy as compress_dictionary on the whole thing."""
    from epgpy_torch.parallel import compress_dictionary

    blocks = _blocks()
    D = np.concatenate([re + 1j * im for re, im in blocks])
    D = D / np.linalg.norm(D, axis=1, keepdims=True)
    full = compress_dictionary(D.real, D.imag, 5)
    got = streamed_compress_dictionary(lambda i: blocks[i], 3, 5)
    assert abs(got["energy"] - full["energy"]) <= 1e-12

    def proj(c):
        B = c["basis_re"] + 1j * c["basis_im"]
        return B @ B.conj().T

    assert np.abs(proj(got) - proj(full)).max() <= 1e-10


def test_streamed_zero_rows_stay_safe(port_f64):
    """An all-zero atom has norm 0 and compresses to zeros, not NaN."""
    blocks = _blocks()
    re, im = (x.copy() for x in blocks[1])
    re[3], im[3] = 0.0, 0.0
    blocks[1] = (re, im)
    got = streamed_compress_dictionary(lambda i: blocks[i], 3, 4)
    assert got["norms"][37 + 3].item() == 0.0
    for k in ("cdict_re", "cdict_im", "norms"):
        assert bool(torch.isfinite(got[k]).all())
    assert got["cdict_re"][37 + 3].abs().max().item() == 0.0


def test_streamed_calls_generate_twice_per_block(port_f64):
    blocks = _blocks()
    calls = []

    def generate(i):
        calls.append(i)
        return blocks[i]

    streamed_compress_dictionary(generate, 3, 4)
    assert calls == [0, 1, 2, 0, 1, 2]
    with pytest.raises(ValueError):
        streamed_compress_dictionary(generate, 0, 4)


def test_compression_round_trip(port_f64, tmp_path):
    """save_compression / load_compression: the basis comes back on the
    host, the per-atom leaves as tensors, and serving from the loaded
    artifact equals serving from the original."""
    blocks = _blocks()
    comp = streamed_compress_dictionary(lambda i: blocks[i], 3, 6)
    path = tmp_path / "comp.npz"
    save_compression(path, comp)
    back = load_compression(path)
    assert set(back) == set(comp)
    assert isinstance(back["energy"], float)
    assert back["energy"] == comp["energy"]
    for k in ("basis_re", "basis_im"):
        assert isinstance(back[k], np.ndarray)
        assert np.array_equal(back[k], comp[k])
    for k in ("cdict_re", "cdict_im", "norms"):
        assert isinstance(back[k], torch.Tensor)
        assert back[k].device.type == "cpu"
        assert torch.equal(back[k], comp[k])
    grid = _grid()
    sre, sim = _signals(blocks, np.random.default_rng(9))
    a = mrf_reconstruct(sre, sim, None, None, grid, compression=comp)
    b = mrf_reconstruct(sre, sim, None, None, grid, compression=back)
    for k in ("index", "pd_re", "pd_im", "maps"):
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("port", ["port_f32", "port_f64"])
@pytest.mark.parametrize("opts", [
    dict(), dict(nstate=0), dict(inversion=18.0, demodulate=True),
    dict(dfs=True, normalize=True)], ids=["plain", "nstate0", "ir_demod",
                                          "df_norm"])
def test_fisp_mrf_dictionary_on_cpu_is_the_full_ladder(port, opts, request):
    """On the CPU the dictionary function stays the full-ladder program,
    bit for bit, at either precision (the card's kernel route needs a CUDA
    float32 batch)."""
    request.getfixturevalue(port)
    g = _grid()[:20]
    kw = dict(opts)
    dfs = np.linspace(-0.02, 0.02, 20) if kw.pop("dfs", False) else None
    kw.setdefault("nstate", 8)
    re, im = tmrf.fisp_mrf_dictionary(FA, TR, TE, g[:, 0], g[:, 1], g[:, 2],
                                      dfs, **kw)
    t = common.to_real
    norm = kw.pop("normalize", False)
    pre, pim = cuda_fisp.fisp_full_ladder_plain(
        t(FA), t(90.0), t(TR), t(TE), t(g[:, 0]), t(g[:, 1]), t(g[:, 2]),
        None if dfs is None else t(dfs), normalize=norm, **kw)
    assert torch.equal(re, pre) and torch.equal(im, pim)


def _dense_corner():
    """The low-T1 corner of the 2^20-atom serving grid (128 x 64 x 128 on
    (T1, T2, B1), T2 clamped to 0.8 T1) at its spacing: 8 x 64 x 16 =
    8,192 atoms, where the clamp makes near-duplicate T2 neighbours."""
    g = np.stack(np.meshgrid(np.geomspace(150, 3500, 128)[:8],
                             np.geomspace(15, 400, 64),
                             np.linspace(0.75, 1.25, 128)[40:56],
                             indexing="ij"), -1).reshape(-1, 3)
    g[:, 1] = np.minimum(g[:, 1], 0.8 * g[:, 0])
    return g


def test_float32_serving_is_exact_on_a_dense_grid(port_f32):
    """Float32 dictionary-free serving on a dense grid gives the float64
    serving's maps, and the materialized dictionary's rank-32 match gives
    the same: the atoms are projected and matched in float64.  The
    control: the JAX package's float32 serving (projection and match in
    float32) misses the same floor on these voxels, so the grid is dense
    enough for float32 rounding to flip adjacent atoms."""
    grid = _dense_corner()
    rng = np.random.default_rng(42)
    P, V, floor = 500, 2048, 0.999
    fa = (10 + 50 * np.abs(np.sin(np.arange(P) * 2 * np.pi / 500))
          + rng.uniform(0, 2, P)).astype(np.float32)
    g32 = grid.astype(np.float32)
    re, im = (np.asarray(x, np.float32) for x in jmrf.fisp_mrf_dictionary(
        fa, TR, TE, g32[:, 0], g32[:, 1], g32[:, 2], nstate=10))
    chunks = np.split(np.arange(len(grid)), [2500, 5600])
    blocks = [(re[c], im[c]) for c in chunks]
    pick = rng.integers(0, len(grid), V)
    pd = rng.uniform(0.5, 2.0, V) * np.exp(2j * np.pi * rng.random(V))
    sig = (pd[:, None] * (re[pick] + 1j * im[pick])
           + 1e-4 * (rng.standard_normal((V, P))
                     + 1j * rng.standard_normal((V, P)))).astype(np.complex64)
    sre, sim = np.ascontiguousarray(sig.real), np.ascontiguousarray(sig.imag)

    comp = streamed_compress_dictionary(lambda i: blocks[i], 3, 32)
    assert comp["cdict_re"].dtype == torch.float32
    served = mrf_reconstruct(sre, sim, None, None, grid, compression=comp,
                             atom_chunk=3000)["index"].numpy()
    full = mrf_reconstruct(sre, sim, re, im, grid, rank=32,
                           atom_chunk=3000)["index"].numpy()
    t64 = [tuple(torch.as_tensor(x, dtype=torch.float64) for x in b)
           for b in blocks]
    ref = mrf_reconstruct(
        *(torch.as_tensor(x, dtype=torch.float64) for x in (sre, sim)),
        None, None, grid,
        compression=streamed_compress_dictionary(lambda i: t64[i], 3, 32),
        atom_chunk=3000)["index"].numpy()
    jcomp = jmatch.streamed_compress_dictionary(lambda i: blocks[i], 3, 32)
    jax32 = np.asarray(jrecon.mrf_reconstruct(
        sre, sim, None, None, grid, compression=jcomp,
        atom_chunk=3000)["index"])

    def agree(a, b):
        return float(np.mean(np.all(grid[a] == grid[b], axis=1)))

    assert agree(ref, pick) == 1.0
    assert agree(served, ref) >= floor
    assert agree(served, full) >= floor
    assert agree(jax32, ref) < floor
