"""MRF dictionary matching.

Counterpart of ``epgpy_tpu/parallel/match.py``.  Given
a dictionary (atoms x pulses fingerprints) and measured signals (voxels x
pulses), find for each voxel the atom with the highest |inner product|:
the MRF reconstruction step.  The correlations are real matrix products
(``torch.matmul``) in true float32 or float64: close dictionary atoms are
separated by 1e-4 to 1e-3 in correlation, and a reduced-precision product
(TF32 on a CUDA card) flips those matches, so every product here runs
with TF32 switched off (``config.full_precision``).  A dictionary too
large to hold is compressed block by block
(:func:`streamed_compress_dictionary`), and the compressed artifact is
saved and served without it.  With a mesh (``mesh=``) the dictionary's
atoms split over a mesh axis: each shard is matched on its entry and the
best over the shards is taken on the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..config import full_precision

__all__ = ["dictionary_match", "compress_dictionary", "project_signals",
           "streamed_compress_dictionary", "save_compression",
           "load_compression", "full_precision"]


def _tensor(x, dtype=None):
    """A tensor as it is; a host array on the working device, in `dtype`
    (default: the working precision's)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=dtype or config.real_dtype(),
                           device=config.device())


def dictionary_match(dict_re, dict_im, sig_re, sig_im, mesh=None, *,
                     axis: str = "atoms", atom_chunk: int = None):
    """Best-matching atom index + correlation per voxel.

    Args:
        dict_re/dict_im: (B, P) dictionary fingerprints (split complex).
        sig_re/sig_im: (V, P) measured signals.
        mesh: optional ``parallel.make_mesh`` mesh; the dictionary's
            atoms split over its `axis` (the axis size must divide them),
            the signals are replicated.  Each shard's best atom is found
            on its entry, offset by the shard's first atom, and the best
            over the shards taken, ties going to the lowest atom.
        atom_chunk: optional atom-axis chunk size: the (V, B) correlation
            plane is the match's memory footprint (8192 voxels x 102,400
            atoms = 3.4 GB per float32 plane), so the match can run over
            atom chunks with a running (max, argmax), materializing only
            (V, atom_chunk) at a time.  Exact: ties resolve to the lowest
            atom index either way.  Applies per shard under a mesh.

    Returns (indices (V,), correlations (V,)) as tensors, on the mesh's
    first device under a mesh.
    """
    dre, dim, sre, sim = (_tensor(x) for x in (dict_re, dict_im, sig_re,
                                               sig_im))
    if mesh is None:
        return _local_match(dre, dim, sre, sim, atom_chunk)
    from .mesh import shard_map

    found = shard_map(_local_match, mesh, [(dre, 0), (dim, 0)], axis=axis,
                      replicated=(sre, sim, atom_chunk), out_dim=None)
    nloc = dre.shape[0] // len(found)
    first = mesh.devices.flat[0]
    best = torch.stack([b.to(first) + i * nloc
                        for i, (b, _) in enumerate(found)])      # (n, V)
    vals = torch.stack([v.to(first) for _, v in found])
    # argmax returns the first maximum: the lowest shard, whose index is
    # its lowest matching atom
    w = torch.argmax(vals, dim=0, keepdim=True)
    return (torch.take_along_dim(best, w, dim=0)[0],
            torch.take_along_dim(vals, w, dim=0)[0])


def _local_match(dre, dim, sre, sim, atom_chunk):
    """The best atom of (dre, dim) for each signal, and its correlation."""
    if atom_chunk and dre.shape[0] > atom_chunk:
        return _chunked_match(dre, dim, sre, sim, int(atom_chunk))
    with full_precision():
        # re/im stacked on the contraction axis: two (V, 2P) x (2P, B)
        # products instead of four (V, P) x (P, B)
        s_cat = torch.cat([sre, sim], dim=1)                  # (V, 2P)
        x = s_cat @ torch.cat([dre, dim], dim=1).T            # Re<d, s>
        y = s_cat @ torch.cat([-dim, dre], dim=1).T           # Im<d, s>
    corr2 = x * x + y * y                                     # (V, B)
    val, best = torch.max(corr2, dim=-1)
    return best, torch.sqrt(val)


def _chunked_match(dre, dim, sre, sim, C):
    """Atom-chunked |corr|^2 argmax with a running (val, index) carry;
    only a (V, C) plane and one (C, 2P) block are live at a time.  The
    last window's offset clamps to B - C, so it overlaps the previous
    one: re-evaluated atoms give identical correlations and the strict >
    merge keeps the first occurrence, so the result equals the one-shot
    argmax exactly."""
    B = dre.shape[0]
    s_cat = torch.cat([sre, sim], dim=1)                      # (V, 2P)
    V = s_cat.shape[0]
    best = torch.zeros((V,), dtype=torch.int64, device=sre.device)
    val = torch.full((V,), -1.0, dtype=sre.dtype, device=sre.device)
    for k in range(-(-B // C)):
        off = min(k * C, B - C)
        br, bi = dre[off:off + C], dim[off:off + C]           # (C, P)
        with full_precision():
            x = s_cat @ torch.cat([br, bi], dim=1).T
            y = s_cat @ torch.cat([-bi, br], dim=1).T
        corr2 = x * x + y * y                                 # (V, C)
        mx, am = torch.max(corr2, dim=-1)
        take = mx > val
        best = torch.where(take, am + off, best)
        val = torch.where(take, mx, val)
    return best, torch.sqrt(torch.clamp(val, min=0.0))


def compress_dictionary(dict_re, dict_im, rank):
    """Rank-r SVD compression of an MRF dictionary (McGivney 2014).

    The (P, P) Gram matrix G = D^H D is computed on the device with four
    real products; only the Gram (2 x P x P floats) goes to the host for a
    NumPy Hermitian eigendecomposition, and the (P, r) basis comes back for
    the projection of the atoms.

    Returns a dict with "basis_re"/"basis_im" ((P, r) right-singular
    vectors, host arrays), "cdict_re"/"cdict_im" ((B, r) compressed
    atoms, tensors) and "energy" (fraction of the singular energy kept).
    """
    dre, dim = _tensor(dict_re), _tensor(dict_im)
    g_re, g_im = (g.cpu().numpy() for g in _gram(dre, dim))
    b_re, b_im, energy = _host_eigh_basis(g_re, g_im, rank)
    c_re, c_im = _project_atoms(b_re, b_im, dre, dim)
    return {"basis_re": b_re, "basis_im": b_im,
            "cdict_re": c_re, "cdict_im": c_im, "energy": energy}


def _gram(dre, dim):
    """(P, P) Gram G = D^H D = (Dr - i Di)^T (Dr + i Di) of a (B, P)
    split-complex dictionary by four real products."""
    with full_precision():
        grr, gii = dre.T @ dre, dim.T @ dim
        gri, gir = dre.T @ dim, dim.T @ dre
    return grr + gii, gri - gir


def _host_eigh_basis(g_re, g_im, rank):
    """Top-`rank` eigenbasis of a Hermitian Gram (host NumPy; the Gram is
    2 x P x P floats)."""
    G = np.asarray(g_re) + 1j * np.asarray(g_im)
    w, V = np.linalg.eigh((G + G.conj().T) / 2)    # ascending eigenvalues
    order = np.argsort(w)[::-1][:rank]
    basis = V[:, order]                             # (P, r)
    energy = float(np.clip(w[order], 0, None).sum()
                   / max(np.clip(w, 0, None).sum(), 1e-30))
    dtype = np.asarray(g_re).dtype
    return (np.ascontiguousarray(basis.real, dtype=dtype),
            np.ascontiguousarray(basis.imag, dtype=dtype), energy)


def _normalize_rows(dre, dim):
    """L2-normalize split-complex rows; returns (re, im, norms) in the
    rows' precision.  A zero row stays zero (its norm divides as 1).
    Float32 rows are scaled in float64: a float32 norm's rounding (~1e-7)
    scales all of an atom's scores, as far as the gap between adjacent
    atoms of a dense grid."""
    wre, wim = dre.to(torch.float64), dim.to(torch.float64)
    n = torch.sqrt(torch.sum(wre * wre + wim * wim, dim=-1))
    safe = torch.where(n == 0, torch.ones_like(n), n)[:, None]
    return ((wre / safe).to(dre.dtype), (wim / safe).to(dre.dtype),
            n.to(dre.dtype))


def streamed_compress_dictionary(generate, nblocks, rank):
    """Rank-r compression of a dictionary too large to materialize.

    Two passes over generated atom blocks (the dictionary never exists as
    one (B, P) array: one block at a time lives on the device, and only
    the compressed (B, r) atoms and the per-atom norms persist):

    1. accumulate the (P, P) Gram of the row-NORMALIZED blocks on the
       device in the blocks' precision (``sum_b D_b^H D_b``, exactly the
       full dictionary's Gram); the host eigendecomposition then gives the
       basis :func:`compress_dictionary` gives on the normalized full
       dictionary;
    2. generate each block again and project it onto the basis (in
       float64, stored in the block's precision).

    Args:
        generate: ``generate(i) -> (re, im)`` UNnormalized split-complex
            (B_i, P) fingerprint block for ``i in range(nblocks)`` (tensors
            or host arrays); called twice per block, so it must be
            deterministic.  Blocks may differ in row count.
        nblocks: number of blocks.
        rank: singular vectors to keep.

    Returns:
        dict like :func:`compress_dictionary` -- "basis_re"/"basis_im"
        (P, r) host arrays, "cdict_re"/"cdict_im" (B, r) compressed
        NORMALIZED atoms (tensors), "energy" -- plus "norms" (B,) original
        atom norms, so :func:`~epgpy_torch.parallel.mrf_reconstruct` can
        recover the proton-density scale without the dictionary (pass
        ``dict_re=None``).
    """
    if nblocks < 1:
        raise ValueError("streamed_compress_dictionary: nblocks >= 1")
    acc_re = acc_im = None
    for i in range(nblocks):
        dre, dim, _ = _normalize_rows(*(_tensor(a) for a in generate(i)))
        g_re, g_im = _gram(dre, dim)
        if acc_re is None:
            acc_re, acc_im = g_re, g_im
        else:
            acc_re, acc_im = acc_re + g_re, acc_im + g_im
        del dre, dim, g_re, g_im
    g = torch.stack([acc_re, acc_im]).cpu().numpy()     # one host fetch
    b_re, b_im, energy = _host_eigh_basis(g[0], g[1], rank)
    c_re, c_im, norms = [], [], []
    for i in range(nblocks):
        dre, dim, n = _normalize_rows(*(_tensor(a) for a in generate(i)))
        cr, ci = _project_atoms(b_re, b_im, dre, dim)
        c_re.append(cr)
        c_im.append(ci)
        norms.append(n)
        del dre, dim
    return {"basis_re": b_re, "basis_im": b_im,
            "cdict_re": torch.cat(c_re), "cdict_im": torch.cat(c_im),
            "norms": torch.cat(norms), "energy": energy}


def save_compression(path, comp):
    """Persist a compression dict (:func:`compress_dictionary` /
    :func:`streamed_compress_dictionary` output) as one .npz: the serving
    artifact.  At rank 32 it is ~P/32 smaller than the dictionary it
    replaces, and loading it skips both the dictionary's generation and
    the Gram's eigendecomposition."""
    arrays = {}
    for k, v in comp.items():
        arrays[k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v))
    np.savez_compressed(path, **arrays)


def load_compression(path):
    """Load a compression artifact saved by :func:`save_compression`.

    The basis comes back as host arrays, the per-atom leaves ("cdict_re",
    "cdict_im", "norms") as tensors on the working device, in their saved
    dtype -- ready for ``mrf_reconstruct(dict_re=None, compression=...)``.
    """
    with np.load(path) as data:
        comp = {k: data[k] for k in data.files}
    if "energy" in comp:
        comp["energy"] = float(comp["energy"])
    for k in ("cdict_re", "cdict_im", "norms"):
        if k in comp:
            comp[k] = torch.as_tensor(comp[k], device=config.device())
    return comp


def _project_atoms(basis_re, basis_im, dre, dim):
    """Compressed (B, r) atoms of (B, P) rows, stored in the rows'
    precision but accumulated in float64: a float32 projection's rounding
    (~1e-6 of an atom's norm at P = 500) exceeds the correlation gap
    between adjacent atoms of a dense grid and flips their matches, where
    the stored float32 values are within 6e-8 of the float64 ones."""
    c_re, c_im = project_signals(basis_re, basis_im, dre.to(torch.float64),
                                 dim.to(torch.float64))
    return c_re.to(dre.dtype), c_im.to(dre.dtype)


def project_signals(basis_re, basis_im, sig_re, sig_im):
    """Project (V, P) signals onto the (P, r) compression basis: s V, as
    four real products.  Use on measured signals before
    :func:`dictionary_match` against a compressed dictionary."""
    sre, sim = _tensor(sig_re), _tensor(sig_im)
    bre, bim = (torch.as_tensor(b, dtype=sre.dtype, device=sre.device)
                for b in (basis_re, basis_im))
    with full_precision():
        rr, ii = sre @ bre, sim @ bim
        ri, ir = sre @ bim, sim @ bre
    return rr - ii, ri + ir
