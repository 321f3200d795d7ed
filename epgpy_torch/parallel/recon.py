"""End-to-end MRF map reconstruction: the serving pipeline.

Counterpart of ``epgpy_tpu/parallel/recon.py`` (:32-257):

    normalize -> [rank-r SVD compression] -> match -> complex PD scale
    -> [per-voxel damped Gauss-Newton refinement]

Everything runs on the tensors' device except the small Gram
eigendecomposition (compress_dictionary) and the host-side operator
construction of a refinement step's model; products run in full float32
(config.full_precision).  A compressed match runs in float64, on
compressed atoms that were projected in float64 and are stored in the
dictionary's precision.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from .match import (_normalize_rows, _tensor, compress_dictionary,
                    dictionary_match, full_precision, project_signals)

__all__ = ["mrf_reconstruct", "gauss_newton_refine"]


def _row_norms(re, im):
    return torch.sqrt(torch.sum(re * re + im * im, dim=-1))


def _safe(n):
    return torch.where(n == 0, torch.ones_like(n), n)


def _pd_scale(dre, dim, sre, sim):
    """Complex proton-density scale <d, s> / <d, d> per row pair."""
    num_re = torch.sum(dre * sre, -1) + torch.sum(dim * sim, -1)
    num_im = torch.sum(dre * sim, -1) - torch.sum(dim * sre, -1)
    den = _safe(torch.sum(dre * dre + dim * dim, dim=-1))
    return num_re / den, num_im / den


def mrf_reconstruct(sig_re, sig_im, dict_re, dict_im, atom_params=None, *,
                    mesh=None, axis="atoms", rank=None, compression=None,
                    atom_chunk=None):
    """Match measured fingerprints against a dictionary; produce maps.

    Args:
        sig_re/sig_im: (V, P) measured voxel fingerprints (split complex).
        dict_re/dict_im: (B, P) dictionary fingerprints, UNnormalized
            (normalization happens here so the proton-density scale can
            be recovered); None with a ``compression`` that carries
            per-atom "norms" (dictionary-free serving).
        atom_params: optional (B, npar) grid values (T1, T2, ...): matched
            rows are gathered into per-voxel maps.
        mesh, axis: the atom-sharded match (``dictionary_match``): the
            (compressed) atoms split over the mesh axis; the compression
            itself stays global.
        rank: optional SVD compression rank (McGivney 2014): matching runs
            in the r-dimensional subspace.
        compression: reuse the "compression" dict of a previous call.
        atom_chunk: optional atom-axis chunking of the match (exact).

    Returns a dict: "index" (V,) matched atom ids; "corr" (V,)
    |normalized inner product|; "pd_re"/"pd_im" (V,) complex PD scale
    with pd * dict[index] ~= signal; "maps" (V, npar) with atom_params;
    "energy" and "compression" with rank=.
    """
    sig_re, sig_im = _tensor(sig_re), _tensor(sig_im)
    if dict_re is None or dict_im is None:
        if compression is None or "norms" not in compression:
            raise ValueError(
                "mrf_reconstruct: dict_re=None requires a compression= "
                "with per-atom 'norms'")
    else:
        dict_re, dict_im = _tensor(dict_re), _tensor(dict_im)

    out = {}
    if compression is not None:
        comp = compression
    elif rank is not None:
        comp = compress_dictionary(*_normalize_rows(dict_re, dict_im)[:2],
                                   rank)
        out["energy"] = comp["energy"]
        out["compression"] = comp
    if compression is not None or rank is not None:
        # the compressed match runs in float64 on the stored atoms: a
        # float32 score's rounding flips adjacent atoms of a dense grid
        # (the 128 x 64 x 128 (T1, T2, B1) serving grid)
        mre, mim = (comp[k].to(torch.float64) for k in ("cdict_re",
                                                         "cdict_im"))
        vre, vim = project_signals(comp["basis_re"], comp["basis_im"],
                                   sig_re.to(torch.float64),
                                   sig_im.to(torch.float64))
    else:
        # normalized in float64: a float32 norm's rounding, which follows
        # the dictionary's memory layout, scales an atom's scores as far
        # as the gap between neighbours of a dense grid
        mre, mim = _normalize_rows(dict_re, dict_im)[:2]
        vre, vim = sig_re, sig_im

    idx, val = dictionary_match(mre, mim, vre, vim, mesh, axis=axis,
                                atom_chunk=atom_chunk)
    out["index"] = idx
    out["corr"] = (val / _safe(_row_norms(sig_re, sig_im))).to(sig_re.dtype)

    if dict_re is None:
        # dictionary-free: pd = <c_idx, v> / norms[idx], exact up to the
        # atom's energy outside the rank-r subspace
        cre_m, cim_m = comp["cdict_re"][idx], comp["cdict_im"][idx]
        num_re = torch.sum(cre_m * vre + cim_m * vim, dim=-1)
        num_im = torch.sum(cre_m * vim - cim_m * vre, dim=-1)
        n_m = _safe(_tensor(comp["norms"])[idx])
        out["pd_re"], out["pd_im"] = ((num / n_m).to(sig_re.dtype)
                                      for num in (num_re, num_im))
    else:
        # complex PD against the matched UNnormalized atom, full space
        out["pd_re"], out["pd_im"] = _pd_scale(dict_re[idx], dict_im[idx],
                                               sig_re, sig_im)
    if atom_params is not None:
        out["maps"] = _tensor(atom_params)[idx]
    return out


def gauss_newton_refine(signal_and_jac, theta0, sig_re, sig_im, *,
                        iters=6, damping=1e-3, bounds=None,
                        solve_scale=False):
    """Per-voxel damped Gauss-Newton refinement of matched parameters.

    Off-grid accuracy beyond the dictionary step: pairs with the fused
    Jacobian dispatch, which produces dS/dtheta for all voxels in one
    device pass per iteration.

    Args:
        signal_and_jac: theta (npar, V) host array -> ((re, im), (jre,
            jim)) with signal (N, V) and Jacobian (N, V, npar), split
            complex (tensors or arrays).  It receives theta as a host
            array so operators built from it keep the kernel dispatch
            engaged (the matcher takes host parameters only).
        theta0: (npar, V) initial parameters (e.g. recon["maps"].T).
        sig_re/sig_im: (N, V) measured fingerprints.
        iters, damping: GN iterations / Levenberg diagonal damping.
        bounds: optional (npar, 2) box constraints.
        solve_scale: solve the per-voxel complex proton-density scale in
            closed form each iteration and refine theta on the scaled
            residual (variable projection).  Unlike the JAX package's
            update, the Jacobian is projected orthogonal to the model
            signal first (Kaufman's variable-projection Jacobian): the
            closed-form scale has already absorbed that direction, and
            leaving it in biases the step wherever a parameter changes
            the fingerprint's amplitude (B1 above all).

    The normal equations, the batched solve and the clip run on the
    working device.  Returns refined theta (npar, V) as a NumPy array.
    """
    dtype, device = config.real_dtype(), config.device()

    def dev(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    theta = dev(np.asarray(theta0))
    sig_re, sig_im = dev(sig_re), dev(sig_im)
    lo = hi = None
    if bounds is not None:
        b = np.asarray(bounds, float)
        lo, hi = dev(b[:, 0])[:, None], dev(b[:, 1])[:, None]
    for _ in range(iters):
        (re, im), (jre, jim) = signal_and_jac(theta.cpu().numpy())
        theta = _gn_update(theta, dev(re), dev(im), dev(jre), dev(jim),
                           sig_re, sig_im, damping, lo, hi,
                           solve_scale=bool(solve_scale))
    return theta.cpu().numpy()


def _gn_update(theta, re, im, jre, jim, sig_re, sig_im, damping, lo, hi, *,
               solve_scale):
    """One damped GN step on the device (normal equations + batched
    solve); re/im (N, V), jre/jim (N, V, npar), theta (npar, V)."""
    with full_precision():
        return _gn_step(theta, re, im, jre, jim, sig_re, sig_im, damping,
                        lo, hi, solve_scale)


def _gn_step(theta, re, im, jre, jim, sig_re, sig_im, damping, lo, hi,
             solve_scale):
    if solve_scale:
        # c = <s, y> / <s, s> per voxel (complex inner products)
        num_re = torch.sum(re * sig_re + im * sig_im, dim=0)
        num_im = torch.sum(re * sig_im - im * sig_re, dim=0)
        den = torch.clamp(torch.sum(re * re + im * im, dim=0), min=1e-30)
        cre, cim = num_re / den, num_im / den
        # J <- J - s <s, J> / <s, s>: the part of J along s is the scale's
        aR = (torch.einsum("nv,nvi->vi", re, jre)
              + torch.einsum("nv,nvi->vi", im, jim)) / den[:, None]
        aI = (torch.einsum("nv,nvi->vi", re, jim)
              - torch.einsum("nv,nvi->vi", im, jre)) / den[:, None]
        jre = jre - (re[..., None] * aR - im[..., None] * aI)
        jim = jim - (re[..., None] * aI + im[..., None] * aR)
        re, im = cre * re - cim * im, cre * im + cim * re
        cre, cim = cre[:, None], cim[:, None]
        jre, jim = cre * jre - cim * jim, cre * jim + cim * jre
    rr, ri = sig_re - re, sig_im - im                       # (N, V)
    # normal equations on the complex residual: A = Re(J^H J),
    # g = Re(J^H r), accumulating the re/im channels
    A = (torch.einsum("nvi,nvj->vij", jre, jre)
         + torch.einsum("nvi,nvj->vij", jim, jim))
    g = (torch.einsum("nvi,nv->vi", jre, rr)
         + torch.einsum("nvi,nv->vi", jim, ri))
    diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-12)
    A = A + torch.diag_embed(damping * diag)
    delta = torch.linalg.solve(A, g[..., None])[..., 0]      # (V, npar)
    theta = theta + delta.T
    if lo is not None:
        theta = torch.clamp(theta, lo, hi)
    return theta
