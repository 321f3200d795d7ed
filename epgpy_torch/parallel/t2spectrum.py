"""Multi-component T2 spectrum / myelin-water-fraction (MWF) mapping.

Counterpart of ``epgpy_tpu/parallel/t2spectrum.py``.  EPG-NNLS
(Prasloski 2012): fit each voxel's multi-echo spin-echo decay as a
non-negative combination of EPG-simulated CPMG decay curves --
stimulated-echo corrected, so refocusing-angle (B1) errors do not bias
the spectrum.

* The basis is simulated once through ``models.mse.mse_signal`` on the
  (T2 bin x B1 candidate) outer grid; on the card in float32
  ``simulate()`` dispatches it to the CPMG kernel (``csrc/cpmg.cu``,
  ``fisp_dispatch.match_mse``).
* The fits are one batched FISTA projected-gradient NNLS over every
  (voxel, B1 candidate) pair.  The Gram AtA stays (NB1, n, n) -- never
  broadcast over voxels -- and the iterate is laid out (NB1, V, n), so a
  gradient is one batched product ``z @ AtA`` per B1 plane (AtA is
  symmetric).  Products run in true float32 (``config.full_precision``):
  spectra are sensitive to reduced-precision passes.
* The step size needs the Gram's largest eigenvalue: ``eigvalsh`` of the
  (NB1, n, n) Gram runs on the host in float64 (NumPy); the FISTA
  momentum sequence does not depend on the data and is computed on the
  host once.
* B1 is estimated per voxel by residual minimization over the candidate
  axis, on the device; the maps come back in one host fetch.

The FISTA loop and its products are plain torch operations: in JAX they
are XLA operations too (no Pallas kernel).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import full_precision
from .match import _tensor

__all__ = ["t2_basis", "nnls", "t2_spectrum_map"]


def t2_basis(necho, esp, t2grid, b1grid=1.0, *, T1=1000.0,
             exc=(90.0, 90.0), ref=(180.0, 0.0), **kwargs):
    """Simulate the EPG-NNLS basis: CPMG echo decays per (B1, T2 bin).

    Args:
        necho: echo count; esp: echo spacing (ms).
        t2grid: (nbins,) T2 values (ms), typically log-spaced.
        b1grid: scalar or (NB1,) refocusing-efficiency candidates.
        T1: scalar T1 (ms); the T2 spectrum is insensitive to T1 for
            esp << T1, so one representative value is standard.
        exc/ref: (alpha, phi) of excitation / refocusing pulses (deg).

    Returns:
        (NB1, necho, nbins) numpy array of echo magnitudes (unit
        equilibrium) in the working precision.  With scalar b1grid,
        NB1 == 1.
    """
    from ..models.mse import mse_signal

    t2grid = np.atleast_1d(np.asarray(t2grid, float))
    b1grid = np.atleast_1d(np.asarray(b1grid, float))
    # explicit outer grid: axis 0 = T2 bins, axis 1 = B1 candidates
    sig = mse_signal(necho, T1, t2grid[:, None], esp=esp,
                     B1=b1grid[None, :], exc=exc, ref=ref, **kwargs)
    sig = np.abs(np.asarray(sig))          # (necho, nbins, NB1)
    return np.ascontiguousarray(np.moveaxis(sig, 2, 0))


def _momentum(iters):
    """FISTA's extrapolation weights (t_k - 1) / t_{k+1}, t_0 = 1: they do
    not depend on the data, so they are host floats."""
    out, t = [], 1.0
    for _ in range(int(iters)):
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        out.append((t - 1.0) / t_new)
        t = t_new
    return out


def _step(Lip, like):
    """1 / Lip, with Lip clamped away from 0 (a degenerate design, e.g. all
    zeros, has Lip == 0, and an unclamped step would turn the zero
    solution into NaNs), as a tensor on `like`'s device and dtype."""
    tiny = torch.finfo(like.dtype).tiny
    return torch.as_tensor(1.0 / np.maximum(Lip, tiny), dtype=like.dtype,
                           device=like.device)


def _fista(grad, Aty, step, iters):
    """Batched FISTA on 0.5 x' AtA x - Aty . x over the nonnegative
    orthant: `grad(z)` is AtA z - Aty; `step` broadcasts against Aty."""
    neg_step = -step
    x = torch.zeros_like(Aty)
    z = x
    with full_precision():
        for m in _momentum(iters):
            x_new = torch.addcmul(z, grad(z), neg_step).clamp_(min=0.0)
            # z = x_new + m (x_new - x)
            z = torch.lerp(x, x_new, 1.0 + m)
            x = x_new
    return x


def _host_lipschitz(AtA):
    """Largest eigenvalue per Gram (exact: n is tens of bins), on the host
    in float64."""
    return np.linalg.eigvalsh(AtA.detach().cpu().double().numpy())[..., -1]


def nnls(A, y, *, reg=0.0, iters=2000):
    """Batched non-negative least squares: min ||A x - y||^2 + reg ||x||^2,
    x >= 0, solved by FISTA (the problem is convex; for reg > 0 strictly).

    Args:
        A: (..., m, n) design matrices (batch dims broadcast with y's).
        y: (..., m) observations.
        reg: Tikhonov weight (absolute, on ||x||^2).
        iters: FISTA iterations.  The default (2000) targets
            spectrum-grade accuracy on typical (32 echo x 40-60 bin)
            EPG-NNLS problems; FISTA converges as O(1/k^2) with no
            stopping test, so for publication numbers verify against a
            higher count (e.g. 2x) once.

    Returns:
        (..., n) solutions (a tensor on the working device).
    """
    A = _tensor(A)
    y = _tensor(y, A.dtype)
    with full_precision():
        AtA = A.transpose(-1, -2) @ A
        if reg:
            AtA = AtA + reg * torch.eye(A.shape[-1], dtype=A.dtype,
                                        device=A.device)
        Aty = (y.unsqueeze(-2) @ A).squeeze(-2)
    batch = torch.broadcast_shapes(AtA.shape[:-2], Aty.shape[:-1])
    Aty = Aty.expand(batch + Aty.shape[-1:])
    step = _step(_host_lipschitz(AtA), Aty)[..., None]

    def grad(z):        # AtA is symmetric: z AtA == AtA z
        return (z.unsqueeze(-2) @ AtA).squeeze(-2) - Aty

    return _fista(grad, Aty, step, iters)


def _fit_all(basis, signals, reg, iters):
    """(V, necho) signals x (NB1, necho, nbins) basis -> per-pair NNLS.

    Returns (x, resid2): (NB1, V, nbins) spectra and (NB1, V) squared
    residuals.  AtA stays (NB1, n, n): the gradient of every voxel of one
    B1 plane is one batched product (NB1, V, n) @ (NB1, n, n)."""
    n = basis.shape[-1]
    with full_precision():
        AtA = basis.transpose(1, 2) @ basis                 # (NB1, n, n)
        AtA = AtA + reg * torch.eye(n, dtype=basis.dtype,
                                    device=basis.device)
        neg_Aty = -(signals @ basis)                        # (NB1, V, n)
    step = _step(_host_lipschitz(AtA), neg_Aty)[:, None, None]

    def grad(z):
        return torch.baddbmm(neg_Aty, z, AtA)

    x = _fista(grad, neg_Aty, step, iters)
    with full_precision():
        fit = x @ basis.transpose(1, 2)                     # (NB1, V, m)
    resid2 = torch.sum((fit - signals) ** 2, dim=-1)        # (NB1, V)
    return x, resid2


def t2_spectrum_map(signals, basis, t2grid, *, b1grid=None, reg=None,
                    mwf_cutoff=40.0, iters=2000):
    """Voxelwise regularized EPG-NNLS T2 spectra with per-voxel B1.

    Args:
        signals: (V, necho) real echo magnitudes (any scale; spectra
            come back in signal units).
        basis: (NB1, necho, nbins) from :func:`t2_basis`.
        t2grid: (nbins,) T2 values (ms) matching the basis columns.
        b1grid: optional (NB1,) candidate values; if given, the result
            carries the selected ``b1`` per voxel.
        reg: Tikhonov weight; default 1e-3 x mean diag of the basis
            Gram (scale-invariant small regularization -- needed when
            nbins > necho, where plain NNLS is non-unique).
        mwf_cutoff: myelin-water upper T2 (ms); MWF = sum of spectrum
            below the cutoff / total.
        iters: FISTA iterations (see :func:`nnls` on the default).

    Returns:
        dict with host arrays: ``spectrum`` (V, nbins), ``resid`` (V,),
        ``mwf`` (V,), ``gm_t2`` (V,) geometric-mean T2 (ms),
        ``b1_index`` (V,) and (if b1grid given) ``b1`` (V,).
    """
    basis = _tensor(basis)
    signals = _tensor(signals, basis.dtype)
    t2grid = np.atleast_1d(np.asarray(t2grid, float))
    if basis.ndim != 3 or basis.shape[-1] != t2grid.size:
        raise ValueError(
            f"basis must be (NB1, necho, {t2grid.size}), got "
            f"{tuple(basis.shape)}")
    if signals.ndim != 2 or signals.shape[-1] != basis.shape[1]:
        raise ValueError(
            f"signals must be (V, {basis.shape[1]}), got "
            f"{tuple(signals.shape)}")
    if b1grid is not None and len(np.atleast_1d(b1grid)) != basis.shape[0]:
        raise ValueError(
            f"b1grid has {len(np.atleast_1d(b1grid))} candidates but the "
            f"basis carries {basis.shape[0]} B1 planes")
    if reg is None:
        reg = 1e-3 * torch.mean(torch.sum(basis * basis, dim=1))
    x, resid2 = _fit_all(basis, signals, reg, int(iters))
    V, n = signals.shape[0], basis.shape[-1]
    best = torch.argmin(resid2, dim=0)                           # (V,)
    spec = x.gather(0, best[None, :, None].expand(1, V, n))[0]   # (V, n)
    resid = torch.sqrt(resid2.gather(0, best[None])[0])
    total = torch.sum(spec, dim=-1)
    pos = total > 0
    safe = torch.where(pos, total, torch.ones_like(total))
    t2 = torch.as_tensor(t2grid, dtype=spec.dtype, device=spec.device)
    myelin = torch.sum(torch.where(t2 <= float(mwf_cutoff), spec,
                                   torch.zeros_like(spec)), dim=-1)
    gm_t2 = torch.exp(torch.sum(spec * torch.log(t2), dim=-1) / safe)
    zero = torch.zeros_like(total)
    cols = [resid, torch.where(pos, myelin / safe, zero),
            torch.where(pos, gm_t2, zero), best.to(spec.dtype)]
    # one host fetch for every map
    host = torch.cat([spec, torch.stack(cols, dim=1)], dim=1).cpu().numpy()
    out = {"spectrum": host[:, :n], "resid": host[:, n],
           "mwf": host[:, n + 1], "gm_t2": host[:, n + 2],
           "b1_index": host[:, n + 3].astype(np.int64)}
    if b1grid is not None:
        out["b1"] = np.asarray(b1grid, float)[out["b1_index"]]
    return out
