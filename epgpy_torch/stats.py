"""Statistics: CRLB cost functions and delta-method confidence intervals.

Counterpart of ``epgpy_tpu/stats.py:27-139`` (reference epgpy/stats.py:
Fisher information F = J^H J / sigma2, CRLB = tr(W F^-1), delta-method
intervals).  Every function is plain torch on the inputs' device, so
``crlb`` is differentiable by autograd too; the analytic Hessian
contraction (``crlb(J, H)``) is what the fused sequence-design gradient
uses.  Fisher and covariance products feed matrix inversions that amplify
their error by cond^2, so they run in full float32 (TF32 off,
``config.full_precision``), as the JAX package runs them at
``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import full_precision

__all__ = ["crlb", "crlb_split", "confint", "get_tstat_interval"]

#: Fisher matrices with a condition number beyond this are reported as NaN
#: rather than raising (matches the reference's singular-matrix behavior)
_COND_LIMIT = 1e30


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _fisher(J, sigma2):
    """Fisher information (..., p, p) from a complex Jacobian (..., n, p)."""
    J = _tensor(J)
    with full_precision():
        return (J.conj().transpose(-1, -2) @ J).real / sigma2


def _bound_matrix(fisher):
    """inv(Fisher), with numerically singular batches mapped to NaN.

    The inversion runs on an identity-substituted matrix so the NaNs never
    enter linalg (NaN inputs poison the whole batch on some backends)."""
    bad = (torch.linalg.cond(fisher) > _COND_LIMIT)[..., None, None]
    eye = torch.eye(fisher.shape[-1], dtype=fisher.dtype,
                    device=fisher.device)
    inv = torch.linalg.inv(torch.where(bad, eye, fisher))
    return torch.where(bad, torch.full_like(inv, float("nan")), inv)


def crlb(J, H=None, *, W=None, sigma2=1, log=False):
    """Cramer-Rao lower bound cost: sum_p W_p * inv(Fisher)_pp.

    Args:
        J: Jacobian (..., npoint, nparam) complex
        H: optional Hessian (..., npoint, nparam, nvar) -> also return the
            analytic gradient w.r.t. the nvar sequence parameters
        W: optional per-parameter weights
        sigma2: noise variance
        log: return log10 of the cost (and correspondingly scaled gradient)
    """
    J = _tensor(J)
    lb = _bound_matrix(_fisher(J, sigma2))
    diag = torch.diagonal(lb, dim1=-2, dim2=-1)
    weights = None if W is None else _tensor(W).to(lb)
    cost = torch.sum(diag if weights is None else diag * weights, dim=-1)

    if H is None:
        return torch.log10(cost) if log else cost

    # d cost / dx = -tr(M dF/dx lb) with M = diag(W) lb and
    # dF/dx = 2 Re(H^H J) / sigma2 (symmetrized over the p,q Fisher axes)
    with full_precision():
        dF = torch.einsum("...npx,...nq->...pqx", _tensor(H).conj(), J).real
        dF = (dF + dF.transpose(-3, -2)) / sigma2
        M = lb if weights is None else lb * weights[..., None]
        grad = -torch.einsum("...pq,...qrx,...rp->...x", M, dF, lb)
    if log:
        return torch.log10(cost), grad / (cost[..., None] * np.log(10.0))
    return cost, grad


def crlb_split(J, W=None, sigma2=1, log=False):
    """Per-variable CRB values (leading axis = variable)."""
    lb = _bound_matrix(_fisher(J, sigma2))
    crb = torch.diagonal(lb, dim1=-2, dim2=-1)
    if W is not None:
        crb = crb * _tensor(W).to(crb)
    if log:
        crb = torch.log10(crb)
    return torch.movedim(crb, -1, 0)


def confint(obs, pred, jac, hess=None, *, conflevel=0.95):
    """Delta-method confidence intervals and prediction bands.

    Returns (cints, cband): half-widths of the per-parameter confidence
    intervals (..., nparam) and of the per-point prediction band
    (..., npoint), at `conflevel` with npoint - nparam degrees of freedom.
    """
    jac = _tensor(jac)
    npoint, nparam = jac.shape[-2:]
    dof = npoint - nparam
    res = _tensor(obs) - _tensor(pred)
    sse = torch.sum((res * res.conj()).real, dim=-1)

    with full_precision():
        # observed-information covariance: with res = obs - pred,
        # d res/dtheta = -J, so d2(SSE)/dtheta2 = 2 [J^H J - Re(conj(H) res)]
        info = (jac.conj().transpose(-1, -2) @ jac).real
        if hess is not None:
            info = info - torch.einsum("...nqp,...n->...pq",
                                       _tensor(hess).conj(), res).real
        cov = torch.linalg.inv(info) * (sse[..., None, None] / dof)

        tval = get_tstat_interval(conflevel, dof)
        cints = tval * torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
        # prediction variance per point: j_n^H cov j_n
        predvar = torch.sum((jac @ cov.to(jac.dtype)) * jac.conj(),
                            dim=-1).real
    return cints, tval * torch.sqrt(predvar)


#: memo of two-sided Student-t quantiles {(conflevel, dof): t}
_TSTAT_CACHE: dict = {}


def get_tstat_interval(conflevel, nu):
    """Two-sided t-statistic bound at `conflevel` with `nu` dof."""
    key = (float(conflevel), int(nu))
    if key not in _TSTAT_CACHE:
        from scipy import stats as sps
        _TSTAT_CACHE[key] = float(sps.t.interval(key[0], key[1])[1])
    return _TSTAT_CACHE[key]


#: parity alias (reference epgpy/stats.py exposes the table by this name)
TSTAT_INTERVAL = _TSTAT_CACHE
