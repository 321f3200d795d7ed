"""CRLB sequence design: the MRF flip-angle and TR train, and the
variable-flip TSE (CPMG) train.

Counterpart of ``epgpy_tpu/parallel/crlb.py`` (:149-463).  The MRF half
is the reference workflow examples/sequence/optim_mrf.py: choose
the per-pulse flip angles FA_i and repetition times TR_i of a 5-op FISP
train after an inversion to minimize the mean Cramer-Rao lower bound of
(magnitude, T1, T2) over an atom grid, under the box bounds FA in
[10, 60], TR in [11, 16] and |FA_i - FA_{i-1}| <= 1.

* ``mrf_design_loss`` is the autograd oracle: each atom's signal comes
  from ``models.mrf.fisp_mrf_signal``, its (T1, T2) tangents from
  ``torch.func.jacfwd`` under ``torch.func.vmap`` over atoms, and the
  gradient in (FA, TR) from reverse mode;
* ``mrf_design_loss_grad_fused`` takes value and the full 2N gradient
  from ONE launch of the per-pulse Hessian kernel
  (``models.cuda_hessian``), contracted by ``stats.crlb``'s analytic
  Hessian route;
* ``mrf_design_slsqp`` drives either with scipy's SLSQP.

The TSE half (examples/optim_tse.py): ``mse_design_loss_grad_fused``
takes the mean (magnitude, T2)-CRLB of a CPMG train and its full 2E
gradient in (FA_i, esp_i) from ONE launch of the per-echo design kernel
(``models.cuda_msedesign``), and ``tse_design_slsqp`` drives it with
scipy's SLSQP under a SAR budget and a per-echo flip-increment bound.

The atom-sharded form (``mesh=``) and the FA-only
``fingerprint_crlb_loss`` / ``crlb_train_step`` (which take a mesh with a
``tangents`` axis) come with the mesh slice (ROADMAP queue 1): only
``mesh=None`` is accepted here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config, stats
from ..models.cuda_hessian import fisp_hessian_cuda
from ..models.cuda_msedesign import cpmg_design_cuda
from ..models.mrf import fisp_mrf_signal

__all__ = ["FA_BOUNDS", "TR_BOUNDS", "mrf_design_loss",
           "mrf_design_loss_grad_fused", "mrf_design_slsqp",
           "mrf_design_step", "mse_design_loss_grad_fused",
           "tse_design_slsqp"]

FA_BOUNDS = (10.0, 60.0)
TR_BOUNDS = (11.0, 16.0)


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "the atom-sharded design (mesh=) is not ported to epgpy_torch "
            "yet: it comes with the mesh slice (ROADMAP queue 1); pass "
            "mesh=None")


def _real(x):
    """A tensor as it is; a host value on the working device and dtype."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float64),
                           dtype=config.real_dtype(), device=config.device())


def _atom_crlb_mt1t2(FA, TR, T1, T2, *, TE, nstate, inversion, sigma2,
                     ridge):
    """CRLB of (magnitude, T1, T2) for one atom, reference weighting.

    J columns: the signal itself (d/d magnitude at m = 1) and the T1/T2
    sensitivities; W = diag(1, 1/T1^2, 1/T2^2); crlb = tr(W inv(J'J/s2))
    (reference epgpy/stats.py:6-36 + optim_mrf.py:57-60)."""
    def f(t1, t2):
        re, im = fisp_mrf_signal(FA, 90.0, TR, TE, t1, t2, 1.0,
                                 nstate=nstate, inversion=inversion)
        return torch.cat([re, im])

    s = f(T1, T2)
    d1, d2 = torch.func.jacfwd(f, argnums=(0, 1))(T1, T2)
    J = torch.stack([s, d1, d2], dim=-1)                       # (2N, 3)
    eye = torch.eye(3, dtype=J.dtype, device=J.device)
    fisher = J.T @ J / sigma2 + ridge * eye
    w = torch.stack([torch.ones_like(T1), 1.0 / T1**2, 1.0 / T2**2])
    return torch.sum(w * torch.diagonal(torch.linalg.inv(fisher)))


def mrf_design_loss(FA, TR, T1s, T2s, mesh=None, *, TE=5.0, nstate=10,
                    inversion=20.0, sigma2=10.0, ridge=1e-9,
                    smooth_weight=0.0):
    """Mean (magnitude, T1, T2)-CRLB over the atom grid.

    FA/TR are (N,) per-pulse tensors (make them require grad for the
    autograd gradient); T1s/T2s (B,) atoms.  An optional quadratic
    penalty enforces the reference's |FA_i - FA_{i-1}| < 1 smoothness
    constraint softly.  Returns a 0-d tensor."""
    _no_mesh(mesh)
    FA, TR, T1s, T2s = (_real(x) for x in (FA, TR, T1s, T2s))
    crlb = torch.func.vmap(lambda t1, t2: _atom_crlb_mt1t2(
        FA, TR, t1, t2, TE=TE, nstate=nstate, inversion=inversion,
        sigma2=sigma2, ridge=ridge))(T1s, T2s)
    loss = torch.mean(crlb)
    if smooth_weight:
        excess = torch.clamp(torch.abs(torch.diff(FA)) - 1.0, min=0.0)
        loss = loss + smooth_weight * torch.sum(excess**2)
    return loss


def _loss_and_grad(FA, TR, T1s, T2s, **opts):
    """(loss, gFA, gTR) of :func:`mrf_design_loss` by reverse mode."""
    fa = _real(FA).detach().clone().requires_grad_(True)
    tr = _real(TR).detach().clone().requires_grad_(True)
    loss = mrf_design_loss(fa, tr, T1s, T2s, **opts)
    gfa, gtr = torch.autograd.grad(loss, (fa, tr))
    return loss.detach(), gfa, gtr


def mrf_design_loss_grad_fused(FA, TR, T1s, T2s, mesh=None, *, TE=5.0,
                               nstate=10, inversion=20.0, sigma2=10.0,
                               smooth_weight=0.0):
    """(loss, gFA, gTR) via the fused per-pulse Hessian kernel.

    Same cost as :func:`mrf_design_loss`, but value AND the full 2N
    gradient come from ONE kernel launch: the kernel returns J =
    dS/d(mag, T1, T2) and H = d2S/d(mag, T1, T2) d(FA_i, TR_i) per atom,
    and ``stats.crlb`` contracts the analytic gradient.  The kernel runs
    on the device of T1s (the plain twin on the CPU), in float32; pass
    float32 tensors on the card."""
    _no_mesh(mesh)
    T1s = _real(T1s)
    T2s, FA, TR = (_real(x).to(T1s) for x in (T2s, FA, TR))
    out = fisp_hessian_cuda(FA, 90.0, TR - TE, T1s, T2s, te=TE,
                            inversion=inversion, nstate=nstate)
    N = FA.shape[0]
    cols = ("sig", "dT1", "dT2")
    J = torch.complex(torch.stack([out[k][0] for k in cols], -1),
                      torch.stack([out[k][1] for k in cols], -1))  # (B, N, 3)
    # H (B, N_echo, 3, 2N): rows (mag, T1, T2), columns (alpha_i, tau_i)
    cplx = torch.complex64 if T1s.dtype == torch.float32 \
        else torch.complex128
    H = torch.empty(J.shape[:2] + (3, 2 * N), dtype=cplx, device=J.device)
    Hv = torch.view_as_real(H)
    for r, pre in enumerate(("d", "dT1d", "dT2d")):
        for half, name in enumerate(("alpha", "tau")):
            for ri in (0, 1):
                Hv[:, :, r, half * N:(half + 1) * N, ri] = out[pre + name][ri]
    w = torch.stack([torch.ones_like(T1s), 1.0 / T1s**2, 1.0 / T2s**2], -1)
    cost, grad = stats.crlb(J, H, W=w, sigma2=sigma2)
    loss, grad = torch.mean(cost), torch.mean(grad, dim=0)
    gFA, gTR = grad[:N], grad[N:]
    if smooth_weight:
        d = torch.diff(FA)
        excess = torch.clamp(torch.abs(d) - 1.0, min=0.0)
        loss = loss + smooth_weight * torch.sum(excess**2)
        pen = 2.0 * smooth_weight * excess * torch.sign(d)
        zero = torch.zeros(1, dtype=pen.dtype, device=pen.device)
        gFA = gFA + torch.cat([-pen, zero]) + torch.cat([zero, pen])
    return loss, gFA, gTR


def mrf_design_slsqp(FA0, TR0, T1s, T2s, mesh=None, *, maxiter=250,
                     ftol=1e-6, callback=None, engine="scan", **opts):
    """Reference-fidelity constrained CRLB design: scipy SLSQP over
    [FA (N,), TR (N,)] with box bounds FA in [10, 60], TR in [11, 16] and
    the hard smoothness constraint |FA_i - FA_{i-1}| <= 1 (reference
    optim_mrf.py:119-156), given to SLSQP as two linear inequalities.

    ``engine="fused"`` takes value and gradient from the Hessian kernel
    (float32 on the device of T1s; the ridge option is not used there),
    ``"scan"`` from autograd of :func:`mrf_design_loss` in the working
    precision.  Returns (FA, TR, scipy result)."""
    from scipy import optimize

    _no_mesh(mesh)
    nTR = len(FA0)
    if engine == "fused":
        opts.pop("ridge", None)
        T1f = _real(T1s).to(torch.float32)
        T2f = _real(T2s).to(T1f)

        def val_grad(fa, tr):
            return mrf_design_loss_grad_fused(
                torch.as_tensor(fa, dtype=torch.float32, device=T1f.device),
                torch.as_tensor(tr, dtype=torch.float32, device=T1f.device),
                T1f, T2f, **opts)
    elif engine == "scan":
        def val_grad(fa, tr):
            return _loss_and_grad(fa, tr, T1s, T2s, **opts)
    else:
        raise ValueError(f"engine must be 'scan' or 'fused', got {engine!r}")

    def costjac(x):
        v, gfa, gtr = val_grad(x[:nTR], x[nTR:])
        g = torch.cat([gfa, gtr]).detach().cpu().numpy().astype(float)
        return float(v), g

    # reference optim_mrf.py:99-103: FA increment magnitude <= 1, as the
    # two linear inequalities 1 -+ (FA_i - FA_{i-1}) >= 0 (the same
    # feasible set as 1 - |diff| >= 0, whose kink SLSQP linearizes on one
    # side only, so its iterates can leave the set)
    D = np.zeros((max(nTR - 1, 0), 2 * nTR))
    D[:, 1:nTR] += np.eye(nTR - 1)
    D[:, :nTR - 1] -= np.eye(nTR - 1)
    smooth = {"type": "ineq",
              "fun": lambda x: np.concatenate([1.0 - D @ x, 1.0 + D @ x]),
              "jac": lambda x: np.concatenate([-D, D])}
    res = optimize.minimize(
        costjac, np.concatenate([np.asarray(FA0, float),
                                 np.asarray(TR0, float)]),
        jac=True, method="SLSQP",
        bounds=[FA_BOUNDS] * nTR + [TR_BOUNDS] * nTR,
        constraints=[smooth] if nTR > 1 else [], callback=callback,
        options={"ftol": ftol, "maxiter": maxiter})
    return np.asarray(res.x[:nTR]), np.asarray(res.x[nTR:]), res


def mse_design_loss_grad_fused(FA, ESP, T1s, T2s, mesh=None, *,
                               exc=(90.0, 90.0), nstate=None, sigma2=10.0,
                               include_t1=False):
    """(loss, gFA, gESP) for variable-flip TSE design via the fused
    per-echo CPMG design kernel.

    Cost: the mean (magnitude, T2)-CRLB over the atom grid (reference
    weighting W = diag(1, 1/T2^2), epgpy stats.py:6-36) of the CPMG echo
    train with echo spacings ESP and refocusing flips FA (phase 0); value
    AND the full 2E gradient come from ONE ``cpmg_design_cuda(
    second_order=True)`` launch: J = dS/d(targets) and H = d2S/d(targets)
    d(FA_i, esp_i) per atom, contracted by ``stats.crlb``'s analytic
    gradient.  The kernel runs on the device of T1s (the plain twin on
    the CPU) in its dtype; pass float32 tensors on the card.

    ``include_t1`` adds the T1 column.  It is off by default: a CPMG train
    measures T2, its dS/dT1 column is ~1e-6 of the signal's scale, so the
    3x3 Fisher matrix is singular in float32 and its inverse not finite
    (float64 survives); enable it only for trains with T1 sensitivity."""
    _no_mesh(mesh)
    T1s = torch.atleast_1d(_real(T1s))
    T2s, FA, ESP = (_real(x).to(T1s) for x in (T2s, FA, ESP))
    T1s, T2s = torch.broadcast_tensors(T1s, torch.atleast_1d(T2s))
    E = FA.shape[0]
    out = cpmg_design_cuda(exc, FA, 0.0, ESP, T1s, T2s,
                           nstate=2 * E if nstate is None else nstate,
                           second_order=True)

    def c(key):
        return torch.complex(*out[key])

    cols = [c("sig"), c("dT2")]
    rows = [torch.cat([c("dalpha"), c("desp")], -1),
            torch.cat([c("dT2dalpha"), c("dT2desp")], -1)]
    ws = [torch.ones_like(T1s), 1.0 / T2s**2]
    if include_t1:
        cols.insert(1, c("dT1"))
        rows.insert(1, torch.cat([c("dT1dalpha"), c("dT1desp")], -1))
        ws.insert(1, 1.0 / T1s**2)
    J = torch.stack(cols, -1)                   # (B, E, nv)
    H = torch.stack(rows, -2)                   # (B, E, nv, 2E)
    cost, grad = stats.crlb(J, H, W=torch.stack(ws, -1), sigma2=sigma2)
    grad = torch.mean(grad, dim=0)
    return torch.mean(cost), grad[:E], grad[E:]


def tse_design_slsqp(FA0, ESP0, T1s, T2s, mesh=None, *, maxiter=200,
                     ftol=1e-8, fa_bounds=(50.0, 180.0),
                     esp_bounds=(5.0, 15.0), sar_budget=None, dfa_max=None,
                     fix_esp=False, callback=None, **opts):
    """Constrained variable-flip TSE CRLB design: scipy SLSQP driven by
    :func:`mse_design_loss_grad_fused` (one kernel launch per evaluation,
    in float32 on the device of T1s; the plain twin in the working
    precision on the CPU).

    The TSE design tension (Busse 2006): SAR scales with sum(FA_i^2)
    while T2 precision wants large flips -- ``sar_budget`` bounds
    ``mean((FA_i/180)^2)`` as a hard inequality; ``dfa_max`` bounds the
    per-echo flip increments, ``dfa_max - |FA_i - FA_{i-1}| >= 0`` as in
    the JAX function; ``fix_esp`` freezes the echo spacings (flip-only
    design).  Returns (FA, ESP, scipy result)."""
    from scipy import optimize

    _no_mesh(mesh)
    E = len(FA0)
    T1d = _real(T1s)
    if T1d.is_cuda:
        T1d = T1d.to(torch.float32)
    T2d = _real(T2s).to(T1d)

    def costjac(x):
        v, gfa, gesp = mse_design_loss_grad_fused(
            torch.as_tensor(x[:E], dtype=T1d.dtype, device=T1d.device),
            torch.as_tensor(x[E:], dtype=T1d.dtype, device=T1d.device),
            T1d, T2d, **opts)
        g = torch.cat([gfa, torch.zeros_like(gesp) if fix_esp else gesp])
        return float(v), g.detach().cpu().numpy().astype(float)

    constraints = []
    if sar_budget is not None:
        def sar(x):
            return sar_budget - np.mean((x[:E] / 180.0) ** 2)

        def sar_jac(x):
            g = np.zeros_like(x)
            g[:E] = -2.0 * x[:E] / (180.0 ** 2 * E)
            return g

        constraints.append({"type": "ineq", "fun": sar, "jac": sar_jac})
    if dfa_max is not None:
        def smooth(x):
            return dfa_max - np.abs(np.diff(x[:E]))

        constraints.append({"type": "ineq", "fun": smooth})

    esp_b = ([(e, e) for e in np.asarray(ESP0, float)] if fix_esp
             else [esp_bounds] * E)
    res = optimize.minimize(
        costjac, np.concatenate([np.asarray(FA0, float),
                                 np.asarray(ESP0, float)]),
        jac=True, method="SLSQP", bounds=[fa_bounds] * E + esp_b,
        constraints=constraints, callback=callback,
        options={"ftol": ftol, "maxiter": maxiter})
    return np.asarray(res.x[:E]), np.asarray(res.x[E:]), res


def mrf_design_step(FA, TR, T1s, T2s, mesh=None, *, lr_fa=1.0, lr_tr=0.05,
                    **opts):
    """One projected-gradient step on (FA, TR) by autograd of
    :func:`mrf_design_loss`; returns (FA, TR, loss)."""
    _no_mesh(mesh)
    loss, gFA, gTR = _loss_and_grad(FA, TR, T1s, T2s, **opts)
    FA = torch.clamp(_real(FA) - lr_fa * gFA, *FA_BOUNDS)
    TR = torch.clamp(_real(TR) - lr_tr * gTR, *TR_BOUNDS)
    return FA, TR, loss
