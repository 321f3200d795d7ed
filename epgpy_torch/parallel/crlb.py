"""CRLB sequence design: the MRF flip-angle train (FA-only, and FA and
TR), and the variable-flip TSE (CPMG) train.

Counterpart of ``epgpy_tpu/parallel/crlb.py``.  The FA-only design
(``fingerprint_crlb_loss``, ``crlb_train_step``) is the mesh layout's
"training step": the mean CRLB of (T1, T2) in log space over an atom grid
whose atoms split over the mesh's ``atoms`` axis, plus, where the mesh
has a ``tangents`` axis, the CRLB over the per-pulse flip angles, whose
wide ``jacfwd`` runs with its tangent (column) axis split over that axis
and gathered for the Fisher product (the compiled form of the reference's
commented-out multiprocessing split of derivative pairs, epgpy/
functions.py:195-248).

The MRF half is the reference workflow examples/sequence/optim_mrf.py:
choose the per-pulse flip angles FA_i and repetition times TR_i of a 5-op
FISP train after an inversion to minimize the mean Cramer-Rao lower bound
of (magnitude, T1, T2) over an atom grid, under the box bounds FA in
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

Every function takes a mesh (``parallel.make_mesh``): each atom shard
computes its own mean on its entry, and the loss and gradient are the
mean of the shards' means (JAX's ``pmean``) on the mesh's first device;
reverse mode runs through the gather.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config, stats
from ..models.cuda_hessian import fisp_hessian_cuda
from ..models.cuda_msedesign import cpmg_design_cuda
from ..models.mrf import fisp_mrf_signal
from .mesh import on_entry, pmean, shard_map

__all__ = ["fingerprint_crlb_loss", "crlb_train_step", "FA_BOUNDS",
           "TR_BOUNDS", "mrf_design_loss", "mrf_design_loss_grad_fused",
           "mrf_design_slsqp", "mrf_design_step",
           "mse_design_loss_grad_fused", "tse_design_slsqp"]

FA_BOUNDS = (10.0, 60.0)
TR_BOUNDS = (11.0, 16.0)


def _real(x):
    """A tensor as it is; a host value on the working device and dtype."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float64),
                           dtype=config.real_dtype(), device=config.device())


def _atom_mean(local, mesh, T1s, T2s, *replicated):
    """``local(T1s, T2s, *replicated)`` (a per-atom mean, or a tuple of
    them); under a mesh, the mean of its values over the atom shards
    (``pmean`` over ``atoms``), each shard's computed on its entry."""
    if mesh is None:
        return local(T1s, T2s, *replicated)
    means = shard_map(local, mesh, [(T1s, 0), (T2s, 0)],
                      replicated=replicated, out_dim=None)
    if isinstance(means[0], tuple):
        return tuple(pmean(list(m), mesh) for m in zip(*means))
    return pmean(means, mesh)


# -- the FA-only train: (T1, T2) in log space, the FA train on tangents --


def _atom_signal_ri(FA, T1, T2, *, TR, TE, nstate):
    """One atom's fingerprint as a (P, 2) real tensor (re, im columns)."""
    re, im = fisp_mrf_signal(FA, 90.0, TR, TE, T1, T2, 1.0, nstate=nstate)
    return torch.stack([re, im], dim=-1)


def _trace_inv_fisher(J, ridge):
    """tr(inv(J^T J + ridge I)) of (..., n, nvars) Jacobians."""
    eye = torch.eye(J.shape[-1], dtype=J.dtype, device=J.device)
    fisher = J.mT @ J + ridge * eye
    return torch.diagonal(torch.linalg.inv(fisher), dim1=-2,
                          dim2=-1).sum(-1)


def _crlb_t1t2(FA, T1, T2, *, TR, TE, nstate, ridge):
    """CRLB of (T1, T2) for one atom (relative parametrization)."""
    def f(logt1, logt2):
        return _atom_signal_ri(FA, torch.exp(logt1), torch.exp(logt2),
                               TR=TR, TE=TE, nstate=nstate)

    J = torch.stack(torch.func.jacfwd(f, argnums=(0, 1))(
        torch.log(T1), torch.log(T2)), dim=-1)          # (P, 2, 2)
    return _trace_inv_fisher(J.reshape(-1, 2), ridge)


def _crlb_fa_block(FA, T1s, T2s, devices, *, TR, TE, nstate, ridge):
    """CRLB over the per-pulse FA variables of each atom of (T1s, T2s),
    the tangent axis split over the `devices` of the ``tangents`` axis.

    Tangent shard k seeds ``jacfwd`` with its chunk of the FA basis only,
    on its device; the Fisher product needs every column, so the blocks
    are gathered (concatenated) on the atoms' device.  The chunks are
    ceil-divided and zero-padded so that any train length works on any
    axis size: the pad columns are derivatives with respect to dummy
    parameters (zero by construction), trimmed after the gather."""
    P = FA.shape[0]
    chunk = -(-P // len(devices))
    pad = chunk * len(devices) - P
    FAp = torch.cat([FA, FA.new_zeros(pad)]) if pad else FA
    home = T1s.device
    blocks = []
    for k, dev in enumerate(devices):
        fa, t1s, t2s = (x.to(dev) for x in (FAp, T1s, T2s))
        start = k * chunk

        def atom(t1, t2):
            def f(fa_chunk):
                fa2 = torch.cat([fa[:start], fa_chunk, fa[start + chunk:]])
                return _atom_signal_ri(fa2[:P], t1, t2, TR=TR, TE=TE,
                                       nstate=nstate)

            return torch.func.jacfwd(f)(fa[start:start + chunk])

        with on_entry(dev):
            blocks.append(torch.func.vmap(atom)(t1s, t2s).to(home))
    J = torch.cat(blocks, dim=-1)[..., :P]               # (B, P, 2, P)
    return _trace_inv_fisher(J.reshape(J.shape[0], -1, P), ridge)


def fingerprint_crlb_loss(FA, T1s, T2s, mesh, *, TR=12.0, TE=5.0,
                          nstate=6, ridge=1e-6, fa_weight=1e-3):
    """Mean CRLB over the (sharded) atom grid; FA replicated.

    loss = mean_atoms CRLB_{T1,T2} + fa_weight * mean_atoms CRLB_{FA train}

    The FA-train term is computed only where the mesh has a ``tangents``
    axis (and ``fa_weight`` is non-zero), its tangent axis split over it;
    without one it is left out, as in the JAX function.  Returns a 0-d
    tensor on the mesh's first device."""
    FA, T1s, T2s = (_real(x) for x in (FA, T1s, T2s))
    tangents = "tangents" in mesh.axis_names and bool(fa_weight)

    def local(i, t1s, t2s, fa):
        loss = torch.mean(torch.func.vmap(lambda t1, t2: _crlb_t1t2(
            fa, t1, t2, TR=TR, TE=TE, nstate=nstate, ridge=ridge))(t1s,
                                                                  t2s))
        if tangents:
            row = mesh.entries("tangents", at={"atoms": i})
            loss = loss + fa_weight * torch.mean(_crlb_fa_block(
                fa, t1s, t2s, row, TR=TR, TE=TE, nstate=nstate,
                ridge=ridge))
        return loss

    return pmean(shard_map(local, mesh, [(T1s, 0), (T2s, 0)],
                           replicated=(FA,), out_dim=None, index=True),
                 mesh)


def crlb_train_step(FA, T1s, T2s, mesh, *, lr=0.5, **opts):
    """One gradient-descent step on the flip-angle train: reverse mode
    through :func:`fingerprint_crlb_loss` (its ``jacfwd`` blocks and the
    gathers included).  Returns (new FA, loss)."""
    fa = _real(FA).detach().clone().requires_grad_(True)
    loss = fingerprint_crlb_loss(fa, T1s, T2s, mesh, **opts)
    (grad,) = torch.autograd.grad(loss, (fa,))
    return fa.detach() - lr * grad.to(fa.device), loss.detach()


# -- reference-scale constrained design: FA + TR, 2N free parameters --


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
    FA, TR, T1s, T2s = (_real(x) for x in (FA, TR, T1s, T2s))

    def local(t1s, t2s, fa, tr):
        return torch.mean(torch.func.vmap(lambda t1, t2: _atom_crlb_mt1t2(
            fa, tr, t1, t2, TE=TE, nstate=nstate, inversion=inversion,
            sigma2=sigma2, ridge=ridge))(t1s, t2s))

    loss = _atom_mean(local, mesh, T1s, T2s, FA, TR)
    FA = FA.to(loss.device)
    if smooth_weight:
        excess = torch.clamp(torch.abs(torch.diff(FA)) - 1.0, min=0.0)
        loss = loss + smooth_weight * torch.sum(excess**2)
    return loss


def _loss_and_grad(FA, TR, T1s, T2s, mesh=None, **opts):
    """(loss, gFA, gTR) of :func:`mrf_design_loss` by reverse mode."""
    fa = _real(FA).detach().clone().requires_grad_(True)
    tr = _real(TR).detach().clone().requires_grad_(True)
    loss = mrf_design_loss(fa, tr, T1s, T2s, mesh, **opts)
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
    T1s = _real(T1s)
    T2s, FA, TR = (_real(x).to(T1s) for x in (T2s, FA, TR))
    N = FA.shape[0]

    def local(t1s, t2s, fa, tr):
        out = fisp_hessian_cuda(fa, 90.0, tr - TE, t1s, t2s, te=TE,
                                inversion=inversion, nstate=nstate)
        cols = ("sig", "dT1", "dT2")
        J = torch.complex(torch.stack([out[k][0] for k in cols], -1),
                          torch.stack([out[k][1] for k in cols], -1))
        # H (B, N_echo, 3, 2N): rows (mag, T1, T2), columns (alpha_i, tau_i)
        cplx = torch.complex64 if t1s.dtype == torch.float32 \
            else torch.complex128
        H = torch.empty(J.shape[:2] + (3, 2 * N), dtype=cplx,
                        device=J.device)
        Hv = torch.view_as_real(H)
        for r, pre in enumerate(("d", "dT1d", "dT2d")):
            for half, name in enumerate(("alpha", "tau")):
                for ri in (0, 1):
                    Hv[:, :, r, half * N:(half + 1) * N, ri] = \
                        out[pre + name][ri]
        w = torch.stack([torch.ones_like(t1s), 1.0 / t1s**2, 1.0 / t2s**2],
                        -1)
        cost, grad = stats.crlb(J, H, W=w, sigma2=sigma2)
        return torch.mean(cost), torch.mean(grad, dim=0)

    loss, grad = _atom_mean(local, mesh, T1s, T2s, FA, TR)
    FA = FA.to(loss.device)
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

    nTR = len(FA0)
    if engine == "fused":
        opts.pop("ridge", None)
        T1f = _real(T1s).to(torch.float32)
        T2f = _real(T2s).to(T1f)

        def val_grad(fa, tr):
            return mrf_design_loss_grad_fused(
                torch.as_tensor(fa, dtype=torch.float32, device=T1f.device),
                torch.as_tensor(tr, dtype=torch.float32, device=T1f.device),
                T1f, T2f, mesh, **opts)
    elif engine == "scan":
        def val_grad(fa, tr):
            return _loss_and_grad(fa, tr, T1s, T2s, mesh, **opts)
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
    T1s = torch.atleast_1d(_real(T1s))
    T2s, FA, ESP = (_real(x).to(T1s) for x in (T2s, FA, ESP))
    T1s, T2s = torch.broadcast_tensors(T1s, torch.atleast_1d(T2s))
    E = FA.shape[0]

    def local(t1s, t2s, fa, esp):
        out = cpmg_design_cuda(exc, fa, 0.0, esp, t1s, t2s,
                               nstate=2 * E if nstate is None else nstate,
                               second_order=True)

        def c(key):
            return torch.complex(*out[key])

        cols = [c("sig"), c("dT2")]
        rows = [torch.cat([c("dalpha"), c("desp")], -1),
                torch.cat([c("dT2dalpha"), c("dT2desp")], -1)]
        ws = [torch.ones_like(t1s), 1.0 / t2s**2]
        if include_t1:
            cols.insert(1, c("dT1"))
            rows.insert(1, torch.cat([c("dT1dalpha"), c("dT1desp")], -1))
            ws.insert(1, 1.0 / t1s**2)
        J = torch.stack(cols, -1)                   # (B, E, nv)
        H = torch.stack(rows, -2)                   # (B, E, nv, 2E)
        cost, grad = stats.crlb(J, H, W=torch.stack(ws, -1), sigma2=sigma2)
        return torch.mean(cost), torch.mean(grad, dim=0)

    loss, grad = _atom_mean(local, mesh, T1s, T2s, FA, ESP)
    return loss, grad[:E], grad[E:]


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

    E = len(FA0)
    T1d = _real(T1s)
    if T1d.is_cuda:
        T1d = T1d.to(torch.float32)
    T2d = _real(T2s).to(T1d)

    def costjac(x):
        v, gfa, gesp = mse_design_loss_grad_fused(
            torch.as_tensor(x[:E], dtype=T1d.dtype, device=T1d.device),
            torch.as_tensor(x[E:], dtype=T1d.dtype, device=T1d.device),
            T1d, T2d, mesh, **opts)
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
    loss, gFA, gTR = _loss_and_grad(FA, TR, T1s, T2s, mesh, **opts)
    FA = torch.clamp(_real(FA).to(gFA.device) - lr_fa * gFA, *FA_BOUNDS)
    TR = torch.clamp(_real(TR).to(gTR.device) - lr_tr * gTR, *TR_BOUNDS)
    return FA, TR, loss
