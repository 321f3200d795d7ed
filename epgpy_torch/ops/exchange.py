"""Compartment exchange / magnetization transfer (EPG-X).

Counterpart of ``epgpy_tpu/ops/exchange.py`` (Van Landeghem 2010).  N
exchanging compartments live on a chosen batch axis of the state matrix.
The coupled relaxation-exchange evolution over `tau` is the matrix
exponential of the kinetic matrix:

    xT = -khi + (-1/T2 + 2 i pi g) I      (transverse)
    xL = -khi + (-1/T1) I                 (longitudinal)
    m* = expm(x* tau)

applied across the compartment axis to ``states - equilibrium`` (the
equilibrium is re-added afterwards, so T1 recovery and exchange of the
equilibrium magnetization are handled jointly).  Two compartments use the
closed-form 2x2 spectral exponential :func:`_expm2`; more use
``torch.linalg.matrix_exp``.

Parameters stay host values until the op is applied (the dispatch reads
them); tensors pass through, so the diff layer's epsilon substitution
differentiates every parameter, the kinetic matrix included
(``order1={"k": {"khi": kron}}``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import common, config
from . import base

__all__ = ["X", "exchange_matrix", "exchange_operator",
           "PrecomputedExchange", "precompute_exchange"]


def exchange_matrix(k, *, axis=-1, ncomp=2, densities=None):
    """Kinetic matrix from scalar rate(s): columns sum to zero.

    k: exchange rate(s) (1/ms); returns (..., ncomp, ..., ncomp) with the
    first new axis inserted at `axis` (host-side numpy).
    """
    k = np.asarray(k, dtype=float)
    if np.any(k < 0):
        raise ValueError("Cannot have negative exchange rate")
    if axis > k.ndim:
        k = k.reshape(k.shape + (1,) * (axis - k.ndim))
    axis = (k.ndim + axis + 1) if axis < 0 else axis
    kron = np.eye(ncomp) + (np.eye(ncomp) - 1) / (ncomp - 1)
    if densities is not None:
        kron = kron / np.asarray(densities)
    return np.moveaxis(k[..., None, None] * kron, -2, axis)


def _real(x, default=None):
    """A parameter as a real tensor of the working precision on the
    working device (tensors keep their autodiff wrappers)."""
    x = default if x is None else x
    if isinstance(x, torch.Tensor):
        return x.to(device=config.device(), dtype=config.real_dtype())
    return torch.as_tensor(np.asarray(x, dtype=float),
                           dtype=config.real_dtype(), device=config.device())


def exchange_operator(tau, khi, *, axis=0, T1=None, T2=None, g=None):
    """The (..., ncomp@axis, ncomp@axis+1, ..., 3) mixing matrix: (mT,
    conj(mT), mL) stacked last.

    khi: (..., ncomp[axis], ..., ncomp) kinetic matrix; tau ms; T1/T2 ms;
    g kHz (arrays broadcast over the remaining axes, compartment values on
    `axis`, append rule).
    """
    cdt = config.complex_dtype()
    khi = _real(khi)
    tau = _real(tau)
    T1, T2, g = _real(T1, math.inf), _real(T2, math.inf), _real(g, 0.0)

    ncomp = khi.shape[-1]
    eye = torch.eye(ncomp, dtype=khi.dtype, device=khi.device)

    # broadcast shapes (append rule), compartment axis -> last
    minshape = tuple(khi.shape[:-1])
    shape = _broadcast_rev(tau.shape, T1.shape, T2.shape, g.shape, minshape)
    ndim = len(shape)
    tau, T1, T2, g = (_expand_to(a, ndim) for a in (tau, T1, T2, g))
    T1, T2, g = (a.expand(shape) for a in (T1, T2, g))
    # khi's compartment ROW axis sits at `axis` within its leading block
    # (columns appended last): move rows next to the columns so the
    # matrix block is (..., C, C), then right-pad batch dims to the common
    # layout (the append rule, not numpy's left-prepend)
    rows = axis if axis >= 0 else khi.ndim - 1 + axis
    khi = torch.movedim(khi, rows, -2)
    pad = (ndim - 1) - (khi.ndim - 2)
    if pad > 0:
        khi = khi.reshape(khi.shape[:-2] + (1,) * pad + khi.shape[-2:])
    tau, T1, T2, g = (torch.movedim(a, axis, -1) for a in (tau, T1, T2, g))

    xT = -khi.to(cdt) + ((-1.0 / T2 + 2j * math.pi * g).to(cdt))[..., None] \
        * eye
    xL = -khi.to(cdt) + ((-1.0 / T1).to(cdt))[..., None] * eye

    mT = _expm(xT * tau[..., None].to(cdt))
    mL = _expm(xL * tau[..., None].to(cdt))

    mT = torch.movedim(mT, (-2, -1), (axis, axis + 1))
    mL = torch.movedim(mL, (-2, -1), (axis, axis + 1))
    return torch.stack([mT, torch.conj(mT), mL], dim=-1)


def _expm2(m):
    """Closed-form 2x2 matrix exponential (spectral formula).

    expm(A) = e^mu [cosh(D) I + sinh(D)/D (A - mu I)] with mu = tr/2 and
    D^2 = (a-d)^2/4 + bc.  The exponents mu +- D are combined BEFORE
    exponentiation, so huge negative rates (T1 -> 0 limiting cases,
    near-infinite exchange) underflow cleanly to 0 instead of producing
    inf/inf = NaN.  Near degenerate eigenvalues the series form of
    cosh(D) and sinh(D)/D takes over (division-free; truncation error
    ~ |D|^8/8!), with an absolute cap on the switch so pairs with a large
    common magnitude (both pools at kHz off-resonance) stay on the exact
    spectral formula.
    """
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    mu = (a + d) / 2
    delta = torch.sqrt(((a - d) / 2) ** 2 + b * c)
    l1, l2 = mu + delta, mu - delta
    # the smaller-magnitude eigenvalue suffers catastrophic cancellation
    # when |mu| ~ |delta| (one fast, one slow rate): recover it from the
    # determinant product l1 * l2 = det(A)
    det = a * d - b * c
    big = torch.where(l1.abs() >= l2.abs(), l1, l2)
    big_safe = torch.where(big == 0, torch.ones_like(big), big)
    la = big
    lb = torch.where(big == 0, l2, det / big_safe)
    diff = la - lb
    degen = diff.abs() <= torch.clamp(
        0.04 * (1.0 + la.abs() + lb.abs()), max=0.5)
    safe = torch.where(degen, torch.ones_like(diff), diff)
    ea, eb = torch.exp(la), torch.exp(lb)
    # spectral form: expm = (ea (A - lb I) - eb (A - la I)) / (la - lb)
    e00 = (ea * (a - lb) - eb * (a - la)) / safe
    e01 = (ea - eb) * b / safe
    e10 = (ea - eb) * c / safe
    e11 = (ea * (d - lb) - eb * (d - la)) / safe
    # near-degenerate: expm = e^mu (cosh(D) I + sinh(D)/D (A - mu I))
    # with D^2 = ((a-d)/2)^2 + bc (no cancelled subtraction)
    D2 = ((a - d) / 2) ** 2 + b * c
    coshD = 1.0 + D2 / 2 * (1.0 + D2 / 12 * (1.0 + D2 / 30))
    sinhc = 1.0 + D2 / 6 * (1.0 + D2 / 20 * (1.0 + D2 / 42))
    emu = torch.exp(mu)
    e00 = torch.where(degen, emu * (coshD + sinhc * (a - mu)), e00)
    e01 = torch.where(degen, emu * sinhc * b, e01)
    e10 = torch.where(degen, emu * sinhc * c, e10)
    e11 = torch.where(degen, emu * (coshD + sinhc * (d - mu)), e11)
    row0 = torch.stack([e00, e01], dim=-1)
    row1 = torch.stack([e10, e11], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _expm(mat):
    """Batched matrix exponential: closed form for 2 compartments,
    ``torch.linalg.matrix_exp`` (scaling and squaring) otherwise."""
    if mat.shape[-1] == 2:
        return _expm2(mat)
    return torch.linalg.matrix_exp(mat)


def _broadcast_rev(*shapes):
    """Append-rule broadcast (shapes aligned on their leading axes)."""
    rev = [tuple(s)[::-1] for s in shapes]
    return np.broadcast_shapes(*rev)[::-1]


def _expand_to(arr, ndim):
    return arr.reshape(tuple(arr.shape) + (1,) * (ndim - arr.ndim))


class X(base.DiffOperator):
    """Exchange operator: couples compartments along a batch axis.

    Args:
        tau: mixing time (ms).
        khi: scalar exchange rate (1/ms, 2 compartments assumed) or a full
            kinetic matrix (columns sum to 0 along `axis`).
        axis: compartment batch axis of the state matrix.
        T1, T2, g: per-compartment relaxation/shift (arrays on `axis`).

    Every parameter is differentiable through the diff layer's epsilon
    substitution.  Fit-relevant directions are structured perturbations
    given as array chain-rule coefficients, e.g. ``order1={"k": {"khi":
    kron}}`` (d khi / dk for a rate k with khi = k kron) or
    ``order1={"T2f": {"T2": e0}}`` (the free-pool T2, e0 the compartment-0
    one-hot).
    """

    PARAMS = ("tau", "khi", "T1", "T2", "g")
    PARAMETERS_ORDER1 = frozenset({"tau", "khi", "T1", "T2", "g"})

    def __init__(self, tau, khi, *, axis=-1, T1=None, T2=None, g=None,
                 name=None, duration=None, order1=False, order2=False):
        if np.isscalar(khi):
            khi = exchange_matrix(khi, axis=axis, ncomp=2)
        else:
            khi = np.asarray(khi, dtype=float)
            if khi.ndim < 2:
                raise ValueError("Exchange matrix must be at least 2D")
            if khi.shape[:-1][axis] != khi.shape[-1]:
                raise ValueError("Exchange matrix must be square")
            colsums = [np.abs(khi[..., i].sum(axis=axis)).max()
                       for i in range(khi.shape[-1])]
            if not np.allclose(colsums, 0):
                raise ValueError(f"Exchange matrix must sum to 0 along axis "
                                 f"{axis}")
        self.axis = int(khi.ndim + axis - 1) if axis < 0 else int(axis)
        self.khi = khi
        self.tau = common.as_real(tau)
        self.T1, self.T2, self.g = (common.as_real(x) for x in (T1, T2, g))
        if duration is True:
            duration = tau
        super().__init__(name=name or f"X({tau})", duration=duration,
                         order1=order1, order2=order2)

    @property
    def shape(self):
        # the mixing matrix inserts the j-compartment axis at axis+1
        # (exchange_operator's final movedim); the op's batch shape is the
        # matrix shape minus that axis.  Reproduce the movedim on a
        # zero-strided dummy so the drop applies to the MATRIX layout, not
        # the parameter layout (batch axes after the compartment axis
        # would otherwise lose an innocent axis)
        ps = self._matshape()
        C = self.khi.shape[-1]
        ax = self.axis
        axn = ax % len(ps)
        rest = tuple(d for i, d in enumerate(ps) if i != axn)
        dummy = np.broadcast_to(0.0, rest + (C, C))
        mshape = np.moveaxis(dummy, (-2, -1), (ax, ax + 1)).shape
        return tuple(d for i, d in enumerate(mshape) if i != (ax + 1))

    def _matshape(self):
        return _broadcast_rev(
            common.get_shape(self.tau), common.get_shape(self.T1),
            common.get_shape(self.T2), common.get_shape(self.g),
            tuple(self.khi.shape[:-1]))

    def apply(self, sm):
        ax = self.axis
        mat = exchange_operator(self.tau, self.khi, axis=ax, T1=self.T1,
                                T2=self.T2, g=self.g)
        if isinstance(self.khi, np.ndarray):
            _check_conservation(self.khi, sm, ax, mat.shape[ax])
        return _apply_exchange(sm, mat, ax)


def _check_conservation(khi, sm, ax, ncomp):
    """Raise unless ``khi`` conserves the state's density-weighted total
    (a host check; a substituted, differentiated khi skips it).  Batch
    elements pair under the append rule: per-atom khi each conserving its
    own atom's density passes."""
    dens = sm.density.detach().cpu().numpy().real
    if dens.ndim:
        dens_b = np.broadcast_to(
            dens.reshape(dens.shape + (1,) * (len(sm.shape) - dens.ndim)),
            sm.shape)
    else:
        dens_b = dens
    if not (np.ndim(dens_b) > ax and np.shape(dens_b)[ax] == ncomp):
        return
    rows = ax if ax >= 0 else khi.ndim - 1 + ax
    khi_a = np.moveaxis(khi, rows, -2)
    dens_m = np.moveaxis(dens_b, ax, -1)
    kb, db = khi_a.shape[:-2], dens_m.shape[:-1]
    n = max(len(kb), len(db))
    khi_a = khi_a.reshape(kb + (1,) * (n - len(kb)) + khi_a.shape[-2:])
    dens_m = dens_m.reshape(db + (1,) * (n - len(db)) + dens_m.shape[-1:])
    tot = np.sum(khi_a * dens_m[..., None, :], axis=-1)
    if not np.allclose(tot, 0, atol=1e-8):
        raise RuntimeError("Exchange matrix `khi` does not conserve total "
                           "magnetization")


def _apply_exchange(sm, mat, ax, linear=False):
    """Apply the (..., ncomp@ax, ncomp@ax+1, ..., 3) mixing matrix to
    ``states - equilibrium`` and re-add the equilibrium (``linear``: the
    product alone, a tensor)."""
    ncomp = mat.shape[ax]
    states = sm.states
    eq = sm.equilibrium.to(states.dtype)
    if eq.ndim < states.ndim:
        # append rule: new batch axes pad on the RIGHT of the
        # equilibrium's batch dims (the trailing (K, 3) stay state dims)
        eq = eq.reshape(eq.shape[:-2] + (1,) * (states.ndim - eq.ndim)
                        + eq.shape[-2:])
    if states.shape[ax] == 1 and ncomp > 1:
        states = torch.cat([states] * ncomp, dim=ax)
    elif states.shape[ax] != ncomp:
        raise RuntimeError(f"State matrix axis {ax} has size "
                           f"{states.shape[ax]}, expected {ncomp} "
                           f"compartments")
    eq = torch.broadcast_to(eq, states.shape)
    # contract the matrix's j-compartment axis (ax+1) with the states'
    # compartment axis, moved to ax+1 by the unsqueeze at ax
    dev = (states - eq).unsqueeze(ax)
    need = dev.ndim - mat.ndim
    mat_e = mat.reshape(mat.shape[:-1] + (1,) * max(need, 0)
                        + mat.shape[-1:])
    new = torch.sum(torch.movedim(mat_e, ax + 1, -1)
                    * torch.movedim(dev, ax + 1, -1), dim=-1)
    if linear:
        return new
    return sm.update(states=new + torch.broadcast_to(eq, new.shape))


class PrecomputedExchange(base.Operator):
    """Exchange op with its mixing matrix computed once: applying it skips
    the matrix exponential (a train that reuses one X instance every TR
    pays it once)."""

    PARAMS = ("mat",)

    def __init__(self, mat, axis=0, name=None, **kwargs):
        self.mat = mat
        self.axis = int(axis)
        super().__init__(name=name or "PrecomputedExchange", **kwargs)

    @property
    def shape(self):
        mshape = tuple(self.mat.shape[:-1])
        return tuple(d for i, d in enumerate(mshape) if i != self.axis + 1)

    def apply(self, sm):
        return _apply_exchange(sm, self.mat.to(sm.states.dtype), self.axis)


def precompute_exchange(op):
    """A PrecomputedExchange of a host X op (None for an op with tensor
    parameters or derivative specs)."""
    leaves = (op.tau, op.khi, op.T1, op.T2, op.g)
    if op.order1 or any(isinstance(x, torch.Tensor) for x in leaves):
        return None
    mat = exchange_operator(op.tau, op.khi, axis=op.axis, T1=op.T1,
                            T2=op.T2, g=op.g)
    return PrecomputedExchange(mat, axis=op.axis, duration=op.duration)
