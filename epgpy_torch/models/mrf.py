"""MR fingerprinting (FISP) dictionary generation, plain PyTorch.

Counterpart of ``epgpy_tpu/models/mrf.py:46-298``.  Physics per TR
(hard-pulse FISP):

    T(FA_p * B1, phi_p)  ->  E(TE)  ->  echo = F0 [* e^{-i phi_p}]
    ->  E(TR_p - TE)  ->  S(1)

``fisp_mrf_signal`` runs one atom on the full (K, 3) ladder;
``fisp_mrf_dictionary`` runs a batch of atoms on full-ladder (K, B) planes
(F+ and Z carried, F- rebuilt as the conjugate flip of F+) in a Python
loop over pulses.  It is the port's full-ladder oracle for the folded
kernel (models/cuda_fisp.py) and runs on the working device and precision
(config.py).  ``fisp_mrf_jacobian`` differentiates that program forward
(``torch.func.jvp`` with the tangent basis batched by ``vmap``): the
float64 oracle of the Jacobian kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import common, config
from ..ops.shift import shift1d
from ..ops.transition import rotation_operator

__all__ = ["fisp_mrf_signal", "fisp_mrf_dictionary", "fisp_mrf_jacobian",
           "save_dictionary", "load_dictionary"]


def _relax(states, tau, T1, T2, nstate):
    """Relaxation over `tau` ms: decay + Z0 recovery toward 1."""
    E1 = torch.exp(-tau / T1)
    E2 = torch.exp(-tau / T2)
    decay = torch.stack([E2, E2, E1]).to(states.dtype)
    states = states * decay
    states[nstate, 2] = states[nstate, 2] + (1.0 - E1)
    return states


def fisp_mrf_signal(FA, phi, TR, TE, T1, T2, B1=1.0, *, nstate: int = 10,
                    demodulate: bool = False,
                    inversion: Optional[float] = None):
    """Simulate one atom's FISP MRF fingerprint.

    FA: (P,) flip angles (deg); phi, TR, TE: scalars or (P,) (deg, ms);
    T1, T2, B1: scalars; `demodulate` multiplies each echo by
    e^{-i phi_p}; `inversion` prepends a 180*B1 pulse and this delay (ms).
    Returns (re, im), two (P,) tensors.
    """
    FA = common.to_real(FA)
    P = FA.shape[0]
    phi, TR, TE = (common.to_real(x).expand(P) for x in (phi, TR, TE))
    T1, T2, B1 = (common.to_real(x) for x in (T1, T2, B1))
    cdtype = config.complex_dtype()
    states = torch.zeros((2 * nstate + 1, 3), dtype=cdtype,
                         device=FA.device)
    states[nstate, 2] = 1.0
    if inversion is not None:
        mat = rotation_operator(180.0 * B1, 0.0)[0]
        states = torch.einsum("ij,kj->ki", mat, states)
        states = _relax(states, common.to_real(inversion), T1, T2, nstate)
    echoes = []
    for i in range(P):
        mat = rotation_operator(FA[i] * B1, phi[i])[0]
        states = torch.einsum("ij,kj->ki", mat, states)
        states = _relax(states, TE[i], T1, T2, nstate)
        echo = states[nstate, 0]
        if demodulate:
            echo = echo * torch.exp(-1j * torch.deg2rad(phi[i]))
        echoes.append(echo)
        states = _relax(states, TR[i] - TE[i], T1, T2, nstate)
        states = shift1d(states, 1)
    echoes = torch.stack(echoes)
    return echoes.real, echoes.imag


def _rotation_elems(alpha_deg, phi_deg):
    """Nine rotation coefficients for per-atom flip angles (degrees)."""
    a = torch.deg2rad(alpha_deg)
    p = torch.deg2rad(phi_deg)
    cdtype = config.complex_dtype()
    cos2, sin2 = torch.cos(a / 2) ** 2, torch.sin(a / 2) ** 2
    sin, cos = torch.sin(a), torch.cos(a)
    ep = torch.exp(1j * p)                     # e^{i phi}
    ep2 = ep * ep
    # Rz(phi) Rx(a) Rz(-phi) in the (F+, F-, Z) basis
    m00 = cos2.to(cdtype)
    m01 = ep2 * sin2
    m02 = -1j * ep * sin
    m10 = torch.conj(m01)
    m12 = 1j * torch.conj(ep) * sin
    m20 = -0.5j * torch.conj(ep) * sin
    m21 = 0.5j * ep * sin
    m22 = cos.to(cdtype)
    return (m00, m01, m02, m10, m00, m12, m20, m21, m22)


def _dictionary_program(FA, phi, TR, TE, T1s, T2s, B1s, dfs, *, nstate,
                        demodulate, inversion, normalize):
    """Batched FISP recurrence on full-ladder (K, B) planes."""
    cdtype = config.complex_dtype()
    K, B, P = 2 * nstate + 1, T1s.shape[0], FA.shape[0]
    phi = phi.expand(P)
    TR = TR.expand(P)
    var_te = TE.ndim == 1

    def te_terms(te):
        # off-resonance: F+ accumulates exp(+2i pi df tau) (reference
        # epgpy/evolution.py sign convention); F- the conjugate
        return (torch.exp(-te / T1s), torch.exp(-te / T2s),
                None if dfs is None else torch.exp(2j * math.pi * dfs * te))

    z0 = torch.zeros((K, B), dtype=cdtype, device=T1s.device)
    Fp, Fm, Z = z0, z0, z0.clone()
    Z[nstate] = 1.0
    if inversion is not None:
        m00, m01, m02, m10, m11, m12, m20, m21, m22 = _rotation_elems(
            180.0 * B1s, torch.zeros_like(B1s))
        Fp, Fm, Z = (m00 * Fp + m01 * Fm + m02 * Z,
                     m10 * Fp + m11 * Fm + m12 * Z,
                     m20 * Fp + m21 * Fm + m22 * Z)
        E1 = torch.exp(-inversion / T1s).to(cdtype)
        E2 = torch.exp(-inversion / T2s).to(cdtype)
        Fp, Fm, Z = Fp * E2, Fm * E2, Z * E1
        Z[nstate] = Z[nstate] + (1.0 - E1)
        if dfs is not None:
            # the residual transverse magnetization of an imperfect
            # (B1 != 1) inversion precesses during TI
            phs = torch.exp(2j * math.pi * dfs * inversion)
            Fp, Fm = Fp * phs, Fm * torch.conj(phs)

    const_te = None if var_te else te_terms(TE)
    echoes = []
    for i in range(P):
        # both relaxations fold into the rotation coefficients (decay is
        # k-independent, so it commutes with the shift); F- is the
        # conjugate flip of F+
        te = TE[i] if var_te else TE
        E1_te, E2_te, pe_te = te_terms(te) if var_te else const_te
        Fm = torch.conj(torch.flip(Fp, [0]))
        m00, m01, m02, m10, m11, m12, m20, m21, m22 = _rotation_elems(
            FA[i] * B1s, phi[i])
        E1b = torch.exp(-(TR[i] - te) / T1s)
        E2b = torch.exp(-(TR[i] - te) / T2s)
        cF = (E2_te * E2b).to(cdtype)
        cZ = (E1_te * E1b).to(cdtype)
        rec = ((1.0 - E1_te) * E1b + (1.0 - E1b)).to(cdtype)

        e2c = E2_te.to(cdtype)
        if pe_te is not None:
            e2c = e2c * pe_te
        echo = (m00 * Fp[nstate] + m01 * Fm[nstate] + m02 * Z[nstate]) * e2c
        if demodulate:
            echo = echo * torch.exp(-1j * torch.deg2rad(phi[i]))
        echoes.append(echo)

        cFp = cF
        if pe_te is not None:
            pe_tr = torch.exp(2j * math.pi * dfs * (TR[i] - te))
            cFp = cF * pe_te * pe_tr
        nFp = (m00 * cFp) * Fp + (m01 * cFp) * Fm + (m02 * cFp) * Z
        Z = (m20 * cZ) * Fp + (m21 * cZ) * Fm + (m22 * cZ) * Z
        Z[nstate] = Z[nstate] + rec
        Fp = torch.cat([torch.zeros_like(nFp[:1]), nFp[:-1]])
    echoes = torch.stack(echoes)                       # (P, B)
    re, im = echoes.real.T, echoes.imag.T              # (B, P)
    if normalize:
        nrm = torch.sqrt(torch.sum(re * re + im * im, dim=-1, keepdim=True))
        scale = torch.where(nrm > 0, 1.0 / nrm, torch.zeros_like(nrm))
        re, im = re * scale, im * scale
    return re, im


def fisp_mrf_dictionary(FA, TR, TE, T1s, T2s, B1s=None, dfs=None, *,
                        phi=90.0, nstate: int = 10, demodulate: bool = False,
                        inversion: Optional[float] = None,
                        normalize: bool = False):
    """Generate a FISP MRF dictionary: one fingerprint per atom.

    FA: (P,) flip-angle train (deg); TR: scalar/(P,) (ms); TE: scalar or
    (P,) (ms).  T1s, T2s, B1s: (B,) per-atom parameters (B1s defaults to
    ones); dfs: optional (B,) off-resonance (kHz) -- with `inversion`, the
    imperfect-inversion residual F+ precesses during TI too.
    Returns (re, im): (B, P) tensors on the working device and precision.
    """
    T1s = common.to_real(T1s)
    T2s = common.to_real(T2s)
    B1s = torch.ones_like(T1s) if B1s is None else common.to_real(B1s)
    dfs = None if dfs is None else common.to_real(dfs)
    return _dictionary_program(
        common.to_real(FA), common.to_real(phi), common.to_real(TR),
        common.to_real(TE), T1s, T2s, B1s, dfs, nstate=int(nstate),
        demodulate=demodulate,
        inversion=None if inversion is None else float(inversion),
        normalize=normalize)


def fisp_mrf_jacobian(FA, TR, TE, T1s, T2s, B1s=None, dfs=None, *,
                      phi=90.0, variables=("T1", "T2"), nstate: int = 10,
                      demodulate: bool = False, inversion=None):
    """Per-atom fingerprint derivatives dS/d(variables).

    Counterpart of ``epgpy_tpu/models/mrf.py:301-369``.  `variables` is a
    subset of ("T1", "T2", "B1"); `dfs` an optional (B,) off-resonance
    (kHz; not a differentiation variable).  Returns ((re, im), (dre, dim))
    with fingerprints (B, P) and derivatives (B, P, nvars).

    Atoms are independent, so dS_b/dtheta_b is a jvp of the batched
    program with an all-ones tangent on that parameter; ``vmap`` over the
    tangent basis pushes every variable through one pass.
    """
    T1s = common.to_real(T1s)
    T2s = common.to_real(T2s)
    B1s = torch.ones_like(T1s) if B1s is None else common.to_real(B1s)
    dfs = None if dfs is None else common.to_real(dfs)
    args = (common.to_real(FA), common.to_real(phi), common.to_real(TR),
            common.to_real(TE))
    kw = dict(nstate=int(nstate), demodulate=demodulate,
              inversion=None if inversion is None else float(inversion),
              normalize=False)
    idx = {"T1": 0, "T2": 1, "B1": 2}
    sel = tuple(idx[v] for v in variables)

    def f(t1, t2, b1):
        return _dictionary_program(*args, t1, t2, b1, dfs, **kw)

    ones, zeros = torch.ones_like(T1s), torch.zeros_like(T1s)

    def pushfwd(onehot):
        tangents = tuple(ones * onehot[sel.index(v)] if v in sel else zeros
                         for v in range(3))
        return torch.func.jvp(f, (T1s, T2s, B1s), tangents)[1]

    basis = torch.eye(len(sel), dtype=T1s.dtype, device=T1s.device)
    dre, dim = torch.func.vmap(pushfwd)(basis)
    return f(T1s, T2s, B1s), (dre.movedim(0, -1), dim.movedim(0, -1))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_dictionary(path, re, im, T1s, T2s, B1s=None, **meta):
    """Persist a dictionary (split-complex fingerprints + atom grid) in
    the npz layout of ``epgpy_tpu.models.mrf.save_dictionary``."""
    np.savez_compressed(
        path, re=_host(re), im=_host(im), T1s=_host(T1s), T2s=_host(T2s),
        B1s=np.ones(len(_host(T1s))) if B1s is None else _host(B1s),
        **{k: _host(v) for k, v in meta.items()})


def load_dictionary(path):
    """Load a dictionary saved by either package -> dict of numpy arrays."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
