"""MR fingerprinting (FISP) dictionary generation, plain PyTorch.

Counterpart of ``epgpy_tpu/models/mrf.py:46-298``.  Physics per TR
(hard-pulse FISP):

    T(FA_p * B1, phi_p)  ->  E(TE)  ->  echo = F0 [* e^{-i phi_p}]
    ->  E(TR_p - TE)  ->  S(1)

``fisp_mrf_signal`` runs one atom on the full (K, 3) ladder;
``fisp_mrf_dictionary`` runs a batch of atoms on the working device and
precision (config.py): on the card in float32 within the kernel's gate
through the FISP dictionary kernel's wrapper
(``models/cuda_fisp.fisp_echoes``: ``csrc/fisp_half.cu``, the full-ladder
kernel at nstate 0), otherwise -- on the CPU, in float64, past the gate --
through the port's one full-ladder program,
``models/cuda_fisp.fisp_full_ladder_plain`` (the twin of the full-ladder
kernel: real (K, B) planes of F+, F- and Z in a Python loop over pulses).
That program is the full-ladder oracle of the folded kernel; a check that
needs the oracle on the card calls it by name.
``fisp_mrf_jacobian`` differentiates that program forward
(``torch.func.jvp`` with the tangent basis batched by ``vmap``): the
float64 oracle of the Jacobian kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import common, config
from ..ops.shift import shift1d
from ..ops.transition import rotation_operator
from . import cuda_fisp
from .cuda_fisp import fisp_full_ladder_plain

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
        # a (1,) slice, not a 0-d element: forward-mode AD through a 0-d
        # complex64 tensor times a Python scalar gives complex128 tangents
        # (the FA-train CRLB differentiates this flip in float32)
        mat = rotation_operator(FA[i:i + 1] * B1, phi[i:i + 1])[0]
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


def fisp_mrf_dictionary(FA, TR, TE, T1s, T2s, B1s=None, dfs=None, *,
                        phi=90.0, nstate: int = 10, demodulate: bool = False,
                        inversion: Optional[float] = None,
                        normalize: bool = False, sharding=None):
    """Generate a FISP MRF dictionary: one fingerprint per atom.

    FA: (P,) flip-angle train (deg); TR: scalar/(P,) (ms); TE: scalar or
    (P,) (ms).  T1s, T2s, B1s: (B,) per-atom parameters (B1s defaults to
    ones); dfs: optional (B,) off-resonance (kHz) -- with `inversion`, the
    imperfect-inversion residual F+ precesses during TI too.
    ``sharding``: optional ``parallel.atom_sharding(mesh)``: the atoms
    split over the mesh axis, each shard built on its entry's device by
    the route below, the result gathered on the mesh's first device.
    Returns (re, im): (B, P) tensors on the working device and precision
    (transposed views of the kernel's (P, B) echoes on the card).

    A CUDA float32 batch runs the FISP dictionary kernel, which raises
    past its shared-memory gate; a float64 batch, on the card too, and a
    CPU batch run the full-ladder program (the kernel computes in float32
    only, and the float64 program is the card's float64 reference).
    """
    T1s = common.to_real(T1s)
    T2s = common.to_real(T2s)
    B1s = torch.ones_like(T1s) if B1s is None else common.to_real(B1s)
    dfs = None if dfs is None else common.to_real(dfs)
    if sharding is not None:
        from ..parallel.mesh import shard_map

        def build(t1, t2, b1, df):
            return fisp_mrf_dictionary(
                FA, TR, TE, t1, t2, b1, df, phi=phi, nstate=nstate,
                demodulate=demodulate, inversion=inversion,
                normalize=normalize)

        return shard_map(build, sharding.mesh,
                         [(T1s, 0), (T2s, 0), (B1s, 0), (dfs, 0)],
                         axis=sharding.axis)
    args = [common.to_real(x) for x in (FA, phi, TR, TE)]
    kw = dict(nstate=int(nstate), demodulate=demodulate,
              inversion=None if inversion is None else float(inversion))
    if T1s.device.type == "cuda" and T1s.dtype == torch.float32:
        # a host scalar TE stays a host number: the wrapper would read a
        # 0-d tensor back to the host
        te = (float(TE) if not isinstance(TE, torch.Tensor)
              and np.ndim(TE) == 0 else args[3].contiguous())
        re, im = cuda_fisp.fisp_echoes(
            *(x.contiguous() for x in args[:3]), te,
            *(x.contiguous() for x in (T1s, T2s, B1s)),
            None if dfs is None else dfs.contiguous(), **kw)
        return cuda_fisp._finish(re, im, normalize)
    return fisp_full_ladder_plain(*args, T1s, T2s, B1s, dfs,
                                  normalize=normalize, **kw)


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
        return fisp_full_ladder_plain(*args, t1, t2, b1, dfs, **kw)

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
