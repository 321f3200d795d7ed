"""Composite-GRE stage trains and their Jacobian: CUDA kernels, plain twins.

Counterpart of ``epgpy_tpu/models/pallas_composite.py``: ``composite_pallas``
(:274) with its kernel ``_kernel_comp`` (:69) and
``composite_jacobian_pallas`` (:579) with ``_kernel_comp_jac`` (:364).  A
stage is ``[T?, E*, Adc?, E*, S(+-1)?, D?]``, given by ten per-stage tables:
flip FA and phase phi (degrees), the relaxation before and after the
readout ta and tb (ms), the output row adci (-1: no readout), the shift
direction in {-1, 0, +1}, the ADC phase aph (radians), the B1 sensitivity
b1u (0: an adiabatic pulse, the nominal angle for every atom) and, with
``diffusion=(btd, rdir, Dc)``, the b-value base per squared state index and
the ramp direction of a closing D op.  Segmented and prepared trains --
MPRAGE, cardiac MRF with IR and T2prep preps, saturation recovery -- are
such trains (``fisp_dispatch.match_composite`` builds the tables).

The kernels are ``epgpy_torch/csrc/composite.cu`` and ``composite_jac.cu``
(see their headers for the design; the primal kernel runs the segmented
layout with blocked rows of ``fisp_half.cu``, its launch geometry
``comp_geometry``; the Jacobian kernel runs the segmented layout of
``fisp_jac.cu``, its launch geometry ``comp_jac_geometry``);
``composite_plain`` / ``composite_jacobian_plain`` are the same recurrences with the same
operation order, vectorised over atoms as (6, nstate+1, B) planes in a
Python loop over stages, in any precision, on the tensors' device.  The
Jacobian propagates only the tangent groups asked for, in the canonical
order ``COMP_JAC_GROUPS``; the df group is exact at df = 0.

``composite_cuda`` / ``composite_jacobian_cuda`` launch the kernels and
raise on CPU tensors and on what the kernels do not take;
``composite_echoes`` / ``composite_jacobian_echoes`` take the kernel for
CUDA tensors and the twin for CPU tensors (what the dispatch calls).
``LAUNCHES`` / ``JAC_LAUNCHES`` count kernel launches.  The TPU-only knobs
(``btile``, ``interpret``) and the padding have no counterpart; the
``has_*`` flags are derived on the host when None, as in ``_comp_setup``
(:212-271).  Output rows no stage's adci names are left unwritten: the
matcher's adci is a permutation of 0..nadc-1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import planes
from .cuda_dess import _fmul
from .cuda_fisp import (SMEM_PER_BLOCK, _takes_twin, half_rows, kernel_fits,
                        seg_geometry)

__all__ = ["composite_cuda", "composite_plain", "composite_echoes",
           "composite_jacobian_cuda", "composite_jacobian_plain",
           "composite_jacobian_echoes", "composite_kernel_fits",
           "composite_jac_kernel_fits", "COMP_JAC_GROUPS", "LAUNCHES",
           "JAC_LAUNCHES", "comp_geometry",
           "composite_jacobian_cuda_sharded"]

#: primal kernel launches so far (diagnostics: proves a run went through it)
LAUNCHES = 0
#: Jacobian kernel launches so far
JAC_LAUNCHES = 0

#: the Jacobian's tangent groups in their canonical order
COMP_JAC_GROUPS = ("T1", "T2", "B1", "df")

_DEG = math.pi / 180.0
_TWO_PI = 2 * math.pi


def composite_kernel_fits(nstate) -> bool:
    """The primal kernel's gate: while 6 planes of nstate + 1 rows of 32
    atoms fit one block's shared memory, nstate <= 301 -- the bound of the
    thread-per-atom layout.  The segmented kernel keeps its planes in
    registers (:func:`comp_geometry`) and keeps this gate, so that no
    train changes route."""
    return kernel_fits(int(nstate))


#: table floats per stage of the primal kernel (its kTab)
COMP_TABLE = 16


def comp_geometry(nstate):
    """Launch geometry of the segmented primal kernel (``composite.cu``):
    ``cuda_fisp.seg_geometry`` at ``cuda_fisp.half_rows`` (one lane of 12
    rows at the cardiac MRF's nstate 10, of 10 at MPRAGE's 8, 1 row at
    nstate 0), each atom staging its echo (re, im) per stage beside
    COMP_TABLE table floats -- dict(R, W, L) (lane r of a segment owns rows
    r R + c, c < R), ``warps`` per block, ``atoms`` per block, ``pulses``
    (stages) per chunk and ``smem``.  The wrapper passes R, warps and
    stages to the kernel, which checks them."""
    return seg_geometry(nstate, 2, COMP_TABLE, half_rows(nstate))


def _jac_bytes(nstate, ngroups, block):
    return 4 * 6 * (1 + int(ngroups)) * (int(nstate) + 1) * block


def composite_jac_kernel_fits(nstate, ngroups) -> bool:
    """The Jacobian kernel's gate: nstate <= 59 with all four groups, 74
    with three, 99 with two, 150 with one, 301 with none, where the
    thread-per-atom layout's 6 (1 + ngroups) planes fitted 32 atoms in one
    block's shared memory.  The segmented kernel keeps its state in
    registers (:func:`comp_jac_geometry`) and keeps this gate, so that no
    train changes route."""
    return _jac_bytes(nstate, ngroups, 32) <= SMEM_PER_BLOCK


#: table floats per stage of the Jacobian kernel (its kTab)
COMP_JAC_TABLE = 16


def comp_jac_geometry(nstate, ngroups):
    """Launch geometry of the segmented Jacobian kernel (``cuda_fisp.
    seg_geometry``: each atom stages 2 + 2 ngroups floats per stage beside
    COMP_JAC_TABLE) at its rows per lane: 2, 1 for H = nstate + 1 <= 3,
    ceil(H / 32) past 64 rows up to 160 (the gate's edges: 2, 3, 4, 5 rows
    with 4, 3, 2, 1 groups), 10 above (without groups, to nstate 301).
    The launch passes R and ``warps`` to the kernel, which dispatches on
    them."""
    H = int(nstate) + 1
    R = 1 if H <= 3 else 2 if H <= 64 else -(-H // 32) if H <= 160 else 10
    return seg_geometry(nstate, 2 + 2 * int(ngroups), COMP_JAC_TABLE, R)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _setup(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s, dfs,
           nadc, nstate, diffusion, flags, strict):
    """The tables and atoms as tensors on T1s's device (floats in T1s's
    dtype, adci and shift int32) and the static flags, derived from the
    host values where None (``_comp_setup``).  With `strict` (the kernels)
    a tensor argument of another device, dtype or shape, or a
    non-contiguous one, raises instead of being converted."""
    if not isinstance(T1s, torch.Tensor) or T1s.ndim != 1 \
            or T1s.shape[0] < 1:
        raise TypeError("T1s must be a (B,) tensor, B >= 1: its device "
                        "selects the kernel (CUDA) or the plain twin (CPU)")
    dev, dt, B = T1s.device, T1s.dtype, T1s.shape[0]
    if np.ndim(FA) != 1 or len(FA) < 1:
        raise ValueError("FA: expected a non-empty (N,) stage table")
    N = len(FA)

    def vec(x, n, name, dtype=dt):
        if isinstance(x, torch.Tensor):
            if strict and (x.device != dev or x.dtype != dtype
                           or not x.is_contiguous()):
                raise ValueError(
                    f"{name}: expected a contiguous {dtype} tensor on {dev}, "
                    f"got {x.dtype} on {x.device}")
            x = x.to(device=dev, dtype=dtype)
        else:
            x = torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                                device=dev)
        if x.ndim == 0:
            x = x.expand(n).contiguous()
        if tuple(x.shape) != (n,):
            raise ValueError(f"{name}: expected shape ({n},), "
                             f"got {tuple(x.shape)}")
        return x

    up, down, adcph, b1s = flags
    if up is None:
        up = bool((_host(shift) == 1).any())
    if down is None:
        down = bool((_host(shift) == -1).any())
    if adcph is None:
        adcph = aph is not None and bool(_host(aph).any())
    if b1s is None:
        b1s = b1u is not None and not bool(_host(b1u).all())
    if (up or down) and int(nstate) < 1:
        raise ValueError("shifting composite trains need nstate >= 1")
    if int(nstate) < 0 or int(nadc) < 1:
        raise ValueError(f"nstate must be >= 0 and nadc >= 1, got "
                         f"{nstate}, {nadc}")
    x = {"FA": vec(FA, N, "FA"), "phi": vec(phi, N, "phi"),
         "ta": vec(ta, N, "ta"), "tb": vec(tb, N, "tb"),
         "adci": vec(adci, N, "adci", torch.int32),
         "shift": vec(shift, N, "shift", torch.int32),
         "aph": vec(0.0 if aph is None else aph, N, "aph"),
         "b1u": vec(1.0 if b1u is None else b1u, N, "b1u"),
         "T1": vec(T1s, B, "T1s"), "T2": vec(T2s, B, "T2s"),
         "B1": vec(B1s, B, "B1s"),
         "df": None if dfs is None else vec(dfs, B, "dfs"),
         "N": N, "B": B, "nadc": int(nadc), "H": int(nstate) + 1,
         "up": up, "down": down, "adcph": adcph, "b1u_on": b1s}
    if diffusion is None:
        x["btd"] = x["rdir"] = torch.zeros(N, dtype=dt, device=dev)
        x["Dc"] = None
    else:
        btd, rdir, Dc = diffusion
        x["btd"], x["rdir"] = vec(btd, N, "btd"), vec(rdir, N, "rdir")
        x["Dc"] = vec(Dc, B, "Dc")
    return x


def _groups(groups):
    return tuple(g for g in COMP_JAC_GROUPS if g in groups)


def _twin(x, groups):
    """The kernels' recurrence on a _setup dict: out (2 + 2 len(groups),
    nadc, B), (re, im) of the signal and of each tangent group."""
    T1, T2, B1, DF, Dc = x["T1"], x["T2"], x["B1"], x["df"], x["Dc"]
    N, B, H = x["N"], x["B"], x["H"]
    dt, dev = T1.dtype, T1.device
    z = torch.zeros((H, B), dtype=dt, device=dev)
    # st[g]: plane set of group g (0 the primal, then `groups` in order)
    st = [[z.clone() for _ in range(6)] for _ in range(1 + len(groups))]
    st[0][4][0] = 1.0
    out = torch.empty((2 + 2 * len(groups), x["nadc"], B), dtype=dt,
                      device=dev)
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * _DEG)
    FA, ta_, tb_, aph, b1u = x["FA"], x["ta"], x["tb"], x["aph"], x["b1u"]
    # the tables the loop branches on, read once (one copy each from a card)
    adci, shift = x["adci"].tolist(), x["shift"].tolist()
    btd, rdir = x["btd"].tolist(), x["rdir"].tolist()
    for i in range(N):
        if x["b1u_on"]:
            a = FA[i] * (1.0 + b1u[i] * (B1 - 1.0)) * _DEG
            da = FA[i] * b1u[i] * _DEG
        else:
            a = FA[i] * B1 * _DEG
            da = FA[i] * _DEG
        rc = planes.rot_coeffs(a, cp[i], sp[i], c2p[i], s2p[i])
        ta, tb = ta_[i], tb_[i]
        tt = ta + tb
        e1a, e1b, e2a = (torch.exp(-ta / T1), torch.exp(-tb / T1),
                         torch.exp(-ta / T2))
        cf = e2a * torch.exp(-tb / T2)
        cZ = e1a * e1b
        rec = 1.0 - cZ
        # the carried F coefficient cf e^{i 2 pi df tt} as a (re, im) pair
        # (im None without df); `rotate` turns any real coefficient into one
        if DF is None:
            rotate = lambda c: (c, None)   # noqa: E731
        else:
            ang = _TWO_PI * DF * tt
            cc, cs = torch.cos(ang), torch.sin(ang)
            rotate = lambda c: (c * cc, c * cs)   # noqa: E731
        cF = rotate(cf)
        # the echo's phasor: df over ta, then the ADC phase
        pe = None
        if DF is not None:
            ang = _TWO_PI * DF * ta
            pe = (torch.cos(ang), torch.sin(ang))
        if x["adcph"]:
            q = (torch.cos(aph[i]), torch.sin(aph[i]))
            pe = q if pe is None else planes.cmul(pe[0], pe[1], *q)
        idx = adci[i]
        readout = 0 <= idx < x["nadc"]

        p0 = planes.apply_rot(rc, st[0])
        pR, pI = planes.echo_copy(e2a, pe, p0[0][0], p0[1][0])
        if readout:
            out[0, idx], out[1, idx] = pR, pI
        pZ = cZ * p0[4]
        pZ[0] = pZ[0] + rec
        new = [_fmul(cF, p0[0], p0[1]) + _fmul(cF, p0[2], p0[3])
               + (pZ, cZ * p0[5])]
        for j, name in enumerate(groups):
            t = planes.apply_rot(rc, st[1 + j])
            if name == "T1":        # only cZ and rec = 1 - cZ
                e = planes.echo_copy(e2a, pe, t[0][0], t[1][0])
                dcZ = cZ * tt / (T1 * T1)
                tZ = cZ * t[4] + dcZ * p0[4]
                tZ[0] = tZ[0] - dcZ
                n = (_fmul(cF, t[0], t[1]) + _fmul(cF, t[2], t[3])
                     + (tZ, cZ * t[5] + dcZ * p0[5]))
            elif name == "T2":      # cF and the echo's ta decay
                e = planes.echo_copy(e2a, pe, t[0][0], t[1][0])
                de2a = e2a * ta / (T2 * T2)
                xe = (de2a * p0[0][0], de2a * p0[1][0])
                if pe is not None:
                    xe = planes.cmul(pe[0], pe[1], *xe)
                e = (e[0] + xe[0], e[1] + xe[1])
                d = rotate(cf * tt / (T2 * T2))
                fa_, fb_ = _fmul(cF, t[0], t[1]), _fmul(cF, t[2], t[3])
                xa, xb = _fmul(d, p0[0], p0[1]), _fmul(d, p0[2], p0[3])
                n = (fa_[0] + xa[0], fa_[1] + xa[1], fb_[0] + xb[0],
                     fb_[1] + xb[1], cZ * t[4], cZ * t[5])
            elif name == "B1":      # the rotation coefficients' pass
                C = planes.apply_rot(planes.rot_coeffs_db1(
                    a, da, cp[i], sp[i], c2p[i], s2p[i]), st[0])
                e = planes.echo_copy(e2a, pe, t[0][0] + C[0][0],
                                     t[1][0] + C[1][0])
                n = (_fmul(cF, t[0] + C[0], t[1] + C[1])
                     + _fmul(cF, t[2] + C[2], t[3] + C[3])
                     + (cZ * (t[4] + C[4]), cZ * (t[5] + C[5])))
            else:                   # df: the phasors' derivative
                e = planes.echo_copy(e2a, pe, t[0][0], t[1][0])
                g = planes.df_tangent(ta, pR, pI)
                e = (e[0] + g[0], e[1] + g[1])
                fF = planes.df_tangent(tt, cF[0], torch.zeros_like(cF[0])
                                       if cF[1] is None else cF[1])
                fa_, fb_ = _fmul(cF, t[0], t[1]), _fmul(cF, t[2], t[3])
                ya = planes.cmul(fF[0], fF[1], p0[0], p0[1])
                yb = planes.cmul(fF[0], fF[1], p0[2], p0[3])
                # Z carries no off-resonance
                n = (fa_[0] + ya[0], fa_[1] + ya[1], fb_[0] + yb[0],
                     fb_[1] + yb[1], cZ * t[4], cZ * t[5])
            if readout:
                out[2 + 2 * j, idx], out[3 + 2 * j, idx] = e
            new.append(n)
        s = shift[i]
        if s == 1 and x["up"]:
            new = [planes.shift_fold(n) for n in new]
        elif s == -1 and x["down"]:
            new = [planes.shift_down(n) for n in new]
        if Dc is not None and btd[i] != 0.0:   # without D every factor is 1
            att = planes.stage_attenuation(btd[i], rdir[i], Dc, H)
            new = [planes.attenuate(n, att) for n in new]
        st = [list(n) for n in new]
    return out


def _jac_views(out):
    """((re, im), (jre, jim)) views of a (2 + 2 ng, nadc, B) buffer: (nadc,
    B) signals and (nadc, B, ng) tangents (zero width without groups)."""
    return (out[0], out[1]), (out[2::2].permute(1, 2, 0),
                              out[3::2].permute(1, 2, 0))


def composite_plain(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s,
                    dfs=None, *, nadc, nstate, diffusion=None, has_up=None,
                    has_down=None, has_adcph=None, has_b1u=None):
    """Echo trains (re, im), each (nadc, B), by the plain PyTorch
    recurrence (the kernel's twin), on T1s's device in T1s's dtype.
    Arguments as :func:`composite_cuda`."""
    x = _setup(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s, dfs,
               nadc, nstate, diffusion,
               (has_up, has_down, has_adcph, has_b1u), strict=False)
    out = _twin(x, ())
    return out[0], out[1]


def composite_jacobian_plain(FA, phi, ta, tb, adci, shift, aph, b1u, T1s,
                             T2s, B1s, dfs=None, *, nadc, nstate,
                             groups=COMP_JAC_GROUPS, diffusion=None,
                             has_up=None, has_down=None, has_adcph=None,
                             has_b1u=None):
    """Signals (nadc, B) and tangents (nadc, B, ng) by the plain PyTorch
    recurrence (the Jacobian kernel's twin).  Arguments and returns as
    :func:`composite_jacobian_cuda`."""
    x = _setup(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s, dfs,
               nadc, nstate, diffusion,
               (has_up, has_down, has_adcph, has_b1u), strict=False)
    return _jac_views(_twin(x, _groups(groups)))


def composite_cuda(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s,
                   dfs=None, *, nadc, nstate, diffusion=None, has_up=None,
                   has_down=None, has_adcph=None, has_b1u=None):
    """Run a composite-GRE stage train through the CUDA kernel.

    Args mirror ``composite_pallas``: FA, phi (N,) per-stage flip and
    pulse phase (degrees); ta, tb (N,) relaxation before and after the
    readout (ms); adci (N,) int output row (-1: no readout); shift (N,) int
    in {-1, 0, +1}; aph (N,) ADC phase (radians) or None; b1u (N,) B1
    sensitivity or None (every stage scales with B1); T1s, T2s, B1s and the
    optional dfs (kHz) per atom (B,), T1s a float32 CUDA tensor (tensor
    arguments must be float32 -- adci and shift int32 -- contiguous and on
    its device); nadc the readout rows; nstate the ladder capacity (>= 1
    when a stage shifts); diffusion optional ``(btd, rdir, Dc)``: per-stage
    b-value bases and ramp directions, and the diffusivity (scalar or
    (B,)); the ``has_*`` flags gate the shifts, the ADC phase and b1u and
    are derived from the tables when None.  Returns (re, im): (nadc, B)
    float32.  Raises for CPU tensors: the twin is
    :func:`composite_plain`."""
    return _launch(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s,
                   dfs, nadc=nadc, nstate=nstate, diffusion=diffusion,
                   flags=(has_up, has_down, has_adcph, has_b1u), groups=None)


def composite_jacobian_cuda(FA, phi, ta, tb, adci, shift, aph, b1u, T1s,
                            T2s, B1s, dfs=None, *, nadc, nstate,
                            groups=COMP_JAC_GROUPS, diffusion=None,
                            has_up=None, has_down=None, has_adcph=None,
                            has_b1u=None):
    """Composite-GRE stage train + dS/d(selected params) in one CUDA kernel.

    Same contract as :func:`composite_cuda` plus ``groups`` from ("T1",
    "T2", "B1", "df") (canonical order enforced; only those groups cost
    planes).  Returns ``(re, im), (jre, jim)``: signals (nadc, B) and
    Jacobians (nadc, B, len(groups)) in group order, a zero-width tangent
    axis without groups.  The df column (signal per kHz) is exact at any
    df, 0 included; the B1 column is w.r.t. the B1s passed."""
    return _launch(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s,
                   dfs, nadc=nadc, nstate=nstate, diffusion=diffusion,
                   flags=(has_up, has_down, has_adcph, has_b1u),
                   groups=_groups(groups))


def composite_echoes(*args, **kw):
    """:func:`composite_cuda` for CUDA tensors, :func:`composite_plain`
    for CPU tensors (the twin stands in for the kernel on the CPU)."""
    fn = composite_plain if _takes_twin(args[8], "composite") \
        else composite_cuda
    return fn(*args, **kw)


def composite_jacobian_echoes(*args, **kw):
    """:func:`composite_jacobian_cuda` for CUDA tensors,
    :func:`composite_jacobian_plain` for CPU tensors."""
    fn = composite_jacobian_plain \
        if _takes_twin(args[8], "composite Jacobian") \
        else composite_jacobian_cuda
    return fn(*args, **kw)


def composite_jacobian_cuda_sharded(FA, phi, ta, tb, adci, shift, aph, b1u,
                                    T1s, T2s, B1s, dfs=None, *, mesh,
                                    axis="atoms", **kw):
    """Atom-sharded composite Jacobian over a device mesh
    (``composite_jacobian_pallas_sharded``): each entry of the mesh's
    `axis` runs :func:`composite_jacobian_cuda` (the plain twin on a CPU
    entry) on its atom shard; the axis size must divide the atom count,
    the per-stage rows are replicated, B1s and dfs broadcast to the atoms
    and a per-atom diffusion coefficient (B,) shards with them.  Returns
    ((re, im), (jre, jim)): (nadc, B) signals and (nadc, B, ng) tangents,
    on the mesh's first device."""
    from ..parallel.mesh import per_atom, shard_map
    from .cuda_fisp import _per_atom_dc, _with_dc

    diffusion = kw.pop("diffusion", None)
    dc = _per_atom_dc(diffusion)
    T1s = per_atom(T1s)
    B1s, dfs = (None if x is None else torch.broadcast_to(
        torch.as_tensor(x, dtype=T1s.dtype, device=T1s.device), T1s.shape)
        for x in (B1s, dfs))

    def local(t1, t2, b1, df, dcs, diff, *train):
        return composite_jacobian_echoes(*train, t1, t2, b1, df,
                                         diffusion=_with_dc(diff, dcs), **kw)

    return shard_map(local, mesh, [(T1s, 0), (T2s, 0), (B1s, 0), (dfs, 0),
                                   (dc, 0)], axis=axis, out_dim=1,
                     replicated=(diffusion, FA, phi, ta, tb, adci, shift,
                                 aph, b1u))


def _launch(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s, dfs, *,
            nadc, nstate, diffusion, flags, groups):
    global LAUNCHES, JAC_LAUNCHES
    from .. import _build

    jac = groups is not None
    name = "composite_jac" if jac else "composite"
    if not isinstance(T1s, torch.Tensor) or T1s.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors (T1s on "
                         f"{getattr(T1s, 'device', 'the host')}); the plain "
                         f"twin runs elsewhere")
    if T1s.dtype != torch.float32:
        raise TypeError(f"the {name} kernel computes in float32, got "
                        f"{T1s.dtype}")
    nstate = int(nstate)
    ng = len(groups) if jac else 0
    if not (composite_jac_kernel_fits(nstate, ng) if jac
            else composite_kernel_fits(nstate)):
        raise ValueError(f"nstate={nstate}: the {name} kernel state does not "
                         f"fit in {SMEM_PER_BLOCK} bytes of shared memory")
    x = _setup(FA, phi, ta, tb, adci, shift, aph, b1u, T1s, T2s, B1s, dfs,
               nadc, nstate, diffusion, flags, strict=True)
    B, nadc = x["B"], x["nadc"]
    out = torch.empty((2 + 2 * ng, nadc, B), dtype=torch.float32,
                      device=T1s.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = [ptr(x[k]) for k in ("FA", "phi", "ta", "tb", "adci", "shift",
                                "aph", "b1u", "btd", "rdir", "T1", "T2", "B1",
                                "df", "Dc")]
    flag_args = [int(x["df"] is not None), int(x["up"]), int(x["down"]),
                 int(x["adcph"]), int(x["b1u_on"]), int(x["Dc"] is not None)]
    dev = (T1s.device.index if T1s.device.index is not None
           else torch.cuda.current_device())
    stream = torch.cuda.current_stream(T1s.device).cuda_stream
    # asynchronous on the current stream; see cuda_fisp._launch on
    # temporaries
    lib = _build.load()
    if jac:
        mask = sum(1 << COMP_JAC_GROUPS.index(g) for g in groups)
        geo = comp_jac_geometry(nstate, ng)
        rc = lib.epg_composite_jac(*args, ptr(out), x["N"], B, nadc, nstate,
                                   geo["R"], mask, *flag_args, geo["warps"],
                                   dev, stream)
    else:
        geo = comp_geometry(nstate)
        rc = lib.epg_composite(*args, ptr(out), x["N"], B, nadc, nstate,
                               *flag_args, geo["R"], geo["warps"],
                               geo["pulses"], dev, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if jac:
        JAC_LAUNCHES += 1
        return _jac_views(out)
    LAUNCHES += 1
    return out[0], out[1]
