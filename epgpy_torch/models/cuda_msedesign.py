"""Per-echo CPMG design Jacobian: the CUDA kernel and its plain twin.

Counterpart of ``epgpy_tpu/models/pallas_msedesign.py:cpmg_design_pallas``
(:279) with its kernel ``_kernel_design`` (:80).  The train is the CPMG
block of ``cuda_mse`` with symmetric half-spacings: after one excitation,
per echo i

    x1 = Sh(D(esp_i/2) x + r)        # E -> S(1)
    x2 = M(alpha_i, phi_i) x1        # refocusing rotation
    x3 = Sh(D(esp_i/2) x2 + r)       # E -> S(1)
    echo_i = x3.A(0)

Per atom, the outputs are the signal and dS/dT1, dS/dT2 at every echo j,
and per design variable i (the "lane": the echo index) dS_j/dalpha_i,
dS_j/desp_i and, with ``second_order``, d2S_j/dT1 dalpha_i, d2S_j/dT2
dalpha_i, d2S_j/dT1 desp_i, d2S_j/dT2 desp_i.  Every tangent moves by the
primal's own per-echo operator plus seed terms at its own echo, so it is
one pass over nine groups of folded plane sets: P, U1, U2 per atom, A, T,
W1, W2, X1, X2 per lane.  The esp derivative hits BOTH half-spacings of
its echo with the chain coefficient 1/2 (``eF``, ``eZ``, ``eF2``, ``eZ1``).
A lane is exactly zero before its echo, so outputs with i > j are exact
zeros.

``cpmg_design_cuda`` takes the kernel (``epgpy_torch/csrc/cpmg_design.cu``)
for CUDA tensors and raises on what it does not take; for CPU tensors it
runs ``cpmg_design_plain``, the same recurrence with the same operation
order vectorised over (rows, atoms, lanes), in any precision.
``DESIGN_LAUNCHES`` counts kernel launches.  The TPU-only knobs
(``pchunk``, ``interpret``, the lane padding to 128) are not taken.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import planes
from .cuda_fisp import SMEM_PER_BLOCK, _takes_twin

__all__ = ["cpmg_design_cuda", "cpmg_design_plain", "design_kernel_fits",
           "design_tile", "design_block_smem", "DESIGN_LAUNCHES",
           "cpmg_design_cuda_sharded"]

#: design kernel launches so far (diagnostics: proves a run went through it)
DESIGN_LAUNCHES = 0

#: per-lane plane groups: A, T (first order), W1, W2, X1, X2 (second)
_LANE_NAMES = ("dalpha", "desp", "dT1dalpha", "dT2dalpha", "dT1desp",
               "dT2desp")
#: floats per ladder row of one buffer of the per-atom groups P, U1, U2
#: (18, and one more: an odd row stride is conflict-free)
_ATOM_ROW = 19
#: the kernel keeps three such buffers (before and after the first
#: half-stage, after the rotation)
_ATOM_BUFFERS = 3
#: lane-warps per block at most (cpmg_design.cu's launch bound: 256
#: threads); also the tile the gate is taken at
_MAX_TILE = 8


def _lane_groups(second_order):
    return 6 if second_order else 2


def design_block_smem(nstate, tile, second_order=True) -> int:
    """Shared memory of one block of the design kernel: per lane-warp,
    one record per ladder row of its 6 G plane values and one more (odd:
    conflict-free), and the three per-atom buffers."""
    H = int(nstate) + 1
    return 4 * H * ((6 * _lane_groups(second_order) + 1) * tile
                    + _ATOM_BUFFERS * _ATOM_ROW)


def design_kernel_fits(nstate, second_order=True) -> bool:
    """Whether the design kernel takes this ladder: while 8 lanes' planes
    (6 G x H floats each) and three per-atom buffers of 18 H floats fit
    one block's shared memory -- nstate <= 168 (second order), <= 386
    (first).  That is the one-thread-per-lane layout's gate, kept so that
    the same designs take the kernel; the warp-row kernel needs one
    lane-warp (``design_tile`` never gives less), so it would admit
    deeper ladders."""
    H = max(int(nstate), 1) + 1
    return 4 * H * (6 * _lane_groups(second_order) * _MAX_TILE
                    + _ATOM_BUFFERS * 18) <= SMEM_PER_BLOCK


def design_tile(nechoes, nstate, second_order=True) -> int:
    """Lane-warps per block (one warp per design lane): at most 8 and
    what fits, then evened out over the tiles (E = 32, nstate 64, second
    order: 4 tiles of 8 lane-warps, 91,780 bytes, two blocks per SM; at
    the gate's nstate 168, 7)."""
    E = int(nechoes)
    tile = min(E, _MAX_TILE)
    while tile > 1 and design_block_smem(nstate, tile, second_order) \
            > SMEM_PER_BLOCK:
        tile -= 1
    ntiles = -(-E // tile)
    return -(-E // ntiles)


def _prepare(FA, phi, ESP, T1s, T2s, strict):
    """Per-echo (E,) and per-atom (B,) tensors on T1s's device and dtype;
    with `strict` (the kernel) a tensor of another device or dtype, or a
    non-contiguous one, raises instead of being converted."""
    if not isinstance(T1s, torch.Tensor):
        raise TypeError("T1s must be a tensor: its device selects the "
                        "kernel (CUDA) or the plain twin (CPU)")
    dev, dt = T1s.device, T1s.dtype

    def vec(x, name):
        if isinstance(x, torch.Tensor):
            if strict and (x.device != dev or x.dtype != dt
                           or not x.is_contiguous()):
                raise ValueError(f"{name}: expected a contiguous {dt} tensor "
                                 f"on {dev}, got {x.dtype} on {x.device}")
            return x.to(device=dev, dtype=dt)
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dt,
                               device=dev)

    FA = vec(FA, "FA")
    if FA.ndim != 1 or FA.shape[0] < 1:
        raise ValueError("FA: expected a non-empty (E,) refocusing train")
    E = FA.shape[0]
    phi, ESP = vec(phi, "phi"), vec(ESP, "ESP")
    T1, T2 = vec(T1s, "T1s"), vec(T2s, "T2s")
    if T1.ndim > 1 or T2.ndim > 1:
        raise ValueError("T1s, T2s: expected scalars or (B,) atom vectors")
    T1, T2 = torch.broadcast_tensors(torch.atleast_1d(T1),
                                     torch.atleast_1d(T2))
    out = {"FA": FA, "phi": phi.expand(E).contiguous(),
           "ESP": ESP.expand(E).contiguous(), "T1": T1.contiguous(),
           "T2": T2.contiguous(), "E": E, "B": T1.shape[0]}
    for k in ("phi", "ESP"):
        if tuple(out[k].shape) != (E,):
            raise ValueError(f"{k}: expected a scalar or shape ({E},)")
    return out


def _result(atom, lane, second_order):
    """The JAX dict layout from the (6, B, E) per-atom and (2G, B, E, E)
    per-lane output buffers (views, no copies)."""
    res = {"sig": (atom[0], atom[1]), "dT1": (atom[2], atom[3]),
           "dT2": (atom[4], atom[5])}
    for g in range(_lane_groups(second_order)):
        res[_LANE_NAMES[g]] = (lane[2 * g], lane[2 * g + 1])
    return res


def _coeffs(tau, T1, T2):
    """Half-spacing relaxation coefficients (pallas_msedesign.py:123-134):
    cF, cZ, rec, dcF/dT2, dcZ/dT1 and the esp-direction terms with the
    1/2 chain coefficient (d rec/desp = -eZ)."""
    cF = torch.exp(-tau / T2)
    cZ = torch.exp(-tau / T1)
    return dict(cF=cF, cZ=cZ, rec=1.0 - cZ,
                dcF2=cF * tau / (T2 * T2), dcZ1=cZ * tau / (T1 * T1),
                eF=-0.5 * cF / T2, eZ=-0.5 * cZ / T1,
                eF2=0.5 * cF * (1.0 - tau / T2) / (T2 * T2),
                eZ1=0.5 * cZ * (1.0 - tau / T1) / (T1 * T1))


def _atom_stage(P, U1, U2, c):
    """E -> S(1) on the per-atom groups (P, U1, U2)."""
    cF, cZ, dcZ1, dcF2 = c["cF"], c["cZ"], c["dcZ1"], c["dcF2"]
    pZ = cZ * P[4]
    pZ[0] = pZ[0] + c["rec"]
    u1Z = cZ * U1[4] + dcZ1 * P[4]
    u1Z[0] = u1Z[0] - dcZ1
    new = ((cF * P[0], cF * P[1], cF * P[2], cF * P[3], pZ, cZ * P[5]),
           (cF * U1[0], cF * U1[1], cF * U1[2], cF * U1[3], u1Z,
            cZ * U1[5] + dcZ1 * P[5]),
           tuple(cF * U2[j] + dcF2 * P[j] for j in range(4))
           + (cZ * U2[4], cZ * U2[5]))
    return tuple(planes.shift_fold(s) for s in new)


def _lane_stage(groups, P, U1, U2, c, m, rowm, second_order):
    """E -> S(1) on the live lane groups (each plane (H, B, L)); P, U1, U2
    are the per-atom groups entering the stage (broadcast over lanes) and
    m seeds the current echo's lane (pallas_msedesign.py:142-212)."""
    cF, cZ, dcZ1, dcF2, eF, eZ = (c[k][:, None] for k in
                                  ("cF", "cZ", "dcZ1", "dcF2", "eF", "eZ"))
    P, U1, U2 = (tuple(v[..., None] for v in s) for s in (P, U1, U2))
    A, T = groups[:2]
    new = [tuple(cF * A[j] for j in range(4)) + (cZ * A[4], cZ * A[5]),
           tuple(cF * T[j] + m * eF * P[j] for j in range(4))
           + (cZ * T[4] + m * (eZ * P[4] - rowm * eZ),
              cZ * T[5] + m * eZ * P[5])]
    if second_order:
        eF2, eZ1 = c["eF2"][:, None], c["eZ1"][:, None]
        W1, W2, X1, X2 = groups[2:]
        new += [
            tuple(cF * W1[j] for j in range(4))
            + (cZ * W1[4] + dcZ1 * A[4], cZ * W1[5] + dcZ1 * A[5]),
            tuple(cF * W2[j] + dcF2 * A[j] for j in range(4))
            + (cZ * W2[4], cZ * W2[5]),
            tuple(cF * X1[j] + m * eF * U1[j] for j in range(4))
            + (cZ * X1[4] + dcZ1 * T[4]
               + m * (eZ * U1[4] + eZ1 * P[4] - rowm * eZ1),
               cZ * X1[5] + dcZ1 * T[5] + m * (eZ * U1[5] + eZ1 * P[5])),
            tuple(cF * X2[j] + dcF2 * T[j] + m * (eF * U2[j] + eF2 * P[j])
                  for j in range(4))
            + (cZ * X2[4] + m * eZ * U2[4], cZ * X2[5] + m * eZ * U2[5]),
        ]
    return [planes.shift_fold(s) for s in new]


def cpmg_design_plain(exc, FA, phi, ESP, T1s, T2s, *, nstate,
                      second_order=False):
    """Per-echo CPMG design Jacobian by the plain PyTorch twin of the
    kernel.

    Arguments and returns as :func:`cpmg_design_cuda`; any device, the
    dtype of T1s (float64 makes it an oracle).  At echo n only lanes
    0..n are live (a lane is zero before its echo), so each step works on
    those; the seed of lane n is the mask term of the JAX kernel."""
    nstate = int(nstate)
    if nstate < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    x = _prepare(FA, phi, ESP, T1s, T2s, strict=False)
    T1, T2, E, B = x["T1"], x["T2"], x["E"], x["B"]
    H, G = nstate + 1, _lane_groups(second_order)
    dt, dev = T1.dtype, T1.device
    z = torch.zeros((H, B), dtype=dt, device=dev)
    P = planes.excitation(exc, H, B, dt, dev)
    U1 = [z.clone() for _ in range(6)]
    U2 = [z.clone() for _ in range(6)]
    # lane groups A, T[, W1, W2, X1, X2]: (G, 6 planes, H, B, lanes)
    lane = torch.zeros((G, 6, H, B, E), dtype=dt, device=dev)
    out_atom = torch.empty((6, B, E), dtype=dt, device=dev)
    out_lane = torch.zeros((2 * G, B, E, E), dtype=dt, device=dev)
    rowm = torch.zeros((H, 1, 1), dtype=dt, device=dev)
    rowm[0] = 1.0
    rad = math.pi / 180.0
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * rad)

    for n in range(E):
        c = _coeffs(0.5 * x["ESP"][n], T1, T2)
        a = x["FA"][n] * rad
        rc = planes.rot_coeffs(a, cp[n], sp[n], c2p[n], s2p[n])
        drc = planes.rot_coeffs_db1(a, rad, cp[n], sp[n], c2p[n], s2p[n])
        L = n + 1
        m = torch.zeros(L, dtype=dt, device=dev)
        m[n] = 1.0
        live = lane[..., :L]
        groups = [tuple(live[g, j] for j in range(6)) for g in range(G)]

        # first half-stage, with the per-atom groups entering it as seeds
        groups = _lane_stage(groups, P, U1, U2, c, m, rowm, second_order)
        P, U1, U2 = _atom_stage(P, U1, U2, c)
        # rotation: lane A gets M' P seeded, W1/W2 get M' U1 / M' U2
        seeds = {0: P}
        if second_order:
            seeds.update({2: U1, 3: U2})
        rot = []
        for g, s in enumerate(groups):
            y = planes.apply_rot(rc, s)
            if g in seeds:
                q = planes.apply_rot(drc, seeds[g])
                y = tuple(yj + m * qj[..., None] for yj, qj in zip(y, q))
            rot.append(y)
        P, U1, U2 = (planes.apply_rot(rc, s) for s in (P, U1, U2))
        # second half-stage
        groups = _lane_stage(rot, P, U1, U2, c, m, rowm, second_order)
        P, U1, U2 = _atom_stage(P, U1, U2, c)

        for g, s in enumerate(groups):
            for j in range(6):
                live[g, j] = s[j]
            out_lane[2 * g, :, n, :L] = s[0][0]
            out_lane[2 * g + 1, :, n, :L] = s[1][0]
        for g, s in enumerate((P, U1, U2)):
            out_atom[2 * g, :, n] = s[0][0]
            out_atom[2 * g + 1, :, n] = s[1][0]
    return _result(out_atom, out_lane, second_order)


def cpmg_design_cuda(exc, FA, phi, ESP, T1s, T2s, *, nstate,
                     second_order=False):
    """Per-echo CPMG design Jacobian (+ mixed Hessian) via the fused CUDA
    kernel.

    Args mirror ``cpmg_design_pallas``: exc = (alpha, phi) of the
    excitation (degrees, host scalars; not a design variable); FA, phi
    (E,) refocusing flips and phases (degrees; phi may be a scalar); ESP
    (E,) echo spacings (ms), each split symmetrically around its
    refocusing pulse; T1s, T2s scalars or (B,) tensors, whose device
    selects the kernel (CUDA, float32, contiguous) or the plain twin
    (CPU); nstate the ladder half-size (>= 2E is exact); ``second_order``
    adds the mixed d2S/(dT_c dp_i) a CRLB design gradient needs.

    Returns a dict of (re, im) pairs: ``sig``, ``dT1``, ``dT2`` (B, E);
    ``dalpha``, ``desp`` and with ``second_order`` ``dT1dalpha``,
    ``dT2dalpha``, ``dT1desp``, ``dT2desp`` (B, E_echo, E_variable),
    entries with variable > echo exactly zero.
    """
    kw = dict(nstate=nstate, second_order=second_order)
    if _takes_twin(T1s, "CPMG design"):
        return cpmg_design_plain(exc, FA, phi, ESP, T1s, T2s, **kw)
    return _launch(exc, FA, phi, ESP, T1s, T2s, **kw)


def cpmg_design_cuda_sharded(exc, FA, phi, ESP, T1s, T2s, *, mesh,
                             axis="atoms", **kw):
    """Atom-sharded :func:`cpmg_design_cuda` over a device mesh
    (``cpmg_design_pallas_sharded``): each entry of the mesh's `axis` runs
    the kernel (the plain twin on a CPU entry) on its atom shard; the axis
    size must divide the atom count, the echo arrays are replicated.
    Returns the :func:`cpmg_design_cuda` dict on the mesh's first device,
    every block with its atoms leading."""
    from ..parallel.mesh import per_atom, shard_map

    T1s, T2s = torch.broadcast_tensors(
        *(torch.atleast_1d(per_atom(x)) for x in (T1s, T2s)))

    def local(t1, t2, *train):
        return cpmg_design_cuda(exc, *train, t1, t2, **kw)

    return shard_map(local, mesh, [(T1s, 0), (T2s, 0)], axis=axis,
                     replicated=(FA, phi, ESP))


def _launch(exc, FA, phi, ESP, T1s, T2s, *, nstate, second_order):
    global DESIGN_LAUNCHES
    from .. import _build

    if T1s.dtype != torch.float32:
        raise TypeError(f"the CPMG design kernel computes in float32, got "
                        f"{T1s.dtype}")
    nstate = int(nstate)
    second_order = bool(second_order)
    if nstate < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    if not design_kernel_fits(nstate, second_order):
        raise ValueError(f"nstate={nstate}: the design kernel state does "
                         f"not fit in {SMEM_PER_BLOCK} bytes of shared memory")
    x = _prepare(FA, phi, ESP, T1s, T2s, strict=True)
    E, B = x["E"], x["B"]
    dev = T1s.device
    out_atom = torch.empty((6, B, E), dtype=torch.float32, device=dev)
    out_lane = torch.empty((2 * _lane_groups(second_order), B, E, E),
                           dtype=torch.float32, device=dev)
    # asynchronous on the current stream; see cuda_fisp._launch on
    # temporaries
    lib = _build.load()
    rc = lib.epg_cpmg_design(
        *planes.excitation_terms(exc), x["FA"].data_ptr(),
        x["phi"].data_ptr(), x["ESP"].data_ptr(), x["T1"].data_ptr(),
        x["T2"].data_ptr(), out_atom.data_ptr(), out_lane.data_ptr(), E, B,
        nstate, int(second_order), design_tile(E, nstate, second_order),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cpmg_design kernel launch failed: CUDA error "
                           f"{rc}")
    DESIGN_LAUNCHES += 1
    return _result(out_atom, out_lane, second_order)
