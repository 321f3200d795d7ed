"""CPMG / multi-spin-echo trains and their Jacobian: CUDA kernels, plain twins.

Counterpart of ``epgpy_tpu/models/pallas_mse.py``:
``cpmg_dictionary_pallas`` (:227) with its kernel ``_kernel_mse`` (:114)
and ``cpmg_jacobian_pallas`` (:468) with ``_kernel_mse_jac`` (:309).  The
train is, after one excitation ``T(exc)`` from equilibrium, per echo i

    E(tau1_i) S(1) [D1]  T(FA_i * B1, phi_i)  E(tau2_i) S(1) [D2]  ADC

(the reference's published 18-echo benchmark family, with per-echo
spacings, per-atom B1 on the refocusing flips and the optional DW-TSE
attenuation after each shift).  The kernels are
``epgpy_torch/csrc/cpmg.cu`` and ``cpmg_jac.cu`` (see their headers for
the design); ``cpmg_dictionary_plain`` / ``cpmg_jacobian_plain`` are the
same recurrences with the same operation order, vectorised over atoms as
(6, nstate+1, B) planes in a Python loop over echoes, in any precision
(float64 makes them oracles).

``*_cuda`` takes the kernel for CUDA tensors (and raises on what it does
not take: no fallback) and the plain twin for CPU tensors; the echo-layout
``cpmg_echoes`` / ``cpmg_jacobian_echoes`` are what the dispatch uses.
``LAUNCHES`` / ``JAC_LAUNCHES`` count kernel launches.  The TPU-only knobs
(``btile``, ``interpret``) are not taken.

Gates: ``mse_kernel_fits`` is the counterpart of the JAX package's VMEM
guard, kept as the one-thread-per-atom layout with 6 planes (12 with
diffusion) in shared memory set it: nstate <= 301 (150 with diffusion).
The primal kernel now keeps its planes in registers on the segmented
layout (a ladder in a segment of ceil(H / R) lanes, R = 1-10 rows per
lane; :func:`cpmg_geometry`) and takes every ladder the gate admits.  The
Jacobian runs one warp per atom with its 24 planes (30 with diffusion)
across the lanes (``cpmg_jac.cu``); ``mse_jac_kernel_fits`` keeps the
gate of the earlier one-thread-per-atom layout, nstate <= 74 (59).
Neither gate moved with its layout, so that no train changed route.  The
published 18-echo train needs nstate 36.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import planes
from .cuda_fisp import SMEM_PER_BLOCK, _jac_finish, _takes_twin

__all__ = ["cpmg_dictionary_cuda", "cpmg_dictionary_plain", "cpmg_echoes",
           "cpmg_echoes_plain", "cpmg_jacobian_cuda", "cpmg_jacobian_plain",
           "cpmg_jacobian_echoes", "cpmg_jacobian_echoes_plain",
           "mse_kernel_fits", "mse_jac_kernel_fits", "cpmg_rows",
           "cpmg_geometry", "mse_jac_block_size", "jac_block_smem",
           "LAUNCHES", "JAC_LAUNCHES", "JAC_MAX_WARPS",
           "cpmg_dictionary_cuda_sharded",
           "cpmg_jacobian_cuda_sharded"]

#: primal kernel launches so far (diagnostics: proves a run went through it)
LAUNCHES = 0
#: Jacobian kernel launches so far
JAC_LAUNCHES = 0
#: atom-warps per block of the Jacobian kernel (cpmg_jac.cu's launch
#: bound: 256 threads)
JAC_MAX_WARPS = 8


def _planes(diffusion, jac):
    return (24 if jac else 6) + (6 if diffusion else 0)


def _smem(nstate, block, diffusion, jac):
    return 4 * _planes(diffusion, jac) * (int(nstate) + 1) * block


def mse_kernel_fits(nstate, diffusion=False) -> bool:
    """Whether the CPMG kernel takes this ladder: while 32 atoms' 6 planes
    (12 with diffusion) of nstate + 1 rows fit one block's shared memory,
    nstate <= 301 (150) -- the bound of the one-thread-per-atom layout, the
    JAX package's VMEM guard.  The segmented kernel keeps its planes in
    registers (:func:`cpmg_geometry`) and keeps this gate, so that the
    same trains take the kernel."""
    return _smem(max(int(nstate), 1), 32, bool(diffusion), False) \
        <= SMEM_PER_BLOCK


def mse_jac_kernel_fits(nstate, diffusion=False) -> bool:
    """Whether the CPMG Jacobian kernel takes this ladder: while 32 atoms'
    24 planes (30 with diffusion) fit one block's shared memory, nstate <=
    74 (59).  A block of the warp-row kernel holds at most
    ``JAC_MAX_WARPS`` ladders, so the layout itself would admit deeper
    ones; the gate stays where the one-thread-per-atom layout had it, so
    that the same trains take the kernel."""
    return _smem(max(int(nstate), 1), 32, bool(diffusion), True) \
        <= SMEM_PER_BLOCK


#: the segmented primal kernel (cpmg.cu): warps per block, echoes per
#: chunk at most, table floats per echo (cos phi, sin phi, cos 2phi, sin
#: 2phi, FA, tau1, tau2) and rows per lane at most -- its kMaxWarps,
#: kMaxEchoes, kTab and kMaxRows
CPMG_WARPS, CPMG_ECHOES, CPMG_TABLE, CPMG_MAX_ROWS = 4, 32, 7, 10


def cpmg_rows(nstate) -> int:
    """Rows per lane of the primal kernel for a ladder of H = nstate + 1
    rows: ceil(H / W) for the fewest lanes per ladder W >= 2 that keep it
    within CPMG_MAX_ROWS, rounded up to even above 1 (an odd instance
    takes up to 1.8x the registers of the next even one: 117 at R = 9, 64
    at R = 10; ptxas, PERF.md) -- 10 at the published nstate 36 (8
    ladders of 4 lanes per warp), measured 1.8x faster than 5 rows there,
    with DW-TSE and without (PERF.md), and at the gate's deepest ladders
    (nstate 301: 31 lanes; 150 with DW-TSE: 16 lanes)."""
    H = max(int(nstate), 1) + 1
    R = -(-H // max(2, -(-H // CPMG_MAX_ROWS)))
    return R + R % 2 if R > 1 else R


def cpmg_geometry(nstate, diffusion=False):
    """Launch geometry of the segmented primal kernel (``cpmg.cu``), the
    same with and without DW-TSE (`diffusion`):
    dict(R, W, L) -- rows per lane (:func:`cpmg_rows`), lanes per ladder
    W = ceil(H / R) (lane r of a segment owns rows r R + c, c < R) and
    ladders per warp L = 32 // W -- ``warps`` per block (CPMG_WARPS),
    ``atoms`` per block (warps x L), ``echoes`` per chunk (CPMG_ECHOES) and
    ``smem``, the block's shared bytes (its echo table).  The wrapper
    passes R, warps and echoes to the kernel, which checks them."""
    R = cpmg_rows(nstate)
    if R > CPMG_MAX_ROWS or -(-(max(int(nstate), 1) + 1) // R) > 32:
        raise ValueError(f"nstate={nstate}: beyond the CPMG kernel's "
                         f"{CPMG_MAX_ROWS} rows per lane")
    W = -(-(max(int(nstate), 1) + 1) // R)
    L = 32 // W
    return dict(R=R, W=W, L=L, warps=CPMG_WARPS, atoms=CPMG_WARPS * L,
                echoes=CPMG_ECHOES, smem=4 * CPMG_TABLE * CPMG_ECHOES)


def jac_block_smem(nstate, warps, diffusion=False) -> int:
    """Shared memory of one block of the Jacobian kernel: per atom-warp,
    one record per ladder row of its 24 plane values (30 with the DW-TSE
    factors) and one more, which makes the record odd (conflict-free)."""
    return 4 * (_planes(diffusion, True) + 1) * (int(nstate) + 1) * warps


def mse_jac_block_size(nstate, diffusion=False) -> int:
    """Atom-warps per block of the Jacobian kernel (one warp per atom):
    ``JAC_MAX_WARPS``, halved while they do not fit one block (8 at every
    ladder the gate admits: 60,000 bytes at its edges, nstate 74 and 59
    with diffusion; 29,600 at the published nstate 36, where an SM's
    shared memory holds 56 atom-warps and its registers decide how many
    run)."""
    warps = JAC_MAX_WARPS
    while warps > 1 and jac_block_smem(nstate, warps, bool(diffusion)) \
            > SMEM_PER_BLOCK:
        warps //= 2
    return warps


def _prepare(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, diffusion, diff_ramp,
             strict):
    """Normalize the arguments to tensors on T1s's device and dtype.

    Per-echo values become (E,) tensors (scalars broadcast), per-atom
    values (B,) tensors; ``diffusion=(bT1, bL1, bT2, bL2, Dc1, Dc2)``
    becomes python b-value bases and (B,) diffusivities.  With `strict`
    (the CUDA kernels) a tensor argument of another device or dtype, or a
    non-contiguous one, raises instead of being converted."""
    if not isinstance(T1s, torch.Tensor):
        raise TypeError("T1s must be a tensor: its device selects the "
                        "kernel (CUDA) or the plain twin (CPU)")
    dev, dt = T1s.device, T1s.dtype

    def vec(x, n, name):
        if isinstance(x, torch.Tensor):
            if strict and (x.device != dev or x.dtype != dt
                           or not x.is_contiguous()):
                raise ValueError(
                    f"{name}: expected a contiguous {dt} tensor on {dev}, "
                    f"got {x.dtype} on {x.device}")
            x = x.to(device=dev, dtype=dt)
        else:
            x = torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dt,
                                device=dev)
        if x.ndim == 0:
            x = x.expand(n).contiguous()
        if tuple(x.shape) != (n,):
            raise ValueError(f"{name}: expected shape ({n},), "
                             f"got {tuple(x.shape)}")
        return x

    if T1s.ndim != 1 or T1s.shape[0] < 1:
        raise ValueError(f"T1s: expected shape (B,) with B >= 1, "
                         f"got {tuple(T1s.shape)}")
    if np.ndim(FA) != 1 or len(FA) < 1:
        raise ValueError("FA: expected a non-empty (E,) refocusing train")
    FA = vec(FA, len(FA), "FA")
    E, B = FA.shape[0], T1s.shape[0]
    x = {"FA": FA, "phi": vec(phi, E, "phi"), "tau1": vec(tau1, E, "tau1"),
         "tau2": vec(tau2, E, "tau2"), "T1": vec(T1s, B, "T1s"),
         "T2": vec(T2s, B, "T2s"), "B1": vec(B1s, B, "B1s"),
         "exc": exc, "E": E, "B": B, "diff": None}
    if diffusion is not None:
        bT1, bL1, bT2, bL2, Dc1, Dc2 = diffusion
        x["diff"] = (float(bT1), float(bL1), float(bT2), float(bL2),
                     vec(Dc1, B, "Dc1"), vec(Dc2, B, "Dc2"))
        x["ramps"] = tuple(bool(r) for r in diff_ramp)
    return x


def _atts(x, H):
    """The two stages' attenuation rows (or None, None)."""
    if x["diff"] is None:
        return None, None
    bT1, bL1, bT2, bL2, Dc1, Dc2 = x["diff"]
    r1, r2 = x["ramps"]
    return (planes.diff_attenuation(bT1, bL1, Dc1, H, r1)[0],
            planes.diff_attenuation(bT2, bL2, Dc2, H, r2)[0])


def _stage(s, tau, T1, T2, att):
    """E(tau) -> S(1) [-> D] on one plane set."""
    E1 = torch.exp(-tau / T1)
    E2 = torch.exp(-tau / T2)
    return planes.attenuate(planes.shift_fold(planes.half_relax(s, E1, E2)),
                            att)


def _rot(x, i):
    """Rotation coefficients of refocusing pulse i (per atom: FA_i * B1)
    and the flip a it was built from."""
    deg = math.pi / 180.0
    ph = x["phi"][i] * deg
    cp, sp, c2p, s2p = planes.phase_terms(ph)
    a = x["FA"][i] * x["B1"] * deg
    return planes.rot_coeffs(a, cp, sp, c2p, s2p), a, (cp, sp, c2p, s2p)


def cpmg_echoes_plain(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *, nstate,
                      diffusion=None, diff_ramp=(True, True)):
    """Echo train (re, im), each (E, B), by the plain PyTorch recurrence
    (the kernel's twin), on T1s's device in T1s's dtype."""
    if int(nstate) < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    x = _prepare(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, diffusion,
                 diff_ramp, strict=False)
    T1, T2 = x["T1"], x["T2"]
    E, B, H = x["E"], x["B"], int(nstate) + 1
    att1, att2 = _atts(x, H)
    s = planes.excitation(x["exc"], H, B, T1.dtype, T1.device)
    out = torch.empty((2, E, B), dtype=T1.dtype, device=T1.device)
    for i in range(E):
        s = _stage(s, x["tau1"][i], T1, T2, att1)
        s = planes.apply_rot(_rot(x, i)[0], s)
        s = _stage(s, x["tau2"][i], T1, T2, att2)
        out[0, i] = s[0][0]
        out[1, i] = s[1][0]
    return out[0], out[1]


def cpmg_echoes(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *, nstate,
                diffusion=None, diff_ramp=(True, True)):
    """Echo train (re, im), each (E, B) float32: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    kw = dict(nstate=nstate, diffusion=diffusion, diff_ramp=diff_ramp)
    if _takes_twin(T1s, "CPMG"):
        return cpmg_echoes_plain(exc, FA, phi, tau1, tau2, T1s, T2s, B1s,
                                 **kw)
    return _launch(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, jac=False, **kw)


def _launch(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *, nstate, diffusion,
            diff_ramp, jac):
    global LAUNCHES, JAC_LAUNCHES
    from .. import _build

    what = "CPMG Jacobian" if jac else "CPMG"
    if T1s.dtype != torch.float32:
        raise TypeError(f"the {what} kernel computes in float32, got "
                        f"{T1s.dtype}")
    nstate = int(nstate)
    if nstate < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    use_diff = diffusion is not None
    fits = mse_jac_kernel_fits if jac else mse_kernel_fits
    if not fits(nstate, use_diff):
        raise ValueError(f"nstate={nstate}: the {what} kernel state does "
                         f"not fit in {SMEM_PER_BLOCK} bytes of shared memory")
    x = _prepare(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, diffusion,
                 diff_ramp, strict=True)
    E, B = x["E"], x["B"]
    out = torch.empty((8 if jac else 2, E, B), dtype=torch.float32,
                      device=T1s.device)
    if use_diff:
        bT1, bL1, bT2, bL2, Dc1, Dc2 = x["diff"]
        r1, r2 = x["ramps"]
    else:
        bT1 = bL1 = bT2 = bL2 = 0.0
        Dc1 = Dc2 = None
        r1 = r2 = True

    def ptr(t):
        return None if t is None else t.data_ptr()

    # asynchronous on the current stream; see cuda_fisp._launch on
    # temporaries
    lib = _build.load()
    if jac:
        fn, launch = lib.epg_cpmg_jac, (mse_jac_block_size(nstate,
                                                           use_diff),)
    else:
        geo = cpmg_geometry(nstate, use_diff)
        fn, launch = lib.epg_cpmg, (geo["R"], geo["warps"], geo["echoes"])
    rc = fn(*planes.excitation_terms(x["exc"]), ptr(x["FA"]), ptr(x["phi"]),
            ptr(x["tau1"]), ptr(x["tau2"]), ptr(x["T1"]), ptr(x["T2"]),
            ptr(x["B1"]),
            ptr(Dc1), ptr(Dc2), bT1, bL1, bT2, bL2, ptr(out), E, B, nstate,
            int(use_diff), int(r1), int(r2), *launch,
            T1s.device.index if T1s.device.index is not None
            else torch.cuda.current_device(),
            torch.cuda.current_stream(T1s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{'cpmg_jac' if jac else 'cpmg'} kernel launch "
                           f"failed: CUDA error {rc}")
    if jac:
        JAC_LAUNCHES += 1
        return _jac_views(out)
    LAUNCHES += 1
    return out[0], out[1]


def cpmg_dictionary_plain(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *,
                          nstate, diffusion=None, diff_ramp=(True, True)):
    """CPMG echo trains by the plain PyTorch twin of the kernel.

    Arguments as :func:`cpmg_dictionary_cuda`; any device, either
    precision.  Returns (re, im), each (B, E)."""
    re, im = cpmg_echoes_plain(exc, FA, phi, tau1, tau2, T1s, T2s, B1s,
                               nstate=nstate, diffusion=diffusion,
                               diff_ramp=diff_ramp)
    return re.T, im.T


def cpmg_dictionary_cuda(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *, nstate,
                         diffusion=None, diff_ramp=(True, True)):
    """CPMG echo trains via the fused CUDA kernel.

    Args mirror ``cpmg_dictionary_pallas``: exc = (alpha, phi) of the
    excitation (degrees, host scalars); FA, phi (E,) refocusing flips and
    phases (degrees; FA scales with the per-atom B1); tau1, tau2 (E,) or
    scalars, the pre- and post-refocusing delays (ms); T1s, T2s, B1s (B,)
    tensors whose device selects the kernel (CUDA, float32, contiguous) or
    the plain twin (CPU); nstate the ladder half-size (>= 2E is exact).
    ``diffusion=(bT1, bL1, bT2, bL2, Dc1, Dc2)`` adds the DW-TSE
    attenuation after each shift (b-value bases per squared state index;
    Dc scalars or (B,)), ``diff_ramp`` its per-stage gradient-ramp flags.

    Returns (re, im), each (B, E): transposed views of the kernel's (E, B)
    output."""
    re, im = cpmg_echoes(exc, FA, phi, tau1, tau2, T1s, T2s, B1s,
                         nstate=nstate, diffusion=diffusion,
                         diff_ramp=diff_ramp)
    return re.T, im.T


def cpmg_dictionary_cuda_sharded(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *,
                                 mesh, axis="atoms", **kw):
    """Atom-sharded :func:`cpmg_dictionary_cuda` over a device mesh
    (``cpmg_dictionary_pallas_sharded``): each entry of the mesh's `axis`
    runs the kernel (the plain twin on a CPU entry) on its atom shard; the
    axis size must divide the atom count, the echo train is replicated.
    Returns (re, im), each (B, E), on the mesh's first device."""
    from ..parallel.mesh import shard_map

    def local(t1, t2, b1, *train):
        return cpmg_dictionary_cuda(exc, *train, t1, t2, b1, **kw)

    return shard_map(local, mesh, [(T1s, 0), (T2s, 0), (B1s, 0)], axis=axis,
                     replicated=(FA, phi, tau1, tau2))


# -- the Jacobian: echoes + dS/d(T1, T2, B1) --


def _jac_views(out):
    """((re, im), (dre, dim)) views of an (8, E, B) output buffer: (E, B)
    echoes and (E, B, 3) tangents ordered (T1, T2, B1)."""
    return (out[0], out[1]), (out[2::2].permute(1, 2, 0),
                              out[3::2].permute(1, 2, 0))


def _jac_stage(sets, tau, T1, T2, att):
    """E(tau) -> S(1) [-> D] on (primal, dT1, dT2, dB1): the tangent rules
    of ``_kernel_mse_jac`` (the attenuation is parameter-free for (T1, T2,
    B1), so it multiplies every set alike)."""
    P, G1, G2, GB = sets
    E1 = torch.exp(-tau / T1)
    E2 = torch.exp(-tau / T2)
    dE1 = E1 * tau / (T1 * T1)
    dE2 = E2 * tau / (T2 * T2)
    n1, n2 = planes.half_relax_tangents(P, G1, G2, E1, E2, dE1, dE2)
    new = (planes.half_relax(P, E1, E2), n1, n2,
           tuple(GB[j] * E2 for j in range(4)) + (GB[4] * E1, GB[5] * E1))
    return [planes.attenuate(planes.shift_fold(s), att) for s in new]


def cpmg_jacobian_echoes_plain(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *,
                               nstate, diffusion=None,
                               diff_ramp=(True, True)):
    """Echoes (re, im), each (E, B), and tangents (dre, dim), each
    (E, B, 3) ordered (T1, T2, B1), by the plain PyTorch recurrence (the
    Jacobian kernel's twin), on T1s's device and dtype."""
    if int(nstate) < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    x = _prepare(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, diffusion,
                 diff_ramp, strict=False)
    T1, T2 = x["T1"], x["T2"]
    E, B, H = x["E"], x["B"], int(nstate) + 1
    att1, att2 = _atts(x, H)
    z = torch.zeros((H, B), dtype=T1.dtype, device=T1.device)
    sets = [planes.excitation(x["exc"], H, B, T1.dtype, T1.device)] + [
        [z.clone() for _ in range(6)] for _ in range(3)]
    deg = math.pi / 180.0
    out = torch.empty((8, E, B), dtype=T1.dtype, device=T1.device)
    for i in range(E):
        sets = _jac_stage(sets, x["tau1"][i], T1, T2, att1)
        rc, a, ph = _rot(x, i)
        drc = planes.rot_coeffs_db1(a, x["FA"][i] * deg, *ph)
        P, G1, G2, GB = sets
        C = planes.apply_rot(drc, P)      # the B1 coefficient pass
        rB = planes.apply_rot(rc, GB)
        sets = [planes.apply_rot(rc, P), planes.apply_rot(rc, G1),
                planes.apply_rot(rc, G2),
                tuple(r + c for r, c in zip(rB, C))]
        sets = _jac_stage(sets, x["tau2"][i], T1, T2, att2)
        for g, s in enumerate(sets):
            out[2 * g, i] = s[0][0]
            out[2 * g + 1, i] = s[1][0]
    return _jac_views(out)


def cpmg_jacobian_echoes(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *, nstate,
                         diffusion=None, diff_ramp=(True, True)):
    """Echoes (E, B) and tangents (E, B, 3) in float32: the CUDA Jacobian
    kernel for CUDA tensors, the plain twin for CPU tensors."""
    kw = dict(nstate=nstate, diffusion=diffusion, diff_ramp=diff_ramp)
    if _takes_twin(T1s, "CPMG Jacobian"):
        return cpmg_jacobian_echoes_plain(exc, FA, phi, tau1, tau2, T1s,
                                          T2s, B1s, **kw)
    return _launch(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, jac=True, **kw)


def cpmg_jacobian_plain(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *, nstate,
                        diffusion=None, diff_ramp=(True, True)):
    """CPMG echo trains and Jacobian by the plain PyTorch twin of the
    kernel.  Arguments and returns as :func:`cpmg_jacobian_cuda`; any
    device, either precision."""
    return _jac_finish(cpmg_jacobian_echoes_plain(
        exc, FA, phi, tau1, tau2, T1s, T2s, B1s, nstate=nstate,
        diffusion=diffusion, diff_ramp=diff_ramp))


def cpmg_jacobian_cuda(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *, nstate,
                       diffusion=None, diff_ramp=(True, True)):
    """CPMG echo trains + dS/d(T1, T2, B1) via the fused CUDA kernel.

    Arguments as :func:`cpmg_dictionary_cuda` (the DW-TSE stages multiply
    primal and tangent planes alike).  B1 scales the refocusing flips
    only: the scalar excitation is exact, so every tangent starts at zero.
    Returns ((re, im), (dre, dim)): (B, E) echo trains and (B, E, 3)
    derivatives ordered (T1, T2, B1), as views of the kernel's (E, B)
    outputs."""
    return _jac_finish(cpmg_jacobian_echoes(
        exc, FA, phi, tau1, tau2, T1s, T2s, B1s, nstate=nstate,
        diffusion=diffusion, diff_ramp=diff_ramp))


def cpmg_jacobian_cuda_sharded(exc, FA, phi, tau1, tau2, T1s, T2s, B1s, *,
                               mesh, axis="atoms", **kw):
    """Atom-sharded :func:`cpmg_jacobian_cuda` over a device mesh
    (``cpmg_jacobian_pallas_sharded``), as
    :func:`cpmg_dictionary_cuda_sharded`.  Returns ((re, im), (dre, dim)):
    (B, E) echo trains and (B, E, 3) derivatives, on the mesh's first
    device."""
    from ..parallel.mesh import shard_map

    def local(t1, t2, b1, *train):
        return cpmg_jacobian_cuda(exc, *train, t1, t2, b1, **kw)

    return shard_map(local, mesh, [(T1s, 0), (T2s, 0), (B1s, 0)], axis=axis,
                     replicated=(FA, phi, tau1, tau2))
