"""FISP MR-fingerprinting dictionary and Jacobian: CUDA kernels, plain twins.

Counterpart of ``epgpy_tpu/models/pallas_fisp.py:fisp_dictionary_pallas``
(:899) with its folded half-ladder kernel ``_kernel_half`` (:270).  The
kernel is ``epgpy_torch/csrc/fisp_half.cu`` (see its header for the
design); ``fisp_dictionary_plain`` is the same recurrence with the same
operation order, vectorised over atoms as (6, nstate+1, B) planes in a
Python loop over pulses.  It runs on the tensors' device in either
precision and is what the CPU tests check and what the kernel is held
against on the card.

``fisp_dictionary_cuda`` takes the kernel for CUDA tensors (and raises on
what the kernel does not take: no fallback) and the plain twin for CPU
tensors.  ``LAUNCHES`` counts kernel launches.  The kernel runs the
segmented layout with blocked rows (a ladder's rows across a segment of a
warp's lanes, R consecutive rows per lane, the state in registers);
``fisp_half_geometry`` gives its launch geometry, and ``half_rows`` the
rows per lane that ``composite.cu`` takes too.  The TPU-only knobs of the
JAX signature (``btile``, ``pchunk``, ``interpret``, ``half_ladder``) are
not taken: there is no padding.

The full-ladder kernel (``_kernel`` :116, ``fisp_dictionary_pallas``'s
``half_ladder=False``) is ``fisp_full_ladder_cuda`` / ``_plain`` (kernel
``epgpy_torch/csrc/fisp_full.cu``: the literal 2 nstate + 1 rows, no
diffusion; ``FULL_LAUNCHES``).  The dictionary functions take it at
``nstate < 1``, where the fold has no k = 1 row, as the JAX wrapper does
(``pallas_fisp.py:957``); otherwise it is the fold's parity oracle.  Its
twin is also ``models/mrf.py``'s full-ladder model.

The Jacobian (``fisp_jacobian_pallas`` :775 with ``_kernel_jac`` :458)
follows the same pattern: ``fisp_jacobian_cuda`` / ``fisp_jacobian_plain``
(kernel ``epgpy_torch/csrc/fisp_jac.cu``; fingerprints and dS/d(T1, T2,
B1[, D]) in one pass), the echo-layout ``fisp_jacobian_echoes[_plain]``
that the dispatch uses, and ``JAC_LAUNCHES``.  Its kernel, like
``megre_jac.cu``, runs the segmented layout (a ladder's rows across a
segment of a warp's lanes, several ladders per warp, the state in
registers); ``seg_layout`` and ``seg_geometry`` give its launch geometry,
``fisp_jac_geometry`` the FISP kernel's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import planes

__all__ = ["fisp_dictionary_cuda", "fisp_dictionary_plain", "fisp_echoes",
           "fisp_echoes_plain", "kernel_fits", "block_size", "SMEM_PER_BLOCK",
           "fisp_jacobian_cuda", "fisp_jacobian_plain", "fisp_jacobian_echoes",
           "fisp_jacobian_echoes_plain", "jac_kernel_fits",
           "seg_layout", "seg_geometry", "fisp_jac_geometry", "half_rows",
           "half_static_rows", "fisp_half_geometry",
           "fisp_full_ladder_cuda", "fisp_full_ladder_plain",
           "fisp_full_echoes", "fisp_full_echoes_plain", "full_kernel_fits",
           "full_block_size"]

#: kernel launches so far (diagnostics: proves a run went through it)
LAUNCHES = 0
#: Jacobian kernel launches so far
JAC_LAUNCHES = 0
#: full-ladder kernel launches so far
FULL_LAUNCHES = 0

#: shared memory one block may use on sm_90 (H100), bytes
SMEM_PER_BLOCK = 232448
_PLANES = 6


def _smem_bytes(nstate, block):
    return 4 * _PLANES * (int(nstate) + 1) * block


def kernel_fits(nstate) -> bool:
    """The FISP dictionary kernel's gate (also DESS's, ME-GRE's and
    DW-FISP's): while 6 planes x (nstate+1) rows x 32 atoms x 4 bytes fit
    one block's shared memory, nstate <= 301 -- the bound of the
    thread-per-atom layout.  The segmented kernel keeps its planes in
    registers (:func:`fisp_half_geometry`) and keeps this gate, so that no
    train changes route."""
    return _smem_bytes(nstate, 32) <= SMEM_PER_BLOCK


def block_size(nstate) -> int:
    """Threads per block of the thread-per-atom kernel ``dess.cu``: 128,
    halved while the state does not fit."""
    block = 128
    while block > 32 and _smem_bytes(nstate, block) > SMEM_PER_BLOCK:
        block //= 2
    return block


def _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, diffusion,
             strict):
    """Normalize the arguments to tensors on T1s's device and dtype.

    Per-pulse values become (P,) tensors (scalars broadcast), per-atom
    values (B,) tensors, TE a python float or a (P,) tensor.  With
    `strict` (the CUDA kernel) a tensor argument of another device, dtype
    or shape, or a non-contiguous one, raises instead of being converted.
    """
    if not isinstance(T1s, torch.Tensor):
        raise TypeError("T1s must be a tensor: its device selects the "
                        "kernel (CUDA) or the plain twin (CPU)")
    dev, dt = T1s.device, T1s.dtype
    B = T1s.shape[0] if T1s.ndim == 1 else -1

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

    if B < 1:
        raise ValueError(f"T1s: expected shape (B,) with B >= 1, "
                         f"got {tuple(T1s.shape)}")
    if np.ndim(FA) != 1 or len(FA) < 1:
        raise ValueError("FA: expected a non-empty (P,) pulse train")
    FA = vec(FA, len(FA), "FA")
    P = FA.shape[0]
    x = {"FA": FA, "phi": vec(phi, P, "phi"), "TR": vec(TR, P, "TR"),
         "T1": vec(T1s, B, "T1s"), "T2": vec(T2s, B, "T2s"),
         "B1": vec(B1s, B, "B1s"),
         "df": None if dfs is None else vec(dfs, B, "dfs"),
         "TI": None if inversion is None else float(inversion),
         "P": P, "B": B}
    if np.ndim(TE) == 0:
        x["TE"] = float(TE)
    else:
        x["TE"] = vec(TE, P, "TE")
    if diffusion is not None:
        bT, bL, Dc = diffusion
        x["diff"] = (float(bT), float(bL), vec(Dc, B, "Dc"))
    else:
        x["diff"] = None
    return x


def _full_ladder(nstate, diffusion):
    """Whether a dictionary call takes the full-ladder kernel: at nstate 0
    (the fold needs a k = 1 row); raises below 0, and for diffusion there,
    which the JAX wrapper takes only on the half ladder."""
    if int(nstate) < 0:
        raise ValueError(f"nstate must be >= 0, got {nstate}")
    if int(nstate) >= 1:
        return False
    if diffusion is not None:
        raise ValueError("diffusion requires the half-ladder kernel "
                         "(nstate >= 1)")
    return True


def _takes_twin(T1s, what):
    """Whether a wrapper runs the plain twin (CPU tensors) rather than the
    CUDA kernel (CUDA tensors); raises for anything else."""
    if not isinstance(T1s, torch.Tensor):
        raise TypeError("T1s must be a tensor: its device selects the "
                        "kernel (CUDA) or the plain twin (CPU)")
    if T1s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {T1s.device}")
    return T1s.device.type == "cpu"


def fisp_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                      nstate=10, demodulate=False, inversion=None,
                      inversion_df=True, diffusion=None, diff_ramp=True):
    """Echo train (re, im), each (P, B), by the plain PyTorch recurrence
    (the kernel's twin), on T1s's device in T1s's dtype; nstate 0 takes
    the full-ladder twin."""
    if _full_ladder(nstate, diffusion):
        return fisp_full_echoes_plain(
            FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
            demodulate=demodulate, inversion=inversion,
            inversion_df=inversion_df)
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, diffusion,
                 strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    P, B, H = x["P"], x["B"], int(nstate) + 1
    use_df = DF is not None
    z = torch.zeros((H, B), dtype=T1.dtype, device=T1.device)
    s = [z.clone() for _ in range(6)]
    if x["TI"] is not None:
        TI = x["TI"]
        (fpi, z0), _ = planes.inversion_prep(B1, T1, T2, TI)
        if use_df and inversion_df:
            th = 2 * math.pi * DF * TI
            cth, sth = torch.cos(th), torch.sin(th)
            s[0][0] = -fpi * sth
            s[1][0] = fpi * cth
            s[2][0] = -fpi * sth
            s[3][0] = fpi * cth
        else:
            s[1][0] = fpi
            s[3][0] = fpi
        s[4][0] = z0
    else:
        s[4][0] = 1.0

    deg = math.pi / 180.0
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * deg)
    var_te = isinstance(x["TE"], torch.Tensor)
    if not var_te:
        te = x["TE"]
        e1te, e2te = torch.exp(-te / T1), torch.exp(-te / T2)
    if x["diff"] is not None:
        bT, bL, Dc = x["diff"]
        (aA, aB, aZ), _ = planes.diff_attenuation(bT, bL, Dc, H, diff_ramp)

    out_re = torch.empty((P, B), dtype=T1.dtype, device=T1.device)
    out_im = torch.empty_like(out_re)
    FA, TR = x["FA"], x["TR"]
    for i in range(P):
        if var_te:
            te = x["TE"][i]
            e1te, e2te = torch.exp(-te / T1), torch.exp(-te / T2)
        rc = planes.rot_coeffs(FA[i] * B1 * deg, cp[i], sp[i], c2p[i],
                               s2p[i])
        rem = TR[i] - te
        E1b = torch.exp(-rem / T1)
        E2b = torch.exp(-rem / T2)
        cF = e2te * E2b
        cZ = e1te * E1b
        rec = (1.0 - e1te) * E1b + (1.0 - E1b)
        rAR, rAI, rBR, rBI, rZR, rZI = planes.apply_rot(rc, s)

        # echo from the k = 0 row after rotation and TE decay
        eR, eI = rAR[0] * e2te, rAI[0] * e2te
        if use_df:
            ang_te = 2 * math.pi * DF * te
            eR, eI = planes.cmul(torch.cos(ang_te), torch.sin(ang_te), eR, eI)
        if demodulate:
            eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
        out_re[i] = eR
        out_im[i] = eI

        if use_df:
            ang = 2 * math.pi * DF * (te + rem)
            cFr, cFi = cF * torch.cos(ang), cF * torch.sin(ang)
            nAR, nAI = planes.cmul(cFr, cFi, rAR, rAI)
            nBR, nBI = planes.cmul(cFr, cFi, rBR, rBI)
        else:
            nAR, nAI, nBR, nBI = cF * rAR, cF * rAI, cF * rBR, cF * rBI
        nZR = cZ * rZR
        nZR[0] = nZR[0] + rec
        s = planes.shift_fold((nAR, nAI, nBR, nBI, nZR, cZ * rZI))
        if x["diff"] is not None:
            s = (s[0] * aA, s[1] * aA, s[2] * aB, s[3] * aB, s[4] * aZ,
                 s[5] * aZ)
    return out_re, out_im


def fisp_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *, nstate=10,
                demodulate=False, inversion=None, inversion_df=True,
                diffusion=None, diff_ramp=True):
    """Echo train (re, im), each (P, B) float32: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors; nstate 0 takes the
    full-ladder kernel."""
    if _full_ladder(nstate, diffusion):
        return fisp_full_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs,
                                nstate=nstate, demodulate=demodulate,
                                inversion=inversion,
                                inversion_df=inversion_df)
    kw = dict(nstate=nstate, demodulate=demodulate, inversion=inversion,
              inversion_df=inversion_df, diffusion=diffusion,
              diff_ramp=diff_ramp)
    if _takes_twin(T1s, "FISP"):
        return fisp_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs, **kw)
    return _launch(FA, phi, TR, TE, T1s, T2s, B1s, dfs, **kw)


def _launch(FA, phi, TR, TE, T1s, T2s, B1s, dfs, *, nstate, demodulate,
            inversion, inversion_df, diffusion, diff_ramp):
    global LAUNCHES
    from .. import _build

    if T1s.dtype != torch.float32:
        raise TypeError(f"the FISP kernel computes in float32, got {T1s.dtype}")
    nstate = int(nstate)
    if not kernel_fits(nstate):
        raise ValueError(f"nstate={nstate}: the kernel state does not fit "
                         f"in {SMEM_PER_BLOCK} bytes of shared memory")
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, diffusion,
                 strict=True)
    P, B = x["P"], x["B"]
    out = torch.empty((2, P, B), dtype=torch.float32, device=T1s.device)
    var_te = isinstance(x["TE"], torch.Tensor)
    bT, bL, Dc = x["diff"] if x["diff"] is not None else (0.0, 0.0, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # The launch is asynchronous on PyTorch's current stream.  Temporaries
    # made by _prepare may be freed when this returns: the caching
    # allocator hands their memory out again only in that stream's order,
    # so the kernel has read them first.
    geo = fisp_half_geometry(nstate, x["diff"] is not None)
    lib = _build.load()
    rc = lib.epg_fisp_half(
        ptr(x["FA"]), ptr(x["phi"]), ptr(x["TR"]),
        ptr(x["TE"]) if var_te else None, 0.0 if var_te else x["TE"],
        0.0 if x["TI"] is None else x["TI"],
        ptr(x["T1"]), ptr(x["T2"]), ptr(x["B1"]), ptr(x["df"]), ptr(Dc),
        bT, bL, ptr(out), P, B, nstate,
        int(var_te), int(x["TI"] is not None), int(bool(inversion_df)),
        int(x["df"] is not None), int(bool(demodulate)),
        int(x["diff"] is not None), int(bool(diff_ramp)), geo["R"],
        geo["warps"], geo["pulses"],
        T1s.device.index if T1s.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(T1s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fisp_half kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out[0], out[1]


def _finish(re, im, normalize):
    """(B, P) views of the (P, B) echoes, optionally unit-norm per atom
    (the matched-filter dictionary epilogue)."""
    re, im = re.T, im.T
    if normalize:
        nrm = torch.sqrt(torch.sum(re * re + im * im, dim=-1, keepdim=True))
        scale = torch.where(nrm > 0, 1.0 / nrm, torch.zeros_like(nrm))
        re, im = re * scale, im * scale
    return re, im


def fisp_dictionary_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                          nstate=10, demodulate=False, inversion=None,
                          inversion_df=True, normalize=False,
                          diffusion=None, diff_ramp=True):
    """FISP MRF dictionary by the plain PyTorch twin of the kernel.

    Arguments as :func:`fisp_dictionary_cuda`; any device, either
    precision.  Returns (re, im), each (B, P)."""
    re, im = fisp_echoes_plain(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate, inversion=inversion,
        inversion_df=inversion_df, diffusion=diffusion, diff_ramp=diff_ramp)
    return _finish(re, im, normalize)


def fisp_dictionary_cuda(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                         nstate=10, demodulate=False, inversion=None,
                         inversion_df=True, normalize=False,
                         diffusion=None, diff_ramp=True):
    """FISP MRF dictionary via the fused CUDA kernel.

    Args mirror ``fisp_dictionary_pallas``: FA (P,) flip angles (deg);
    phi and TR scalars or (P,); TE a scalar or (P,) (ms); T1s, T2s, B1s
    and the optional off-resonance dfs (kHz) (B,) tensors, whose device
    selects the kernel (CUDA, float32, contiguous) or the plain twin
    (CPU).  ``inversion`` (TI, ms) prepends a 180*B1 inversion, whose
    residual F+ precesses by df during TI when ``inversion_df``.
    ``diffusion=(bT, bL, Dc)`` adds the DW-FISP post-shift attenuation
    (``diff_ramp=False`` drops the gradient-ramp 1/3 term).
    ``normalize`` returns unit-norm fingerprints.

    Returns (re, im), each (B, P): transposed views of the kernel's
    (P, B) output unless normalized.
    """
    re, im = fisp_echoes(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate, inversion=inversion,
        inversion_df=inversion_df, diffusion=diffusion, diff_ramp=diff_ramp)
    return _finish(re, im, normalize)


# -- the Jacobian: fingerprints + dS/d(T1, T2, B1[, D]) --


def _jac_planes(track_diffusivity):
    return 30 if track_diffusivity else 24


def jac_kernel_fits(nstate, track_diffusivity=False) -> bool:
    """The Jacobian kernels' gate: 24 (30 with D) planes x (nstate+1) rows
    x 32 atoms x 4 bytes within one block's shared memory -- nstate <= 74
    (59).  It is the thread-per-atom layout's bound.  The FISP, ME-GRE and
    DESS Jacobian kernels keep their state in registers, at most 3 rows per
    lane (nstate <= 95), and keep this gate so that no train changes
    route."""
    return (4 * _jac_planes(track_diffusivity) * (int(nstate) + 1) * 32
            <= SMEM_PER_BLOCK)


#: the segmented tangent kernels (fisp_jac.cu, megre_jac.cu, dess_jac.cu;
#: xgre_jac.cu takes the first three): warps per block at most, pulses per
#: chunk at most, floats of one chunk's table and staged echoes per block
#: (48 KB), table floats per pulse -- the kernels' kMaxWarps, kMaxPulses,
#: kChunkFloats and kTab
SEG_WARPS, SEG_PULSES, SEG_CHUNK_FLOATS, SEG_TABLE = 4, 32, 12288, 8


def seg_layout(nstate, R=None):
    """(R, W, L) of the segmented layout for a ladder of H = nstate + 1
    rows: rows per lane (``epg::seg_rows``: 2, 3 past 64 rows, 1 for H <=
    3; or the given R), lanes per ladder (W = ceil(H / R); lane r of a
    segment owns rows r + W c, c < R) and ladders per warp (32 // W)."""
    H = int(nstate) + 1
    if R is None:
        R = 1 if H <= 3 else (2 if H <= 64 else 3)
    W = -(-H // R)
    return R, W, 32 // W


def seg_geometry(nstate, outputs, table=SEG_TABLE, R=None):
    """Launch geometry of a segmented tangent kernel whose atoms each stage
    `outputs` floats per pulse beside a `table` of floats per pulse:
    dict(R, W, L) of :func:`seg_layout` (at R rows per lane when given),
    ``warps`` per block (SEG_WARPS, halved while one pulse's table and
    staged outputs pass SEG_CHUNK_FLOATS), ``atoms`` per block (warps x L),
    ``pulses`` per chunk and ``smem``, the block's shared bytes (the
    kernels compute the same from ``warps``)."""
    R, W, L = seg_layout(nstate, R)
    outputs = int(outputs)
    warps = SEG_WARPS
    while warps > 1 and table + outputs * warps * L > SEG_CHUNK_FLOATS:
        warps //= 2
    per = table + outputs * warps * L
    pulses = min(SEG_PULSES, max(1, SEG_CHUNK_FLOATS // per))
    return dict(R=R, W=W, L=L, warps=warps, atoms=warps * L, pulses=pulses,
                smem=4 * pulses * per)


#: the segmented primal kernels (fisp_half.cu; composite.cu takes the
#: rows): table floats per pulse and the rows per lane they take (1 or
#: even, as an odd R takes up to 1.8x the registers of the next even one,
#: PERF.md) -- the kernels' kTab and kMaxRows
HALF_TABLE, HALF_ROWS = 8, (1, 2, 4, 6, 8, 10, 12)
HALF_MAX_ROWS = HALF_ROWS[-1]


def half_rows(nstate) -> int:
    """Rows per lane of the segmented primal kernels for a ladder of H =
    max(nstate, 0) + 1 rows: ceil(H / W) for the fewest lanes W that keep
    it within HALF_MAX_ROWS, rounded up to even above 1 -- 12 on one lane
    at the FISP headline's nstate 10, 10 at MPRAGE's nstate 8, 12 on 26
    lanes at the gate's nstate 301.  One lane per ladder measured fastest
    at nstate 10 and 8 (2.39 ms against 3.59-4.35 on 2, 3 or 6 lanes,
    PERF.md)."""
    H = max(int(nstate), 0) + 1
    R = -(-H // -(-H // HALF_MAX_ROWS))
    return R + R % 2 if R > 1 else R


def half_static_rows(nstate, R) -> int:
    """The static ladder length of the primal kernels' instance that a
    ladder of H = nstate + 1 rows takes at R rows per lane: H when one lane
    holds it at R = H rounded up to even (``fisp_half.cu``'s and
    ``composite.cu``'s launch_r), else 0 (the instance of R, any H)."""
    H = max(int(nstate), 0) + 1
    return H if R >= H and R - H in (0, 1) and (R >= 2 or H == 1) else 0


def fisp_half_geometry(nstate, diffusion=False):
    """Launch geometry of the segmented FISP dictionary kernel
    (``fisp_half.cu``): :func:`seg_geometry` at :func:`half_rows`,
    each atom staging its echo (re, im) per pulse beside HALF_TABLE table
    floats -- dict(R, W, L) (lane r of a segment owns rows r R + c, c <
    R), ``warps`` per block, ``atoms`` per block, ``pulses`` per chunk and
    ``smem`` -- with `diffusion`, also each thread's 3 R attenuation
    factors (the kernel computes the same).  The wrapper passes R, warps
    and pulses to the kernel, which checks them."""
    geo = seg_geometry(nstate, 2, HALF_TABLE, half_rows(nstate))
    if diffusion:
        geo["smem"] += 4 * 3 * geo["R"] * geo["warps"] * 32
    return geo


def fisp_jac_geometry(nstate, track_diffusivity=False):
    """:func:`seg_geometry` of the FISP Jacobian kernel: 2 + 2G staged
    floats per atom and pulse (G = 3, or 4 with D)."""
    return seg_geometry(nstate, 2 + 2 * (4 if track_diffusivity else 3))


def _jac_views(out):
    """((re, im), (dre, dim)) views of a (2 + 2G, P, B) output buffer:
    (P, B) echoes and (P, B, G) tangents."""
    return (out[0], out[1]), (out[2::2].permute(1, 2, 0),
                              out[3::2].permute(1, 2, 0))


def fisp_jacobian_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                               nstate=10, demodulate=False, inversion=None,
                               inversion_df=True, diffusion=None,
                               diff_ramp=True, track_diffusivity=False):
    """Echoes (re, im), each (P, B), and tangents (dre, dim), each
    (P, B, 3[+1]) ordered (T1, T2, B1[, D]), by the plain PyTorch
    recurrence (the Jacobian kernel's twin), on T1s's device and dtype."""
    if int(nstate) < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    track_d = bool(track_diffusivity)
    if track_d and diffusion is None:
        raise ValueError("track_diffusivity requires diffusion=")
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, diffusion,
                 strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    P, B, H = x["P"], x["B"], int(nstate) + 1
    G = 4 if track_d else 3
    use_df = DF is not None
    z = torch.zeros((H, B), dtype=T1.dtype, device=T1.device)
    # st[g]: plane set of group g (0 primal, then dT1, dT2, dB1[, dD])
    st = [[z.clone() for _ in range(6)] for _ in range(G + 1)]
    if x["TI"] is not None:
        TI = x["TI"]
        (fpi, z0), (d1z0, d2fpi, bfpi, bz0) = planes.inversion_prep(
            B1, T1, T2, TI)
        st[0][4][0], st[1][4][0], st[3][4][0] = z0, d1z0, bz0
        seeds = ((0, fpi), (2, d2fpi), (3, bfpi))
        if use_df and inversion_df:
            th = 2 * math.pi * DF * TI
            cth, sth = torch.cos(th), torch.sin(th)
            for g, val in seeds:
                st[g][0][0], st[g][1][0] = -val * sth, val * cth
                st[g][2][0], st[g][3][0] = -val * sth, val * cth
        else:
            for g, val in seeds:
                st[g][1][0], st[g][3][0] = val, val
    else:
        st[0][4][0] = 1.0

    deg = math.pi / 180.0
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * deg)
    var_te = isinstance(x["TE"], torch.Tensor)

    def te_terms(te):
        e2te = torch.exp(-te / T2)
        pte = None
        if use_df:
            ang = 2 * math.pi * DF * te
            pte = (torch.cos(ang), torch.sin(ang))
        return torch.exp(-te / T1), e2te, e2te * te / (T2 * T2), pte

    if not var_te:
        te = x["TE"]
        e1te, e2te, de2te, pte = te_terms(te)
    if x["diff"] is not None:
        bT, bL, Dc = x["diff"]
        att, datt = planes.diff_attenuation(bT, bL, Dc, H, diff_ramp)
        att = (att[0], att[0], att[1], att[1], att[2], att[2])
        datt = (datt[0], datt[0], datt[1], datt[1], datt[2], datt[2])

    out = torch.empty((2 + 2 * G, P, B), dtype=T1.dtype, device=T1.device)
    FA, TR = x["FA"], x["TR"]
    for i in range(P):
        if var_te:
            te = x["TE"][i]
            e1te, e2te, de2te, pte = te_terms(te)
        a = FA[i] * B1 * deg
        rc = planes.rot_coeffs(a, cp[i], sp[i], c2p[i], s2p[i])
        drc = planes.rot_coeffs_db1(a, FA[i] * deg, cp[i], sp[i], c2p[i],
                                    s2p[i])
        TRi = TR[i]
        rem = TRi - te
        E1b = torch.exp(-rem / T1)
        E2b = torch.exp(-rem / T2)
        cF = e2te * E2b
        cZ = e1te * E1b
        rec = 1.0 - cZ            # == (1 - E1te) E1b + (1 - E1b)
        dcZ, dcF = planes.relax_tangents(cZ, cF, TRi, T1, T2)
        if use_df:
            ang = 2 * math.pi * DF * TRi
            cpR, cpI = torch.cos(ang), torch.sin(ang)
            cFc, dcFc = (cF * cpR, cF * cpI), (dcF * cpR, dcF * cpI)

            def fmul(re, im, c=cFc):
                return planes.cmul(c[0], c[1], re, im)

            def dfmul(re, im, c=dcFc):
                return planes.cmul(c[0], c[1], re, im)
        else:
            def fmul(re, im, c=cF):
                return c * re, c * im

            def dfmul(re, im, c=dcF):
                return c * re, c * im

        R = [planes.apply_rot(rc, g) for g in st]   # rotated groups
        C = planes.apply_rot(drc, st[0])            # B1 coefficient pass

        def write(o, eR, eI):
            if use_df:
                eR, eI = planes.cmul(pte[0], pte[1], eR, eI)
            if demodulate:
                eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
            out[2 * o, i] = eR
            out[2 * o + 1, i] = eI

        p0, r1, r2, r3 = R[:4]
        write(0, e2te * p0[0][0], e2te * p0[1][0])
        write(1, e2te * r1[0][0], e2te * r1[1][0])
        write(2, e2te * r2[0][0] + de2te * p0[0][0],
              e2te * r2[1][0] + de2te * p0[1][0])
        write(3, e2te * (r3[0][0] + C[0][0]), e2te * (r3[1][0] + C[1][0]))
        if track_d:
            write(4, e2te * R[4][0][0], e2te * R[4][1][0])

        pZ = cZ * p0[4]
        pZ[0] = pZ[0] + rec
        t1Z = cZ * r1[4] + dcZ * p0[4]
        t1Z[0] = t1Z[0] - dcZ
        xa, xb = dfmul(p0[0], p0[1]), dfmul(p0[2], p0[3])
        ta, tb = fmul(r2[0], r2[1]), fmul(r2[2], r2[3])
        new = [
            fmul(p0[0], p0[1]) + fmul(p0[2], p0[3]) + (pZ, cZ * p0[5]),
            fmul(r1[0], r1[1]) + fmul(r1[2], r1[3])
            + (t1Z, cZ * r1[5] + dcZ * p0[5]),
            (ta[0] + xa[0], ta[1] + xa[1], tb[0] + xb[0], tb[1] + xb[1],
             cZ * r2[4], cZ * r2[5]),
            fmul(r3[0] + C[0], r3[1] + C[1]) + fmul(r3[2] + C[2], r3[3] + C[3])
            + (cZ * (r3[4] + C[4]), cZ * (r3[5] + C[5])),
        ]
        if track_d:
            r4 = R[4]
            new.append(fmul(r4[0], r4[1]) + fmul(r4[2], r4[3])
                       + (cZ * r4[4], cZ * r4[5]))
        st = [planes.shift_fold(n) for n in new]
        if x["diff"] is not None:
            psh = st[0]
            st = [tuple(v * a for v, a in zip(g, att)) for g in st]
            if track_d:
                st[4] = tuple(v + d * q for v, d, q in zip(st[4], datt, psh))
    return _jac_views(out)


def fisp_jacobian_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                         nstate=10, demodulate=False, inversion=None,
                         inversion_df=True, diffusion=None, diff_ramp=True,
                         track_diffusivity=False):
    """Echoes (P, B) and tangents (P, B, 3[+1]) in float32: the CUDA
    Jacobian kernel for CUDA tensors, the plain twin for CPU tensors."""
    kw = dict(nstate=nstate, demodulate=demodulate, inversion=inversion,
              inversion_df=inversion_df, diffusion=diffusion,
              diff_ramp=diff_ramp, track_diffusivity=track_diffusivity)
    if _takes_twin(T1s, "FISP Jacobian"):
        return fisp_jacobian_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s,
                                          dfs, **kw)
    return _launch_jac(FA, phi, TR, TE, T1s, T2s, B1s, dfs, **kw)


def _launch_jac(FA, phi, TR, TE, T1s, T2s, B1s, dfs, *, nstate, demodulate,
                inversion, inversion_df, diffusion, diff_ramp,
                track_diffusivity):
    global JAC_LAUNCHES
    from .. import _build

    if T1s.dtype != torch.float32:
        raise TypeError(f"the FISP Jacobian kernel computes in float32, got "
                        f"{T1s.dtype}")
    nstate = int(nstate)
    track_d = bool(track_diffusivity)
    if nstate < 1:
        raise ValueError("the folded ladder needs nstate >= 1")
    if track_d and diffusion is None:
        raise ValueError("track_diffusivity requires diffusion=")
    if not jac_kernel_fits(nstate, track_d):
        raise ValueError(f"nstate={nstate}: beyond the Jacobian kernel's "
                         f"gate (nstate <= 74, 59 with D)")
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, diffusion,
                 strict=True)
    P, B = x["P"], x["B"]
    G = 4 if track_d else 3
    out = torch.empty((2 + 2 * G, P, B), dtype=torch.float32,
                      device=T1s.device)
    var_te = isinstance(x["TE"], torch.Tensor)
    bT, bL, Dc = x["diff"] if x["diff"] is not None else (0.0, 0.0, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # asynchronous on the current stream; see _launch on temporaries
    lib = _build.load()
    rc = lib.epg_fisp_jac(
        ptr(x["FA"]), ptr(x["phi"]), ptr(x["TR"]),
        ptr(x["TE"]) if var_te else None, 0.0 if var_te else x["TE"],
        0.0 if x["TI"] is None else x["TI"],
        ptr(x["T1"]), ptr(x["T2"]), ptr(x["B1"]), ptr(x["df"]), ptr(Dc),
        bT, bL, ptr(out), P, B, nstate,
        int(var_te), int(x["TI"] is not None), int(bool(inversion_df)),
        int(x["df"] is not None), int(bool(demodulate)),
        int(x["diff"] is not None), int(bool(diff_ramp)), int(track_d),
        fisp_jac_geometry(nstate, track_d)["warps"],
        T1s.device.index if T1s.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(T1s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fisp_jac kernel launch failed: CUDA error {rc}")
    JAC_LAUNCHES += 1
    return _jac_views(out)


def _jac_finish(echoes):
    """(B, P) and (B, P, G) views of echo-layout Jacobian outputs."""
    (re, im), (dre, dim) = echoes
    return (re.T, im.T), (dre.transpose(0, 1), dim.transpose(0, 1))


def fisp_jacobian_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                        nstate=10, demodulate=False, inversion=None,
                        inversion_df=True, diffusion=None, diff_ramp=True,
                        track_diffusivity=False):
    """FISP fingerprints and Jacobian by the plain PyTorch twin of the
    kernel.  Arguments and returns as :func:`fisp_jacobian_cuda`; any
    device, either precision."""
    return _jac_finish(fisp_jacobian_echoes_plain(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate, inversion=inversion,
        inversion_df=inversion_df, diffusion=diffusion, diff_ramp=diff_ramp,
        track_diffusivity=track_diffusivity))


def fisp_jacobian_cuda(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                       nstate=10, demodulate=False, inversion=None,
                       inversion_df=True, diffusion=None, diff_ramp=True,
                       track_diffusivity=False):
    """Fingerprints + dS/d(T1, T2, B1[, D]) via the fused CUDA kernel.

    Arguments mirror ``fisp_jacobian_pallas`` and
    :func:`fisp_dictionary_cuda` (no ``normalize``);
    ``track_diffusivity=True`` (with ``diffusion=``) appends the dS/dD
    column.  Returns ((re, im), (dre, dim)): (B, P) fingerprints and
    (B, P, 3[+1]) derivatives ordered (T1, T2, B1[, D]), as views of the
    kernel's (P, B) outputs.
    """
    return _jac_finish(fisp_jacobian_echoes(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate, inversion=inversion,
        inversion_df=inversion_df, diffusion=diffusion, diff_ramp=diff_ramp,
        track_diffusivity=track_diffusivity))


# -- the full ladder: 2 nstate + 1 rows of F+, F- and Z --


def full_kernel_fits(nstate) -> bool:
    """Whether the full-ladder kernel's state fits at its smallest block
    (32 threads): 6 planes x (2 nstate + 1) rows x 32 atoms x 4 bytes --
    nstate <= 150."""
    return 4 * _PLANES * (2 * int(nstate) + 1) * 32 <= SMEM_PER_BLOCK


def full_block_size(nstate) -> int:
    """Threads per block of the full-ladder kernel: 128, halved while the
    state does not fit."""
    block = 128
    while block > 32 and (4 * _PLANES * (2 * int(nstate) + 1) * block
                          > SMEM_PER_BLOCK):
        block //= 2
    return block


def fisp_full_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                           nstate=10, demodulate=False, inversion=None,
                           inversion_df=True):
    """Echo train (re, im), each (P, B), on the literal 2 nstate + 1-row
    ladder (k = 0 at row nstate) by the plain PyTorch recurrence (the
    full-ladder kernel's twin), on T1s's device in T1s's dtype.  It is the
    port's one full-ladder program: ``models/mrf.fisp_mrf_dictionary``
    runs it and ``fisp_mrf_jacobian`` differentiates it forward, so it
    writes nothing in place (``torch.func.jvp`` under ``vmap``)."""
    N = int(nstate)
    if N < 0:
        raise ValueError(f"nstate must be >= 0, got {nstate}")
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, None,
                 strict=False)
    T1, T2, B1, DF = x["T1"], x["T2"], x["B1"], x["df"]
    K = 2 * N + 1
    use_df = DF is not None
    z = torch.zeros((K, x["B"]), dtype=T1.dtype, device=T1.device)
    centre = torch.zeros((K, 1), dtype=T1.dtype, device=T1.device)
    centre[N] = 1.0                    # the k = 0 row
    # F+ re, F+ im, F- re, F- im, Z re, Z im
    if x["TI"] is not None:
        TI = x["TI"]
        (fpi, z0), _ = planes.inversion_prep(B1, T1, T2, TI)
        if use_df and inversion_df:
            th = 2 * math.pi * DF * TI
            cth, sth = torch.cos(th), torch.sin(th)
            s = [centre * v for v in (-fpi * sth, fpi * cth, -fpi * sth,
                                      -fpi * cth, z0)] + [z]
        else:
            s = [z, centre * fpi, z, centre * -fpi, centre * z0, z]
    else:
        s = [z, z, z, z, centre.expand_as(z), z]

    deg = math.pi / 180.0
    cp, sp, c2p, s2p = planes.phase_terms(x["phi"] * deg)
    var_te = isinstance(x["TE"], torch.Tensor)
    if not var_te:
        te = x["TE"]
        e1te, e2te = torch.exp(-te / T1), torch.exp(-te / T2)
    out_re, out_im = [], []
    FA, TR = x["FA"], x["TR"]
    cmul = planes.cmul
    for i in range(x["P"]):
        if var_te:
            te = x["TE"][i]
            e1te, e2te = torch.exp(-te / T1), torch.exp(-te / T2)
        (cos2, m01r, m01i, m02r, m02i, ca, m20r, m20i, m21r,
         m21i) = planes.rot_coeffs(FA[i] * B1 * deg, cp[i], sp[i], c2p[i],
                                   s2p[i])
        m12r, m12i = m02r, -m02i       # m12 = i e^{-i phi} sin a
        rem = TR[i] - te
        E1b = torch.exp(-rem / T1)
        E2b = torch.exp(-rem / T2)
        cF = e2te * E2b
        cZ = e1te * E1b
        rec = (1.0 - e1te) * E1b + (1.0 - E1b)
        zero = torch.zeros_like(cF)
        if use_df:
            ang_te = 2 * math.pi * DF * te
            pteR, pteI = torch.cos(ang_te), torch.sin(ang_te)
            ang = 2 * math.pi * DF * (te + rem)
            pR, pI = torch.cos(ang), torch.sin(ang)
            cFpR, cFpI, cFmR, cFmI = cF * pR, cF * pI, cF * pR, -cF * pI
        else:
            cFpR, cFpI, cFmR, cFmI = cF, zero, cF, zero
        FpR, FpI, FmR, FmI, ZR, ZI = s

        # echo from the k = 0 row (post-rotation, post-TE decay)
        bR, bI = cmul(m01r, m01i, FmR[N], FmI[N])
        dR, dI = cmul(m02r, m02i, ZR[N], ZI[N])
        eR = (cos2 * FpR[N] + bR + dR) * e2te
        eI = (cos2 * FpI[N] + bI + dI) * e2te
        if use_df:
            eR, eI = cmul(pteR, pteI, eR, eI)
        if demodulate:
            eR, eI = eR * cp[i] + eI * sp[i], eI * cp[i] - eR * sp[i]
        out_re.append(eR)
        out_im.append(eI)

        # the relaxation folded into the rotation rows
        c00 = cmul(cFpR, cFpI, cos2, zero)
        c01 = cmul(cFpR, cFpI, m01r, m01i)
        c02 = cmul(cFpR, cFpI, m02r, m02i)
        aR, aI = cmul(*c00, FpR, FpI)
        bR, bI = cmul(*c01, FmR, FmI)
        dR, dI = cmul(*c02, ZR, ZI)
        nFpR, nFpI = aR + bR + dR, aI + bI + dI
        c10 = cmul(cFmR, cFmI, m01r, -m01i)
        c11 = cmul(cFmR, cFmI, cos2, zero)
        c12 = cmul(cFmR, cFmI, m12r, m12i)
        aR, aI = cmul(*c10, FpR, FpI)
        bR, bI = cmul(*c11, FmR, FmI)
        dR, dI = cmul(*c12, ZR, ZI)
        nFmR, nFmI = aR + bR + dR, aI + bI + dI
        aR, aI = cmul(m20r * cZ, m20i * cZ, FpR, FpI)
        bR, bI = cmul(m21r * cZ, m21i * cZ, FmR, FmI)
        zz = ca * cZ
        nZR = aR + bR + zz * ZR
        nZR = torch.cat([nZR[:N], (nZR[N] + rec)[None], nZR[N + 1:]])
        # unit shift: F+ up a row, F- down a row, zero-filled
        zrow = z[:1]
        s = [torch.cat([zrow, nFpR[:-1]]), torch.cat([zrow, nFpI[:-1]]),
             torch.cat([nFmR[1:], zrow]), torch.cat([nFmI[1:], zrow]),
             nZR, aI + bI + zz * ZI]
    return torch.stack(out_re), torch.stack(out_im)


def fisp_full_echoes(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *, nstate=10,
                     demodulate=False, inversion=None, inversion_df=True):
    """Echo train (re, im), each (P, B) float32, on the full ladder: the
    CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    kw = dict(nstate=nstate, demodulate=demodulate, inversion=inversion,
              inversion_df=inversion_df)
    if _takes_twin(T1s, "full-ladder FISP"):
        return fisp_full_echoes_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs,
                                      **kw)
    return _launch_full(FA, phi, TR, TE, T1s, T2s, B1s, dfs, **kw)


def _launch_full(FA, phi, TR, TE, T1s, T2s, B1s, dfs, *, nstate, demodulate,
                 inversion, inversion_df):
    global FULL_LAUNCHES
    from .. import _build

    if T1s.dtype != torch.float32:
        raise TypeError(f"the full-ladder FISP kernel computes in float32, "
                        f"got {T1s.dtype}")
    nstate = int(nstate)
    if nstate < 0:
        raise ValueError(f"nstate must be >= 0, got {nstate}")
    if not full_kernel_fits(nstate):
        raise ValueError(f"nstate={nstate}: the full-ladder kernel state does"
                         f" not fit in {SMEM_PER_BLOCK} bytes of shared "
                         f"memory")
    x = _prepare(FA, phi, TR, TE, T1s, T2s, B1s, dfs, inversion, None,
                 strict=True)
    P, B = x["P"], x["B"]
    out_re = torch.empty((P, B), dtype=torch.float32, device=T1s.device)
    out_im = torch.empty_like(out_re)
    var_te = isinstance(x["TE"], torch.Tensor)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # asynchronous on the current stream; see _launch on temporaries
    lib = _build.load()
    rc = lib.epg_fisp_full(
        ptr(x["FA"]), ptr(x["phi"]), ptr(x["TR"]),
        ptr(x["TE"]) if var_te else None, 0.0 if var_te else x["TE"],
        0.0 if x["TI"] is None else x["TI"],
        ptr(x["T1"]), ptr(x["T2"]), ptr(x["B1"]), ptr(x["df"]),
        ptr(out_re), ptr(out_im), P, B, nstate, int(var_te),
        int(x["TI"] is not None), int(bool(inversion_df)),
        int(x["df"] is not None), int(bool(demodulate)),
        full_block_size(nstate),
        T1s.device.index if T1s.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(T1s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fisp_full kernel launch failed: CUDA error {rc}")
    FULL_LAUNCHES += 1
    return out_re, out_im


def fisp_full_ladder_plain(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                           nstate=10, demodulate=False, inversion=None,
                           inversion_df=True, normalize=False):
    """FISP dictionary on the full ladder by the plain PyTorch twin of the
    kernel.  Arguments and returns as :func:`fisp_full_ladder_cuda`; any
    device, either precision."""
    re, im = fisp_full_echoes_plain(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate, inversion=inversion,
        inversion_df=inversion_df)
    return _finish(re, im, normalize)


def fisp_full_ladder_cuda(FA, phi, TR, TE, T1s, T2s, B1s, dfs=None, *,
                          nstate=10, demodulate=False, inversion=None,
                          inversion_df=True, normalize=False):
    """FISP MRF dictionary via the full-ladder CUDA kernel (the JAX
    wrapper's ``half_ladder=False``): arguments and returns as
    :func:`fisp_dictionary_cuda` without diffusion, any nstate >= 0 (up
    to 150 on the card)."""
    re, im = fisp_full_echoes(
        FA, phi, TR, TE, T1s, T2s, B1s, dfs, nstate=nstate,
        demodulate=demodulate, inversion=inversion,
        inversion_df=inversion_df)
    return _finish(re, im, normalize)
