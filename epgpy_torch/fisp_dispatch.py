"""Whole-sequence kernel dispatch: FISP trains -> the fused CUDA kernel.

Counterpart of the FISP family of ``epgpy_tpu/fisp_dispatch.py``
(:58-625, :2091-2163).  ``simulate()`` hands its flat operator list to
:func:`match_fisp`, which recognizes the spoiled FISP train

    [T(FA_i * B1, phi_i), E(TE_i, T1, T2, g), ADC, E(TR_i - TE_i, T1, T2, g),
     S(1)] * N

at the raw-operator level, optionally after an ``[T(180-family), E(TI)]``
inversion prep, with per-pulse TR and TE, rank-1 ``outer(FA, B1)`` flip
batches, a per-atom off-resonance ``g``, demodulated readouts
(``Adc(phase=-phi_i)``) and n-D (append-rule) batch shapes, and extracts
the kernel's parameters; :func:`run_fisp_kernel` runs the kernel
(models/cuda_fisp.py).  Matching is strict: exact op types, unit integer
shift, host parameter values.  A non-match returns None and logs its
reason at INFO; the engine then takes the general path.

Matching is host work, O(pulses x atoms) for the rank-1 flip
factorization, so results (matches and non-matches) are memoized on the
operator identities.  The DW-FISP, CPMG, bSSFP, DESS, ME-GRE, EPG-X and
composite families of the JAX dispatcher are not ported yet (ROADMAP).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import common, config
from .models import cuda_fisp

LOGGER = logging.getLogger(__name__)

__all__ = ["match_fisp", "run_fisp_kernel", "device_params", "kernel_fits",
           "count_dispatch", "DISPATCH_COUNTS", "clear_cache"]

#: per-sequence match memo keyed on operator identities; entries pin the
#: operator list so ids cannot be reused while cached
_MATCH_CACHE: dict = {}
_MATCH_CACHE_MAX = 64


def clear_cache():
    _MATCH_CACHE.clear()


#: kernel-dispatch engagement counter: the engine increments the matched
#: family's tag ("fisp") each time simulate() routes to a fused kernel.
#: Diagnostics only (proves a run went through the kernel); never branch
#: on it.
DISPATCH_COUNTS: dict = {}


def count_dispatch(tag):
    DISPATCH_COUNTS[tag] = DISPATCH_COUNTS.get(tag, 0) + 1


def kernel_fits(nstate) -> bool:
    """Whether the FISP kernel's state fits in one block's shared memory
    on the H100 (see cuda_fisp.kernel_fits); oversized ladders take the
    general path instead of failing the launch."""
    return cuda_fisp.kernel_fits(max(int(nstate), 1))


def _memoized(key, sequence, compute):
    """Memoize a matcher result (including non-matches) on `key`; the
    entry pins the op list, oldest entries evict first."""
    hit = _MATCH_CACHE.get(key)
    if hit is not None:
        return hit[0]
    result = compute()
    while len(_MATCH_CACHE) >= _MATCH_CACHE_MAX:
        _MATCH_CACHE.pop(next(iter(_MATCH_CACHE)))
    _MATCH_CACHE[key] = (result, list(sequence))
    return result


def _is_device(x):
    """A CUDA tensor (reading it is a device-to-host copy) or a tensor
    that requires grad disqualifies the op: such trains take the general
    path."""
    return isinstance(x, torch.Tensor) and (x.is_cuda or x.requires_grad)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _scalar(x):
    """float(x) if x is a host scalar (0-d/()/(1,)), else None."""
    if x is None or _is_device(x):
        return None
    if isinstance(x, (int, float)):
        return float(x)
    arr = np.asarray(_host(x))
    if arr.ndim == 0 or arr.size == 1:
        return float(arr.reshape(()))
    return None


def _host_nd(x):
    """Host value as a float64 array of any rank, or None."""
    if _is_device(x):
        return None
    try:
        return np.atleast_1d(np.asarray(_host(x), dtype=np.float64))
    except (TypeError, ValueError):
        return None


def _append_rows(arrs, bshape):
    """Right-pad (append-broadcast rule) and broadcast each array to
    `bshape`, flattened -- views, no copies."""
    nd = len(bshape)
    return [np.broadcast_to(a.reshape(a.shape + (1,) * (nd - a.ndim)),
                            bshape).reshape(-1) for a in arrs]


def _rank1_factor(alphas):
    """Factor a list of batch-or-scalar flip rows into rank-1
    ``outer(FA, B1)``; returns (FA, B1) host arrays or None.  B1 keeps
    the rows' (append-rule) broadcast batch shape.

    Scalar-only rows get B1 = [1].  Otherwise a streaming rank-1 check:
    per-row least-squares coefficient against the largest row, O(B)
    temporaries only.  Tolerance 1e-6 (~8 f32 ulps): trains built as
    float32 products fl(FA_i * B1_b) round each entry independently, so
    exact rank-1 never holds -- but genuine per-atom structure must not
    be approximated away.
    """
    N = len(alphas)
    if all(a.size == 1 for a in alphas):
        return (np.asarray([float(a.reshape(-1)[0]) for a in alphas]),
                np.ones(1))
    bshape = common.broadcast_shapes(*(x.shape for x in alphas))
    rows = _append_rows(alphas, bshape)
    mags = [float(np.abs(r).max()) for r in rows]
    ref = rows[int(np.argmax(mags))].astype(np.float64)
    nref2 = float(ref @ ref)
    refmax = np.abs(ref).max()
    if nref2 == 0.0:
        return None
    FA = np.empty(N)
    for i, r in enumerate(rows):
        c = float(r @ ref) / nref2
        if np.abs(r - c * ref).max() > 1e-6 * max(abs(c) * refmax, 1e-30):
            return None
        FA[i] = c
    # only FA*B1 enters the kernel
    return FA * refmax, (ref / refmax).reshape(bshape)


def match_fisp(sequence):
    """Match ``[T, E, ADC, E, S(1)] * N`` (optionally after a [T, E]
    inversion prep) and extract the kernel parameters.

    Returns ``dict(FA, phi, TR, TE, T1, T2, B1, TI, inv_df, df, demod,
    shape)`` of host values -- the keys and values of the JAX matcher's
    dict for the same train -- or None, logging the reason at INFO.
    """
    n = len(sequence)
    if n < 10 or n % 5 not in (0, 2):
        params, reason = None, (
            f"{n} ops is not [T, E, ADC, E, S(1)] x N (N >= 2), optionally "
            f"after a [T, E] inversion prep")
    else:
        key = tuple(id(op) for op in sequence)
        params, reason = _memoized(key, sequence,
                                   lambda: _match_fisp_impl(sequence))
    if params is None:
        LOGGER.info("match_fisp: not a FISP train: %s", reason)
    return params


def _match_fisp_impl(sequence):
    """(params, None) for a FISP train, else (None, reason)."""
    from .ops.evolution import E
    from .ops.probe import Adc
    from .ops.shift import S
    from .ops.transition import T

    prep, off = None, 0
    if len(sequence) % 5 == 2:
        t0, e0 = sequence[0], sequence[1]
        if type(t0) is not T or type(e0) is not E:
            return None, "ops 0-1 are not a [T, E] inversion prep"
        TI = _scalar(e0.tau)
        if TI is None:
            return None, "op 1: the prep delay is not a host scalar"
        prep, off = (t0, e0, TI), 2
        sequence = sequence[2:]

    alphas, phis, te_taus, tr_taus, adc_phases = [], [], [], [], []
    T1 = T2 = DF = None
    for i in range(len(sequence) // 5):
        group = sequence[5 * i:5 * i + 5]
        for j, (op, typ) in enumerate(zip(group, (T, E, Adc, E, S))):
            if type(op) is not typ:
                return None, (f"op {off + 5 * i + j} ({op.name}) is not "
                              f"{typ.__name__}")
        t_op, e1, adc, e2, s = group
        at = off + 5 * i
        # ADC: F0; phase absent or a host scalar (checked against -phi
        # below: receiver demodulation)
        ph_adc = None if adc.phase is None else _scalar(adc.phase)
        if adc.attr != "F0" or (adc.phase is not None and ph_adc is None):
            return None, f"op {at + 2}: not a plain F0 readout"
        adc_phases.append(ph_adc)
        if s.k != 1:
            return None, f"op {at + 4}: shift is not S(1)"
        ph, tte, ttr = _scalar(t_op.phi), _scalar(e1.tau), _scalar(e2.tau)
        if ph is None or tte is None or ttr is None:
            return None, f"ops {at}-{at + 3}: phase or delay not a host scalar"
        # off-resonance: one per-atom (or scalar) g on both E ops
        g1, g2 = _host_nd(e1.g), _host_nd(e2.g)
        if g1 is None or g2 is None or not np.array_equal(g1, g2):
            return None, f"ops {at + 1},{at + 3}: off-resonance differs"
        if DF is None:
            DF = g1
        elif not np.array_equal(DF, g1):
            return None, f"op {at + 1}: off-resonance differs from pulse 0"
        for k, e in ((at + 1, e1), (at + 3, e2)):
            t1v, t2v = _host_nd(e.T1), _host_nd(e.T2)
            if t1v is None or t2v is None:
                return None, f"op {k}: T1/T2 not host values"
            if T1 is None:
                T1, T2 = t1v, t2v
            elif not (np.array_equal(T1, t1v) and np.array_equal(T2, t2v)):
                return None, f"op {k}: T1/T2 differ from pulse 0"
        a = _host_nd(t_op.alpha)
        if a is None:
            return None, f"op {at}: flip angle not a host value"
        alphas.append(a)
        phis.append(ph)
        te_taus.append(tte)
        tr_taus.append(ttr)

    te_arr = np.asarray(te_taus)
    TE = float(te_arr[0]) if (te_arr == te_arr[0]).all() else te_arr
    TR = np.asarray(tr_taus) + te_arr

    # ADC phases: all absent -> plain readout; all equal to -phi_i
    # (mod 360) -> the kernel's receiver demodulation
    if all(p is None for p in adc_phases):
        demod = False
    elif any(p is None for p in adc_phases):
        return None, "some readouts are demodulated, some not"
    else:
        d = (np.asarray(adc_phases) + np.asarray(phis)) % 360.0
        if (np.minimum(d, 360.0 - d) > 1e-6).any():
            return None, "readout phases are not -phi_i"
        demod = True

    fab = _rank1_factor(alphas)
    if fab is None:
        return None, "flip angles are not rank-1 outer(FA, B1)"
    FA, B1 = fab

    TI, inv_df = None, False
    if prep is not None:
        # the kernel's prep is a 180*B1 pulse about phi=0: a scalar
        # exact-180 prep when B1 == 1, or a prep proportional to the
        # train's B1 with phi=0 (renormalizing the factorization so that
        # B1 = prep_alpha/180 exactly)
        t0, e0, TI = prep
        t1v, t2v = _host_nd(e0.T1), _host_nd(e0.T2)
        if (t1v is None or t2v is None or not np.array_equal(T1, t1v)
                or not np.array_equal(T2, t2v)):
            return None, "op 1: prep T1/T2 differ from the train's"
        g0 = _host_nd(e0.g)
        if g0 is None:
            return None, "op 1: prep off-resonance not a host value"
        if np.any(g0 != 0.0):
            # a precessing prep must carry the train's off-resonance
            if not np.array_equal(g0, DF):
                return None, "op 1: prep off-resonance differs from train's"
            inv_df = True
        a0, ph0 = _host_nd(t0.alpha), _scalar(t0.phi)
        if a0 is None or ph0 is None:
            return None, "op 0: prep pulse not host values"
        if a0.size == 1 and float(a0.reshape(-1)[0]) == 180.0 \
                and np.all(B1 == 1.0):
            pass
        elif ph0 % 360.0 == 0.0:
            if not common.broadcastable(a0.shape, B1.shape):
                return None, "op 0: prep batch shape differs from B1's"
            bs0 = common.broadcast_shapes(a0.shape, B1.shape)
            a0b, B1b = _append_rows((a0, B1), bs0)
            den = 180.0 * float(B1b.mean())
            if den == 0.0:
                return None, "op 0: zero B1"
            c = float(a0b.mean()) / den
            if c <= 0 or np.abs(a0b - 180.0 * c * B1b).max() > 1e-6 * 180.0:
                return None, "op 0: prep is not 180 * B1"
            B1 = (c * B1b).reshape(bs0)
            FA = FA / c
        else:
            return None, "op 0: prep phase is not 0"

    # n-D batch grids flatten to the kernel's atom axis (append rule);
    # run_fisp_kernel restores the batch shape on the outputs
    if not common.broadcastable(T1.shape, T2.shape, B1.shape, DF.shape):
        return None, "T1, T2, B1 and df batch shapes do not broadcast"
    bshape = common.broadcast_shapes(T1.shape, T2.shape, B1.shape, DF.shape)
    T1f, T2f, B1f, DFf = _append_rows((T1, T2, B1, DF), bshape)
    return {
        "FA": FA, "phi": np.asarray(phis), "TR": TR, "TE": TE,
        "T1": T1f, "T2": T2f, "B1": B1f, "TI": TI, "inv_df": inv_df,
        "demod": demod, "shape": bshape,
        "df": DFf if DFf.any() else None,
    }, None


def device_params(params, device=None):
    """The kernel's float32 tensors for a match dict, cached on the dict
    (the match memo pins it): repeated simulate() calls on one train do
    not re-pay the host-to-device copies.  TE stays a python float when
    constant (the kernel hoists its decay factors)."""
    device = torch.device(config.device() if device is None else device)
    hit = params.get("_dev")
    if hit is not None and hit[0] == device:
        return hit[1]

    def vec(k):
        return torch.as_tensor(np.asarray(params[k], np.float32),
                               device=device)

    TE = params["TE"]
    dev = {k: vec(k) for k in ("FA", "phi", "TR", "T1", "T2", "B1")}
    dev["TE"] = float(TE) if np.ndim(TE) == 0 else vec("TE")
    dev["df"] = None if params.get("df") is None else vec("df")
    params["_dev"] = (device, dev)
    return dev


def run_fisp_kernel(params, nstate):
    """Run the fused kernel on a match dict; returns the echo train as a
    complex64 tensor in the engine's layout, (N, *batch): the kernel's
    (P, B) output needs no transpose."""
    d = device_params(params)
    re, im = cuda_fisp.fisp_echoes(
        d["FA"], d["phi"], d["TR"], d["TE"], d["T1"], d["T2"], d["B1"],
        d["df"], nstate=max(int(nstate), 1),
        demodulate=bool(params.get("demod")), inversion=params.get("TI"),
        inversion_df=bool(params.get("inv_df")))
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))
