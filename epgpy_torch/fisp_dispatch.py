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

Derivative specs are part of the match (``:164-258, :379-381, :429-443,
:542-545, :569-587`` of the JAX dispatcher): E ops may track
``order1=["T1", "T2"]`` (unit coefficients, the same spec on every E), T
ops may track B1 as ``order1={"B1": {"alpha": c_i}}`` with one shared
ratio FA_i / c_i; the dict's ``vars`` and ``b1_scale`` tell the Jacobian
runner (:func:`run_fisp_jacobian`, the fused primal+tangent kernel) which
columns it serves.  Aliases, chain-rule coefficients other than that,
and order2 specs do not match.

Matching is host work, O(pulses x atoms) for the rank-1 flip
factorization, so results (matches and non-matches) are memoized on the
operator identities.

The per-pulse Hessian family (``:1653-1984``): :func:`match_fisp_hessian`
recognizes trains whose T ops track one alpha alias each and whose E ops
track T1, T2 and (all or none) one tau alias each;
:func:`match_hessian_probes` maps Adc/Jacobian/Hessian probes onto the
kernel's column bank and :func:`run_fisp_hessian` runs the per-pulse
Hessian kernel (models/cuda_hessian.py) and copies its blocks into the
probes' outputs.

The CPMG family (``:1349-1650``): :func:`match_mse` recognizes the
multi-spin-echo train ``[T(exc)] + [E, S(1), D?, T(ref_i), E, S(1), D?,
ADC] * E`` (E and S in either order within a half, D only after the
half's S: the DW-TSE form), and :func:`run_mse_kernel` /
:func:`run_mse_jacobian` run the CPMG kernels (models/cuda_mse.py).

The balanced-SSFP and DESS families (``:793-1110``): :func:`match_bssfp`
recognizes the spoiler-free ``[T, E, ADC, E] * N`` train (the FISP
matcher with ``spoiled=False``: no S op, and the E ops may track ``g``),
:func:`match_dess` the double-echo ``[T, E, ADC, E, S(1), E, ADC] * N``
train; their runners drive models/cuda_bssfp.py and models/cuda_dess.py.

The ME-GRE family (``:1113-1346``): :func:`match_megre` recognizes the
multi-echo spoiled GRE train ``[T, (E, ADC) * m, E?, S(1)] * N`` (m >= 2;
E ops may track T1, T2 and g), run by models/cuda_megre.py.  The DW-FISP
family (``:628-790``): :func:`match_dwfisp` is the FISP matcher with one D
op after each shift (``dw=True``: the same D instance every TR, a host
``kvalue``; a scalar D may be tracked as ``order1=["Dcoef"]``), run by the
FISP kernels with their diffusion attenuation.

The composite-GRE family (``:2888-3292``): :func:`match_composite` folds
any ``[T?, E*, Adc?, E*, S(+-k)?, D?]`` stage train -- MPRAGE, cardiac MRF
with IR and T2prep preps, saturation recovery -- into per-stage tables,
run by models/cuda_composite.py (:func:`run_composite_kernel`,
:func:`run_composite_jacobian` with only the tangent groups the probes
need).

The EPG-X families (``:2166-2884``): :func:`match_xgre` recognizes the
exchange / MT gradient-echo train ``[R?, T, X?, Adc, X?, S(1)?] * N`` over
C compartments (spoiled or balanced), :func:`match_xcomposite` any
prepared stage train ``[R?, T?, X*, Adc?, X*, S(+-1)?]`` with one exchange
generator; both read the ``density`` option, and their runners drive
models/cuda_xgre.py and models/cuda_xcomposite.py.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import common, config
from .models import (cuda_bssfp, cuda_composite, cuda_dess, cuda_fisp,
                     cuda_hessian, cuda_megre, cuda_mse, cuda_xcomposite,
                     cuda_xgre)

LOGGER = logging.getLogger(__name__)

__all__ = ["match_fisp", "run_fisp_kernel", "device_params", "kernel_fits",
           "jac_kernel_fits", "match_jacobian_probes", "run_fisp_jacobian",
           "match_fisp_hessian", "match_hessian_probes", "run_fisp_hessian",
           "hess_kernel_fits", "hess_device_params", "match_mse",
           "run_mse_kernel", "run_mse_jacobian", "mse_kernel_fits",
           "mse_jac_kernel_fits", "match_bssfp", "run_bssfp_kernel",
           "run_bssfp_jacobian", "match_dess", "run_dess_kernel",
           "run_dess_jacobian", "match_megre", "run_megre_kernel",
           "run_megre_jacobian", "match_dwfisp", "run_dwfisp_kernel",
           "run_dwfisp_jacobian", "match_composite", "run_composite_kernel",
           "run_composite_jacobian", "composite_jac_groups",
           "match_xgre", "run_xgre_kernel", "xgre_kernel_fits",
           "match_xcomposite", "run_xcomposite_kernel",
           "xcomposite_kernel_fits",
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


def jac_kernel_fits(nstate, track_diffusivity=False) -> bool:
    """Whether the FISP Jacobian kernel's 24 planes (30 with the DW-FISP
    dD group) fit in one block's shared memory (see
    cuda_fisp.jac_kernel_fits)."""
    return cuda_fisp.jac_kernel_fits(max(int(nstate), 1), track_diffusivity)


def _memoized(key, sequence, compute):
    """Memoize a matcher result (including non-matches) on `key`.  Every
    family declines a train with a pinned op (``axes=``): no kernel reads
    the pinning (the JAX matchers' ``op.axes`` guards, e.g.
    ``epgpy_tpu/fisp_dispatch.py:382, 444, 939, 1183, 1388``)."""
    def checked():
        pinned = next((n for n, op in enumerate(sequence)
                       if getattr(op, "axes", None) is not None), None)
        if pinned is not None:
            return None, (f"op {pinned} ({sequence[pinned].name}): axes= "
                          f"pinning")
        return compute()

    return common.memoize_on_ops(_MATCH_CACHE, _MATCH_CACHE_MAX, key,
                                 sequence, checked)


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


def _no_diff(op):
    return not getattr(op, "order1", None) and not getattr(op, "order2", None)


def _plain_adc(adc):
    """An Adc reading F0 itself: no weights, no reduction (JAX
    ``fisp_dispatch.py:446-451``: a weighted ADC takes the general path)."""
    return adc.attr == "F0" and adc.plain


def _host_scalar_coeff(c):
    """A chain-rule coefficient as a host float, or None (device, traced
    or non-scalar coefficients disqualify; never raise: the matcher must
    fall through on exotic specs)."""
    if _is_device(c) or np.ndim(c) != 0:
        return None
    try:
        return float(c)
    except (TypeError, ValueError):
        return None


def _canonical_order1(op, allowed=("T1", "T2")):
    """E-op order1 as a sorted tuple of tracked names, or None.

    The fused Jacobian kernel propagates dS/d(param) for the atom
    parameters, which is the order1 spec whose variable IS the parameter
    with unit coefficient (``order1=["T1", "T2"]``).  Aliased variables,
    chain-rule coefficients, parameters outside `allowed` and order2
    disqualify the train."""
    if getattr(op, "order2", None):
        return None
    o1 = getattr(op, "order1", None)
    if not o1:
        return ()
    names = []
    for var, cfs in o1.items():
        if var not in allowed or set(cfs) != {var}:
            return None
        if _host_scalar_coeff(cfs[var]) != 1.0:
            return None
        names.append(var)
    return tuple(sorted(names))


def _t_b1_order1(op):
    """T-op order1 for B1 tracking: no spec -> ``()`` (untracked); exactly
    ``order1={"B1": {"alpha": c}}`` with a host scalar c = d(alpha)/dB1
    -> ``float(c)``; anything else -> None (no match).  B1 enters only as
    the flip attenuation, so dS/dB1 = sum_i c_i dS/dalpha_i."""
    if getattr(op, "order2", None):
        return None
    o1 = getattr(op, "order1", None)
    if not o1:
        return ()
    if set(o1) != {"B1"}:
        return None
    cfs = o1["B1"]
    if not isinstance(cfs, dict) or set(cfs) != {"alpha"}:
        return None
    return _host_scalar_coeff(cfs["alpha"])


def _d_order1(op):
    """D-op order1 for diffusivity tracking (``epgpy_tpu/fisp_dispatch.py:
    261``): no spec -> ``()`` (untracked); ``order1=["Dcoef"]`` or the alias
    ``order1={"D": "Dcoef"}`` with unit coefficient -> the tracked name;
    anything else -> None (no match)."""
    if getattr(op, "order2", None):
        return None
    o1 = getattr(op, "order1", None)
    if not o1:
        return ()
    if len(o1) != 1:
        return None
    (var, cfs), = o1.items()
    if var not in ("D", "Dcoef") or not isinstance(cfs, dict) \
            or set(cfs) != {"Dcoef"}:
        return None
    if _host_scalar_coeff(cfs["Dcoef"]) != 1.0:
        return None
    return var


def _b1_scale_from_coeffs(FA, coeffs, sens=None):
    """Shared-ratio validation for B1-tracked trains
    (``epgpy_tpu/fisp_dispatch.py:228-258``).

    The kernel's dB1 column is w.r.t. its internally factored B1
    (``_rank1_factor`` absorbs the physical scale into FA), with per-pulse
    coefficient d(a_i)/dB1_kernel = FA_i.  The spec says d(alpha_i)/dB1 =
    c_i, so one shared ratio s = FA_i / c_i must hold on every pulse the
    kernel's dB1 group sums; then dS/dB1 = dS/dB1_kernel / s.  ``sens``
    marks those pulses (default: every pulse with a flip; the composite
    family's adiabatic stages are not among them): they must be tracked,
    and the others untracked.  Returns s or None."""
    if sens is None:
        sens = [abs(float(fa)) > 1e-12 for fa in FA[:len(coeffs)]]
    s = None
    for fa, c, on in zip(FA, coeffs, sens):
        if on:
            if c == () or c == 0.0:
                return None
            r = float(fa) / c
            if s is None:
                s = r
            elif abs(r - s) > 1e-5 * max(abs(s), 1e-30):
                return None
        elif c != () and c != 0.0:
            return None
    return s


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

    Returns ``dict(FA, phi, TR, TE, T1, T2, B1, TI, inv_df, vars,
    b1_scale, d_var, demod, shape, df, diffusion)`` of host values -- the
    keys and values of the JAX matcher's dict for the same train (``d_var``
    and ``diffusion`` are None: they belong to the DW-FISP family) -- or
    None, logging the reason at INFO.
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


def _match_fisp_impl(sequence, spoiled=True, dw=False, kvalue=1.0):
    """(params, None) for a FISP train -- with ``spoiled=False`` a balanced
    ``[T, E, ADC, E] * N`` train (``match_bssfp``), with ``dw`` a DW-FISP
    ``[T, E, ADC, E, S(1), D] * N`` train (``match_dwfisp``) -- else (None,
    reason)."""
    from .ops.diffusion import D as Dop
    from .ops.evolution import E
    from .ops.probe import Adc
    from .ops.shift import S
    from .ops.transition import T

    group = 6 if dw else (5 if spoiled else 4)
    # balanced trains admit off-resonance tracking (bSSFP resolves df, so
    # dS/dg is a fitted column in MRF-bSSFP and the kernel carries a ddf
    # tangent group); the FISP kernels have no df tangent group
    allowed = ("T1", "T2") if spoiled else ("T1", "T2", "g")
    prep, off = None, 0
    if len(sequence) % group == 2:
        t0, e0 = sequence[0], sequence[1]
        if type(t0) is not T or type(e0) is not E:
            return None, "ops 0-1 are not a [T, E] inversion prep"
        if _t_b1_order1(t0) is None \
                or _canonical_order1(e0, allowed) is None:
            return None, "ops 0-1: derivative spec the kernel does not take"
        TI = _scalar(e0.tau)
        if TI is None:
            return None, "op 1: the prep delay is not a host scalar"
        prep, off = (t0, e0, TI), 2
        sequence = sequence[2:]

    alphas, phis, te_taus, tr_taus, adc_phases = [], [], [], [], []
    b1_coeffs, d_ops, d_var = [], [], ()
    T1 = T2 = DF = tracked = None
    types = (T, E, Adc, E, S, Dop)[:group]
    for i in range(len(sequence) // group):
        ops = sequence[group * i:group * i + group]
        for j, (op, typ) in enumerate(zip(ops, types)):
            if type(op) is not typ:
                return None, (f"op {off + group * i + j} ({op.name}) is not "
                              f"{typ.__name__}")
        t_op, e1, adc, e2 = ops[:4]
        s = ops[4] if spoiled else None
        at = off + group * i
        # T may track B1 (chain-rule spec), E may track T1/T2 (and g on a
        # balanced train) -- the same spec on every E; the readout and the
        # shift track nothing
        b1c = _t_b1_order1(t_op)
        if b1c is None or not _no_diff(adc) or (spoiled and not _no_diff(s)):
            return None, (f"ops {at}-{at + group - 1}: derivative spec the "
                          f"kernel does not take")
        b1_coeffs.append(b1c)
        if dw:
            # the D op may track its diffusivity; every TR's D is one
            # instance (checked by _dw_bvalue), so the spec is shared
            dvar = _d_order1(ops[5])
            if dvar is None:
                return None, (f"op {at + 5}: D derivative spec the kernel "
                              f"does not take")
            d_var = dvar or d_var
            d_ops.append(ops[5])
        c1, c2 = _canonical_order1(e1, allowed), _canonical_order1(e2, allowed)
        if c1 is None or c1 != c2 or (tracked is not None
                                      and tracked != c1):
            return None, (f"ops {at + 1},{at + 3}: E derivative specs are "
                          f"not one canonical {'/'.join(allowed)} tracking")
        tracked = c1
        # ADC: F0; phase absent or a host scalar (checked against -phi
        # below: receiver demodulation)
        ph_adc = None if adc.phase is None else _scalar(adc.phase)
        if not _plain_adc(adc) or (adc.phase is not None and ph_adc is None):
            return None, f"op {at + 2}: not a plain F0 readout"
        adc_phases.append(ph_adc)
        if spoiled and s._kint != 1:
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
        if not spoiled:
            # a balanced prep always precesses with the train's df (the
            # bSSFP kernel applies the TI phase whenever df is given)
            if not np.array_equal(g0, DF):
                return None, "op 1: prep off-resonance differs from train's"
        elif np.any(g0 != 0.0):
            # a precessing prep must carry the train's off-resonance
            if not np.array_equal(g0, DF):
                return None, "op 1: prep off-resonance differs from train's"
            inv_df = True
        if _canonical_order1(e0, allowed) != tracked:
            # the kernel seeds prep tangents in closed form: the prep
            # relaxation is differentiated, so tracking must agree
            return None, "op 1: prep tracking differs from the train's"
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

    # B1-tracked trains: one shared ratio s = FA_kernel / c against the
    # final (post-prep-renormalization) factorization.  The kernel's dB1
    # column covers the train AND the prep's 180*B1, so a prepped train
    # matches only when its prep pulse is tracked too -- as a pseudo-pulse
    # of kernel coefficient 180 (d(180*B1n)/dB1n)
    b1_scale = None
    prep_b1c = () if prep is None else _t_b1_order1(prep[0])
    if any(c != () for c in b1_coeffs) or prep_b1c != ():
        fa_ext, cf_ext = list(FA), list(b1_coeffs)
        if prep is not None:
            if prep_b1c == ():
                return None, "op 0: B1-tracked train with an untracked prep"
            fa_ext.append(180.0)
            cf_ext.append(prep_b1c)
        b1_scale = _b1_scale_from_coeffs(fa_ext, cf_ext)
        if b1_scale is None:
            return None, "B1 chain-rule coefficients are not one ratio of FA"

    diffusion = None
    if dw:
        if not isinstance(kvalue, (int, float)):
            return None, f"kvalue {kvalue!r} is not a host number"
        f = _dw_bvalue(d_ops, kvalue, allow_diff=bool(d_var))
        if f is None:
            return None, ("D ops are not one host D(tau, Dcoef, k=1 | None) "
                          "instance")
        bbase, ramp, dcoef = f
        if d_var and np.ndim(dcoef) != 0:
            # the kernel's dD column is the scalar-diffusivity tangent
            return None, "a tracked D is not a scalar diffusivity"
        diffusion = {"bT": bbase, "bL": bbase, "Dcoef": dcoef, "ramp": ramp}

    # n-D batch grids flatten to the kernel's atom axis (append rule);
    # run_fisp_kernel restores the batch shape on the outputs
    if not common.broadcastable(T1.shape, T2.shape, B1.shape, DF.shape):
        return None, "T1, T2, B1 and df batch shapes do not broadcast"
    bshape = common.broadcast_shapes(T1.shape, T2.shape, B1.shape, DF.shape)
    T1f, T2f, B1f, DFf = _append_rows((T1, T2, B1, DF), bshape)
    out_vars = tuple(tracked) + (("B1",) if b1_scale is not None else ())
    if d_var:
        out_vars = out_vars + (d_var,)
    return {
        "FA": FA, "phi": np.asarray(phis), "TR": TR, "TE": TE,
        "T1": T1f, "T2": T2f, "B1": B1f, "TI": TI, "inv_df": inv_df,
        "vars": tuple(sorted(out_vars)), "b1_scale": b1_scale,
        "d_var": d_var or None, "demod": demod, "shape": bshape,
        "df": DFf if DFf.any() else None, "diffusion": diffusion,
    }, None


def _cached_device(params, device, build, dtype=None):
    """`build(device)`'s tensors for a match dict, cached on the dict (the
    match memo pins it) under the device (and `dtype`, for build
    functions that take one): repeated simulate() calls on one train do
    not re-pay the host-to-device copies."""
    device = torch.device(config.device() if device is None else device)
    hit = params.get("_dev")
    if hit is not None and hit[0] == (device, dtype):
        return hit[1]
    dev = build(device) if dtype is None else build(device, dtype)
    params["_dev"] = ((device, dtype), dev)
    return dev


def device_params(params, device=None, dtype=torch.float32):
    """The kernels' tensors for a FISP, bSSFP, DESS, ME-GRE or DW-FISP
    match dict (cached on it), float32 unless `dtype` says otherwise (the
    plain twins take float64 too).  TE stays a python float when constant
    (the kernels hoist its decay factors)."""
    def build(device, dtype):
        def vec(k):
            # C order: an (m, N) ME-GRE TE comes transposed from the matcher
            return torch.as_tensor(np.array(params[k], np.float64, order="C"),
                                   dtype=dtype, device=device)

        TE = params["TE"]
        dev = {k: vec(k) for k in ("FA", "phi", "TR", "T1", "T2", "B1")}
        dev["TE"] = float(TE) if np.ndim(TE) == 0 else vec("TE")
        dev["df"] = None if params.get("df") is None else vec("df")
        return dev

    return _cached_device(params, device, build, dtype)


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


def hess_kernel_fits(nstate, second_order=True) -> bool:
    """Whether the per-pulse Hessian kernel's lane groups fit in one
    block's shared memory at its smallest block (see
    cuda_hessian.hess_kernel_fits); it takes the place of the JAX
    dispatcher's VMEM gate."""
    return cuda_hessian.hess_kernel_fits(max(int(nstate), 1), second_order)


def match_fisp_hessian(sequence):
    """Match the per-pulse differentiation train
    (``epgpy_tpu/fisp_dispatch.py:1653``).

    Two train shapes: ``[T(a_i, order1={alias_i: "alpha"}), E(tau_i, T1,
    T2, order1={"T1", "T2", alias'_i: "tau"}), Adc, S(1)] * N`` (echo read
    at tau_i), or the 5-op form with a constant-TE echo ``[T, E(TE,
    {"T1", "T2"}), Adc, E(tau_i, ...), S(1)] * N``, optionally after a
    ``[T(180), E(TI, {"T1", "T2"})]`` inversion prep.  Every T tracks a
    distinct alpha alias; every E tracks T1 and T2 with unit coefficients
    and (all or none) the tail E a distinct tau alias.  Returns the JAX
    matcher's dict ``(FA, phi, TAU, T1, T2, TE, TI, amap, shape)`` --
    ``amap`` maps each alias to its column token ("a" | "t", i) -- or
    None, logging the reasons at INFO; memoized on operator identities.
    """
    if len(sequence) < 8:
        LOGGER.info("match_fisp_hessian: not a per-pulse train: %d ops",
                    len(sequence))
        return None
    key = ("hess",) + tuple(id(op) for op in sequence)

    def compute():
        n, reasons = len(sequence), []
        for group in (4, 5):
            for prep in (0, 2):
                if n - prep >= 2 * group and (n - prep) % group == 0:
                    params, why = _match_fisp_hessian_impl(
                        sequence[prep:], group=group,
                        prep=sequence[:prep] if prep else None)
                    if params is not None:
                        return params, None
                    reasons.append(f"{group}-op{' + prep' if prep else ''}:"
                                   f" {why}")
        return None, "; ".join(reasons) or f"{n} ops fit no layout"

    params, reason = _memoized(key, sequence, compute)
    if params is None:
        LOGGER.info("match_fisp_hessian: not a per-pulse train: %s", reason)
    return params


def _alias_order1(op, param, extra=()):
    """Parse ``op.order1`` as {extra params tracked as themselves} plus at
    most one alias variable of `param` (``epgpy_tpu/fisp_dispatch.py:
    1693``).  Returns ``(alias_or_None,)``, or False when off-pattern;
    every coefficient must be the host scalar 1.0."""
    o1 = getattr(op, "order1", None) or {}
    if getattr(op, "order2", None):
        return False
    alias, seen = None, set()
    for var, cfs in o1.items():
        if len(cfs) != 1:
            return False
        (p, c), = cfs.items()
        if _host_scalar_coeff(c) != 1.0:
            return False
        if var in extra and p == var:
            seen.add(var)
        elif p == param and var not in extra and alias is None:
            alias = var
        else:
            return False
    if seen != set(extra):
        return False
    return (alias,)


def _match_fisp_hessian_impl(sequence, group=4, prep=None):
    """(params, None) for a per-pulse train of `group`-op blocks, else
    (None, reason)."""
    from .ops.evolution import E
    from .ops.probe import Adc
    from .ops.shift import S
    from .ops.transition import T

    N = len(sequence) // group
    FA, PHI, TAU, avars, tvars = [], [], [], [], []
    T1 = T2 = TE = None

    def check_e(e_op, want_alias):
        """Shared E validation: (tau, alias) or a reason string."""
        nonlocal T1, T2
        if type(e_op) is not E:
            return f"{e_op.name} is not E"
        tv = _alias_order1(e_op, "tau", extra=("T1", "T2"))
        if tv is False or (tv[0] is not None and not want_alias):
            return f"{e_op.name}: not T1/T2 tracking (+ one tau alias)"
        tau = _scalar(e_op.tau)
        if tau is None or _scalar(e_op.g) != 0.0:
            return f"{e_op.name}: delay not a host scalar or g != 0"
        t1v, t2v = _host_nd(e_op.T1), _host_nd(e_op.T2)
        if t1v is None or t2v is None or t1v.ndim > 1 or t2v.ndim > 1:
            return f"{e_op.name}: T1/T2 not host scalars or 1-D"
        if T1 is None:
            T1, T2 = t1v, t2v
        elif not (np.array_equal(T1, t1v) and np.array_equal(T2, t2v)):
            return f"{e_op.name}: T1/T2 differ from the first E's"
        return tau, tv[0]

    for i in range(N):
        blk = sequence[group * i:group * i + group]
        if group == 4:
            t_op, e_op, adc, s = blk
            e_te = None
        else:
            t_op, e_te, adc, e_op, s = blk
        at = group * i
        if type(t_op) is not T or type(adc) is not Adc or type(s) is not S:
            return None, f"block {i}: not [T, E, Adc, (E,) S]"
        if not _no_diff(adc) or not _no_diff(s) or s._kint != 1:
            return None, f"op {at + group - 1}: not a plain S(1)"
        if not _plain_adc(adc) or adc.phase is not None:
            return None, f"op {at + 2 - (group == 4)}: not a plain F0 readout"
        av = _alias_order1(t_op, "alpha")
        if av is False or av[0] is None:
            return None, f"op {at}: T does not track one alpha alias"
        ev = check_e(e_op, want_alias=True)
        if isinstance(ev, str):
            return None, ev
        if e_te is not None:
            # 5-op form: constant echo time, T1/T2 tracking only
            et = check_e(e_te, want_alias=False)
            if isinstance(et, str):
                return None, et
            if TE is None:
                TE = et[0]
            elif et[0] != TE:
                return None, f"op {at + 1}: echo time differs from pulse 0"
        avars.append(av[0])
        tvars.append(ev[1])
        a, ph = _scalar(t_op.alpha), _scalar(t_op.phi)
        if a is None or ph is None:
            return None, f"op {at}: flip or phase not a host scalar"
        FA.append(a)
        PHI.append(ph)
        TAU.append(ev[0])

    TI = None
    if prep is not None:
        t0, e0 = prep
        if (type(t0) is not T or not _no_diff(t0)
                or _scalar(t0.alpha) != 180.0 or _scalar(t0.phi) is None):
            return None, "op 0: prep is not an untracked scalar T(180)"
        ep = check_e(e0, want_alias=False)
        if isinstance(ep, str):
            return None, f"prep {ep}"
        TI = ep[0]

    # distinct aliases; tau tracking all or none
    if len(set(avars)) != N:
        return None, "alpha aliases are not distinct"
    have_tau = [v is not None for v in tvars]
    if any(have_tau) != all(have_tau):
        return None, "tau aliases on some pulses only"
    if all(have_tau) and len(set(tvars)) != N:
        return None, "tau aliases are not distinct"
    reserved = {"magnitude", "T1", "T2"}
    if reserved & set(avars) or reserved & {v for v in tvars if v}:
        return None, "an alias is named magnitude, T1 or T2"
    if not common.broadcastable(T1.shape, T2.shape):
        return None, "T1 and T2 batch shapes do not broadcast"
    bshape = common.broadcast_shapes(T1.shape, T2.shape)
    B = int(np.prod(bshape))
    if B * N * N > (1 << 26):
        # the JAX dispatcher's output cap, kept so both packages make the
        # same dispatch decisions
        return None, f"B*N*N = {B * N * N} outputs exceed 2**26"
    amap = {v: ("a", i) for i, v in enumerate(avars)}
    if all(have_tau):
        amap.update({v: ("t", i) for i, v in enumerate(tvars)})
    T1f, T2f = _append_rows((T1, T2), bshape)
    return {"FA": np.asarray(FA), "phi": np.asarray(PHI),
            "TAU": np.asarray(TAU), "T1": T1f, "T2": T2f, "TE": TE,
            "TI": TI, "amap": amap, "shape": bshape}, None


def match_hessian_probes(probes, params):
    """Map a probe tuple onto the per-pulse Hessian kernel's outputs
    (``epgpy_tpu/fisp_dispatch.py:1840``).

    Accepts plain F0 ``Adc`` probes, ``Jacobian`` over {magnitude, T1, T2}
    and the train's alias variables, and ``Hessian(vars1, vars2)`` with
    vars1 in {magnitude, T1, T2} and vars2 among the aliases.  Returns
    ``(specs, second_order)`` or None; column tokens index the
    concatenated [sig, dT1, dT2, dalpha(N), dtau(N)] bank."""
    from . import diff
    from .ops.probe import Adc

    amap, N = params["amap"], len(params["FA"])
    glob = {"magnitude": 0, "T1": 1, "T2": 2}

    def col(v):
        if v in glob:
            return glob[v]
        tok = amap.get(v)
        if tok is None:
            return None
        return 3 + tok[1] + (N if tok[0] == "t" else 0)

    specs, second, have_diff = [], False, False
    for pb in probes:
        if isinstance(pb, diff.Hessian):
            if pb.probe_attr != "F0":
                return None
            rows = tuple(pb.variables1)
            if any(v not in glob for v in rows):
                return None
            cols = tuple(col(v) for v in pb.variables2)
            if any(c is None or c < 3 for c in cols):
                return None
            specs.append(("hess", rows, cols))
            second = second or any(v != "magnitude" for v in rows)
            have_diff = True
        elif isinstance(pb, diff.Jacobian):
            if pb.probe_attr != "F0":
                return None
            cols = tuple(col(v) for v in pb.variables)
            if any(c is None for c in cols):
                return None
            specs.append(("jac", cols))
            have_diff = True
        elif type(pb) is Adc and _plain_adc(pb) and pb.phase is None:
            specs.append(("sig",))
        else:
            return None
    return (tuple(specs), second) if have_diff else None


def hess_device_params(params, device=None):
    """The Hessian kernel's float32 tensors for a match dict (cached on
    it); TE and TI stay python floats."""
    return _cached_device(params, device, lambda device: {
        k: torch.as_tensor(np.asarray(params[k], np.float32), device=device)
        for k in ("FA", "phi", "TAU", "T1", "T2")})


def _fill_columns(dst, cols, scalar, lanes, N):
    """Copy the column bank entries `cols` into ``dst``, the real view
    (N_echo, B, ncols, 2) of one output row.

    ``scalar`` holds the (re, im) pairs of (B, N) tensors of tokens 0-2
    (sig, dT1, dT2; only the magnitude row's bank has them: Hessian specs
    take tokens >= 3); ``lanes`` the (re, im) blocks (B, N_echo, N_pulse)
    of tokens 3.. (dalpha) and 3 + N.. (dtau).  Consecutive tokens of one
    block become one strided slice copy."""
    pos = 0
    while pos < len(cols):
        c = cols[pos]
        if c < 3:
            for ri in (0, 1):
                dst[:, :, pos, ri].copy_(scalar[c][ri].T)
            pos += 1
            continue
        blk, i0 = divmod(c - 3, N)
        end = pos + 1
        while (end < len(cols) and cols[end] == c + end - pos
               and (cols[end] - 3) // N == blk):
            end += 1
        for ri in (0, 1):
            dst[:, :, pos:end, ri].copy_(
                lanes[blk][ri][:, :, i0:i0 + end - pos].permute(1, 0, 2))
        pos = end


def _assemble_hess_outputs(out, specs, bshape, N):
    """Per-probe complex outputs of the Hessian kernel's dict
    (``_run_hess_jit`` of the JAX dispatcher, :1911-1963, without its
    column-bank copies): signal (N, *bshape), Jacobian (N, *bshape, k),
    Hessian (N, *bshape, n1, n2)."""
    B = out["sig"][0].shape[0]
    cplx = (torch.complex64 if out["sig"][0].dtype == torch.float32
            else torch.complex128)
    # the bank rows: 0 = magnitude (first order), 1 = dT1, 2 = dT2
    banks = {0: ((out["sig"], out["dT1"], out["dT2"]),
                 (out["dalpha"], out["dtau"]))}
    for ri, key in ((1, "dT1"), (2, "dT2")):
        if key + "dalpha" in out:
            banks[ri] = (None, (out[key + "dalpha"], out[key + "dtau"]))
    glob = {"magnitude": 0, "T1": 1, "T2": 2}
    outs = []
    for spec in specs:
        if spec[0] == "sig":
            sig = torch.complex(out["sig"][0], out["sig"][1])
            outs.append(sig.T.reshape((N,) + bshape))
            continue
        if spec[0] == "jac":
            rows, cols = (0,), spec[1]
        else:
            rows, cols = tuple(glob[v] for v in spec[1]), spec[2]
        res = torch.empty((N, B, len(rows), len(cols)), dtype=cplx,
                          device=out["sig"][0].device)
        view = torch.view_as_real(res)
        for r, ri in enumerate(rows):
            _fill_columns(view[:, :, r], cols, *banks[ri], N)
        if spec[0] == "jac":
            res = res[:, :, 0]
        outs.append(res.reshape((N,) + bshape + res.shape[2:]))
    return tuple(outs)


def run_fisp_hessian(params, nstate, specs, second_order):
    """Run the per-pulse Hessian kernel for matched diff probes
    (``epgpy_tpu/fisp_dispatch.py:1966``).

    Returns a tuple over probes of complex tensors in the engine's layout:
    signal (N, *batch), Jacobian (N, *batch, k), Hessian (N, *batch, n1,
    n2), columns in probe-variable order."""
    d = hess_device_params(params)
    out = cuda_hessian.fisp_hessian_cuda(
        d["FA"], d["phi"], d["TAU"], d["T1"], d["T2"], te=params.get("TE"),
        inversion=params.get("TI"), nstate=max(int(nstate), 1),
        second_order=bool(second_order))
    return _assemble_hess_outputs(out, specs, tuple(params["shape"]),
                                  len(params["FA"]))


def match_jacobian_probes(probes, tracked):
    """Map a simulate() probe tuple onto the fused Jacobian kernel's
    outputs (``epgpy_tpu/fisp_dispatch.py:2026``).

    Accepts only plain F0 ``Adc`` probes and ``Jacobian`` probes (F0) over
    ``{"magnitude"} | tracked``, at least one Jacobian.  Returns a tuple
    of per-probe specs -- ``("sig",)`` or ``("jac", names)`` -- or None.
    "magnitude" maps to the signal itself (dS/d|M0| = S).  Hessians and
    other probes take the general path.
    """
    from . import diff
    from .ops.probe import Adc

    tracked = set(tracked or ())
    specs = []
    for pb in probes:
        if isinstance(pb, diff.Hessian):
            return None
        if isinstance(pb, diff.Jacobian):
            names = tuple(pb.variables)
            if pb.probe_attr != "F0" or any(
                    v != "magnitude" and v not in tracked for v in names):
                return None
            specs.append(("jac", names))
        elif type(pb) is Adc and _plain_adc(pb) and pb.phase is None:
            specs.append(("sig",))
        else:
            return None
    return tuple(specs) if any(s[0] == "jac" for s in specs) else None


def _assemble_jac_outputs(re, im, dre, dim, specs, bshape, cols):
    """Per-probe outputs of the fused Jacobian kernel
    (``epgpy_tpu/fisp_dispatch.py:1987``).

    ``re/im``: (P, B) signal; ``dre/dim``: (P, B, G) tangent columns;
    ``cols`` maps each tracked name to its column and scale.  Returns a
    tuple of complex tensors: the signal (P, *bshape), a Jacobian
    (P, *bshape, k) with columns in probe-variable order."""
    P = re.shape[0]
    cplx = torch.complex64 if re.dtype == torch.float32 else torch.complex128
    outs = []
    for spec in specs:
        if spec[0] == "sig":
            outs.append(torch.complex(re, im).reshape((P,) + bshape))
            continue
        names = spec[1]
        jac = torch.empty(re.shape + (len(names),), dtype=cplx,
                          device=re.device)
        parts = torch.view_as_real(jac)              # (P, B, k, 2)
        for j, name in enumerate(names):
            if name == "magnitude":
                parts[..., j, 0], parts[..., j, 1] = re, im
            else:
                g, scale = cols[name]
                if scale is None:
                    parts[..., j, 0] = dre[..., g]
                    parts[..., j, 1] = dim[..., g]
                else:
                    parts[..., j, 0] = dre[..., g] * scale
                    parts[..., j, 1] = dim[..., g] * scale
        outs.append(jac.reshape((P,) + bshape + (len(names),)))
    return tuple(outs)


def run_fisp_jacobian(params, nstate, specs):
    """Run the fused Jacobian kernel for matched diff probes
    (``epgpy_tpu/fisp_dispatch.py:2061-2123``).

    Returns a tuple over probes of complex tensors in the engine's layout:
    signal (N, *batch), Jacobian (N, *batch, k) with columns in
    probe-variable order.  The kernel's dB1 column is w.r.t. its factored
    B1; dividing by the matcher's ``b1_scale`` expresses it in the user's
    B1 units."""
    d = device_params(params)
    (re, im), (dre, dim) = cuda_fisp.fisp_jacobian_echoes(
        d["FA"], d["phi"], d["TR"], d["TE"], d["T1"], d["T2"], d["B1"],
        d["df"], nstate=max(int(nstate), 1),
        demodulate=bool(params.get("demod")), inversion=params.get("TI"),
        inversion_df=bool(params.get("inv_df")))
    cols = {"T1": (0, None), "T2": (1, None),
            "B1": (2, _b1_inv(params, re.dtype))}
    return _assemble_jac_outputs(re, im, dre, dim, specs,
                                 tuple(params["shape"]), cols)


# -- the CPMG / multi-spin-echo family (epgpy_tpu/fisp_dispatch.py:
# 628-666, 1349-1650) --


def mse_kernel_fits(nstate, diffusion=False) -> bool:
    """Whether the CPMG kernel's 6 planes (12 with the DW-TSE attenuation)
    fit in one block's shared memory (see cuda_mse.mse_kernel_fits)."""
    return cuda_mse.mse_kernel_fits(max(int(nstate), 1), diffusion)


def mse_jac_kernel_fits(nstate, diffusion=False) -> bool:
    """Whether the CPMG Jacobian kernel's 24 planes (30 with diffusion)
    fit in one block's shared memory (see cuda_mse.mse_jac_kernel_fits)."""
    return cuda_mse.mse_jac_kernel_fits(max(int(nstate), 1), diffusion)


def match_mse(sequence, kvalue=1.0):
    """Match CPMG / multi-spin-echo trains and extract kernel parameters
    (``epgpy_tpu/fisp_dispatch.py:1349``).

    Pattern: ``[T(exc)] + [E, S(1), D?, T(ref_i), E, S(1), D?, ADC] * E``
    with the E and S ops in either order within each half (they commute:
    the shift moves only F states, the decay is k-independent and the
    recovery lands at k = 0).  Echo spacings may vary per echo, refocusing
    flips may be a rank-1 ``outer(FA, B1)`` batch (the reference's
    ``T(180 * att, 0)`` sweep); scalar excitation, g = 0 on every E, at
    least 2 echoes.  E ops may carry canonical ``order1=["T1", "T2"]``
    (the same on every E) and refocusing T ops the B1 chain-rule spec
    ``order1={"B1": {"alpha": c_i}}``, for :func:`run_mse_jacobian`.  The
    optional D ops make it a DW-TSE train: one D instance per half
    position, reused across echoes, after the half's shift (k=1 ramps,
    k=None constant-k); `kvalue` sets the physical b-values.

    Returns ``dict(exc, FA, phi, tau1, tau2, T1, T2, B1, shape, vars,
    b1_scale, diffusion)`` of host values -- the JAX matcher's keys and
    values -- or None, logging the reason at INFO; memoized on operator
    identities (and kvalue).
    """
    n = len(sequence)
    if n < 13 or not isinstance(kvalue, (int, float)):
        params, reason = None, (
            f"{n} ops (kvalue {kvalue!r}) is not [T(exc)] + [E, S(1), D?, "
            f"T, E, S(1), D?, ADC] x E (E >= 2) with a host scalar kvalue")
    else:
        key = ("mse", float(kvalue)) + tuple(id(op) for op in sequence)
        params, reason = _memoized(key, sequence,
                                   lambda: _match_mse_impl(sequence, kvalue))
    if params is None:
        LOGGER.info("match_mse: not a CPMG train: %s", reason)
    return params


def _dw_bvalue(dops, kvalue, allow_diff=False):
    """Shared D-op validation and b-value base of the DW matchers
    (``epgpy_tpu/fisp_dispatch.py:628``): one D instance reused across
    the train, a host-scalar tau, a unit ramp (k=1) or constant k
    (k=None), a host scalar or 2-D tensor Dcoef.  Returns ``(b_base, ramp,
    Dcoef)`` -- ``tau[s] * (kvalue[rad/mm])^2`` per squared state index --
    or the zero stage when the list is all None, or None (no match)."""
    d0 = dops[0]
    if any(d is not d0 for d in dops):
        return None
    if d0 is None:
        return 0.0, True, np.float32(0.0)
    if not isinstance(d0.tau, float):
        return None
    if not allow_diff and not _no_diff(d0):
        return None
    if _is_device(d0.Dcoef):
        return None
    ramp = d0.kshift is not None
    if ramp:
        ks = np.asarray(d0.kshift)
        if ks.shape != (1, 1) or float(ks[0, 0]) != 1.0:
            return None
    dc = np.asarray(_host(d0.Dcoef))
    if dc.ndim not in (0, 2):
        return None
    return d0.tau * 1e-3 * (float(kvalue) * 1e-3) ** 2, ramp, dc


def _match_mse_impl(sequence, kvalue=1.0):
    """(params, None) for a CPMG train, else (None, reason)."""
    from .ops.diffusion import D as Dop
    from .ops.evolution import E
    from .ops.probe import Adc
    from .ops.shift import S
    from .ops.transition import T

    exc = sequence[0]
    if type(exc) is not T or not _no_diff(exc):
        return None, "op 0 is not an untracked excitation T"
    exc_a, exc_p = _scalar(exc.alpha), _scalar(exc.phi)
    if exc_a is None or exc_p is None:
        return None, "op 0: excitation not host scalars"

    def half(ops_, at):
        """One echo half: one E and one S(1) in either order, then
        optionally one D (a D before the shift would see pre-shift
        wavenumbers).  Returns (e, d) or a reason string."""
        e = s = d = None
        for op in ops_:
            if type(op) is E and e is None:
                e = op
            elif type(op) is S and s is None:
                s = op
            elif type(op) is Dop and d is None and s is not None:
                d = op
            else:
                return (f"ops {at}-{at + len(ops_) - 1}: not one E and one "
                        f"S(1), then at most one D")
        if e is None or s is None:
            return f"ops {at}-{at + len(ops_) - 1}: no E or no S"
        if _canonical_order1(e) is None or not _no_diff(s):
            return f"ops {at}-{at + len(ops_) - 1}: derivative spec the " \
                   f"kernel does not take"
        if s._kint != 1:
            return f"ops {at}-{at + len(ops_) - 1}: shift is not S(1)"
        if _scalar(e.g) != 0.0:
            return f"ops {at}-{at + len(ops_) - 1}: off-resonance g != 0"
        return e, d

    n = len(sequence)
    alphas, phis, tau1s, tau2s, b1_coeffs = [], [], [], [], []
    d1_ops, d2_ops = [], []
    T1 = T2 = tracked = None
    i = 1
    while i < n:
        # half 1 up to the refocusing T, half 2 up to the Adc
        j = i
        while j < n and type(sequence[j]) is not T:
            j += 1
        if j >= n or not 2 <= j - i <= 3:
            return None, f"ops {i}-{j - 1}: no [E, S(1), D?] half before a T"
        k = j + 1
        while k < n and type(sequence[k]) is not Adc:
            k += 1
        if k >= n or not 2 <= k - j - 1 <= 3:
            return None, f"ops {j + 1}-{k - 1}: no [E, S(1), D?] half " \
                         f"before an ADC"
        h1, h2 = half(sequence[i:j], i), half(sequence[j + 1:k], j + 1)
        t_op, adc = sequence[j], sequence[k]
        i = k + 1
        for h in (h1, h2):
            if isinstance(h, str):
                return None, h
        (e1, d1), (e2, d2) = h1, h2
        d1_ops.append(d1)
        d2_ops.append(d2)
        c1, c2 = _canonical_order1(e1), _canonical_order1(e2)
        if c1 != c2 or (tracked is not None and tracked != c1):
            return None, (f"ops {j - 2}-{k - 1}: E derivative specs are not "
                          f"one canonical T1/T2 tracking")
        tracked = c1
        if not _plain_adc(adc) or adc.phase is not None or not _no_diff(adc):
            return None, f"op {k}: not a plain F0 readout"
        # the kernel's dB1 covers the refocusing flips exactly (the
        # scalar excitation is B1-exact: tangents start at zero)
        b1c = _t_b1_order1(t_op)
        if b1c is None:
            return None, f"op {j}: derivative spec the kernel does not take"
        b1_coeffs.append(b1c)
        ph, ta, tb = _scalar(t_op.phi), _scalar(e1.tau), _scalar(e2.tau)
        if ph is None or ta is None or tb is None:
            return None, f"ops {j - 2}-{k - 1}: phase or delay not a host " \
                         f"scalar"
        for e in (e1, e2):
            t1v, t2v = _host_nd(e.T1), _host_nd(e.T2)
            if t1v is None or t2v is None:
                return None, f"{e.name}: T1/T2 not host values"
            if T1 is None:
                T1, T2 = t1v, t2v
            elif not (np.array_equal(T1, t1v) and np.array_equal(T2, t2v)):
                return None, f"{e.name}: T1/T2 differ from echo 0's"
        a = _host_nd(t_op.alpha)
        if a is None:
            return None, f"op {j}: flip angle not a host value"
        alphas.append(a)
        phis.append(ph)
        tau1s.append(ta)
        tau2s.append(tb)

    if len(alphas) < 2:
        return None, "fewer than 2 echoes"
    fab = _rank1_factor(alphas)
    if fab is None:
        return None, "refocusing flips are not rank-1 outer(FA, B1)"
    FA, B1 = fab
    b1_scale = None
    if any(c != () for c in b1_coeffs):
        b1_scale = _b1_scale_from_coeffs(FA, b1_coeffs)
        if b1_scale is None:
            return None, "B1 chain-rule coefficients are not one ratio of FA"

    diffusion = None
    if any(d is not None for d in d1_ops + d2_ops):
        f1, f2 = _dw_bvalue(d1_ops, kvalue), _dw_bvalue(d2_ops, kvalue)
        if f1 is None or f2 is None:
            return None, ("D ops are not one untracked host D(tau, Dcoef, "
                          "k=1 | None) per half position")
        diffusion = {"b1": f1[0], "ramp1": f1[1], "D1": f1[2],
                     "b2": f2[0], "ramp2": f2[1], "D2": f2[2]}

    # n-D batch grids (the published T2 x attenuation sweep) flatten to
    # the kernel's atom axis; the runners restore the batch shape
    if not common.broadcastable(T1.shape, T2.shape, B1.shape):
        return None, "T1, T2 and B1 batch shapes do not broadcast"
    bshape = common.broadcast_shapes(T1.shape, T2.shape, B1.shape)
    T1f, T2f, B1f = _append_rows((T1, T2, B1), bshape)
    return {
        "exc": (exc_a, exc_p), "FA": FA, "phi": np.asarray(phis),
        "tau1": np.asarray(tau1s), "tau2": np.asarray(tau2s),
        "T1": T1f, "T2": T2f, "B1": B1f, "shape": bshape,
        "vars": tracked if b1_scale is None
        else tuple(sorted(tracked + ("B1",))),
        "b1_scale": b1_scale, "diffusion": diffusion,
    }, None


def _mse_device_params(params, device=None):
    """The CPMG kernels' tensors for a match dict in the working precision
    (float32 for the kernels; the plain twins take float64 too), cached
    on it per device and precision; exc stays host floats."""
    def build(device, dtype):
        return {k: torch.as_tensor(np.array(params[k], np.float64),
                                   dtype=dtype, device=device)
                for k in ("FA", "phi", "tau1", "tau2", "T1", "T2", "B1")}

    return _cached_device(params, device, build, config.real_dtype())


def _mse_diff_planes(diffusion):
    """Kernel-layout DW-TSE stages from the matched dict: a tensor D with
    1-D wavenumbers reduces to b00 * sum(D) (reference
    epgpy/diffusion.py broadcast semantics); the kernels broadcast a
    scalar diffusivity over the atoms."""
    def dcoef(Dc):
        Dc = np.asarray(Dc, np.float64)
        return float(Dc if Dc.ndim == 0 else Dc.sum())

    return (diffusion["b1"], diffusion["b1"], diffusion["b2"],
            diffusion["b2"], dcoef(diffusion["D1"]), dcoef(diffusion["D2"]))


def _mse_diffusion_args(params):
    """(diffusion tuple or None, ramp flags) for the CPMG runners."""
    diff = params.get("diffusion")
    if diff is None:
        return None, (True, True)
    return _mse_diff_planes(diff), (bool(diff["ramp1"]),
                                    bool(diff["ramp2"]))


def _mse_args(params):
    d = _mse_device_params(params)
    return (tuple(params["exc"]), d["FA"], d["phi"], d["tau1"], d["tau2"],
            d["T1"], d["T2"], d["B1"])


def run_mse_kernel(params, nstate):
    """Run the CPMG kernel on a match dict; returns the echo train as a
    complex tensor in the engine's layout, (E, *batch)."""
    diff, ramps = _mse_diffusion_args(params)
    re, im = cuda_mse.cpmg_echoes(*_mse_args(params),
                                  nstate=max(int(nstate), 1),
                                  diffusion=diff, diff_ramp=ramps)
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))


def run_mse_jacobian(params, nstate, specs):
    """Run the CPMG Jacobian kernel for matched diff probes
    (``epgpy_tpu/fisp_dispatch.py:1632``).

    DW-TSE trains ride through (the attenuation is parameter-free for
    (T1, T2, B1)).  B1-tracked refocusing trains get the kernel's dB1
    column divided by the matcher's ``b1_scale`` (the user's B1 units).
    Returns a tuple over probes: signal (E, *batch), Jacobian (E, *batch,
    k) with columns in probe-variable order."""
    diff, ramps = _mse_diffusion_args(params)
    (re, im), (dre, dim) = cuda_mse.cpmg_jacobian_echoes(
        *_mse_args(params), nstate=max(int(nstate), 1), diffusion=diff,
        diff_ramp=ramps)
    cols = {"T1": (0, None), "T2": (1, None),
            "B1": (2, _b1_inv(params, re.dtype))}
    return _assemble_jac_outputs(re, im, dre, dim, specs,
                                 tuple(params["shape"]), cols)


# -- the balanced-SSFP and DESS families (epgpy_tpu/fisp_dispatch.py:
# 793-1110) --


def match_bssfp(sequence):
    """Match balanced SSFP (TrueFISP) trains ``[T, E, ADC, E] * N``
    (``epgpy_tpu/fisp_dispatch.py:793``).

    The spoiler-free sibling of :func:`match_fisp` (the same checks minus
    the S op; the EPG ladder never leaves k = 0): per-pulse flip, phase,
    TR and TE, rank-1 ``outer(FA, B1)`` flip batches, per-atom
    off-resonance (``E.g``, a mapped parameter in bSSFP MRF, Ma 2013),
    receiver demodulation ``Adc(phase=-phi_i)`` and an optional
    ``[T(180-family), E(TI)]`` inversion prep, whose E carries the train's
    off-resonance.  E ops may track ``order1=["T1", "T2"]`` and ``"g"``.
    Returns the :func:`match_fisp` dict or None, logging the reason at
    INFO; memoized on operator identities.
    """
    n = len(sequence)
    if n < 8 or n % 4 not in (0, 2):
        params, reason = None, (
            f"{n} ops is not [T, E, ADC, E] x N (N >= 2), optionally after "
            f"a [T, E] inversion prep")
    else:
        key = ("bssfp",) + tuple(id(op) for op in sequence)
        params, reason = _memoized(
            key, sequence, lambda: _match_fisp_impl(sequence, spoiled=False))
    if params is None:
        LOGGER.info("match_bssfp: not a bSSFP train: %s", reason)
    return params


def _ssfp_args(params):
    """The bSSFP and DESS kernels' positional tensors of a match dict, in
    the working precision (float32 for the kernels)."""
    d = device_params(params, dtype=config.real_dtype())
    return (d["FA"], d["phi"], d["TR"], d["TE"], d["T1"], d["T2"], d["B1"],
            d["df"])


def _b1_inv(params, dtype):
    """1/b1_scale in the kernel's precision (as the JAX runners scale), or
    None for a train without B1 tracking."""
    b1s = params.get("b1_scale")
    if b1s is None:
        return None
    if dtype == torch.float32:
        return float(np.float32(1.0) / np.float32(b1s))
    return 1.0 / float(b1s)


def run_bssfp_kernel(params, nstate=None):
    """Run the bSSFP kernel on a match dict; returns the echo train as a
    complex tensor in the engine's layout, (N, *batch).  `nstate` is taken
    for the engine's uniform call and ignored: there is no ladder."""
    re, im = cuda_bssfp.bssfp_echoes(
        *_ssfp_args(params), demodulate=bool(params.get("demod")),
        inversion=params.get("TI"))
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))


def run_bssfp_jacobian(params, nstate, specs):
    """Run the bSSFP Jacobian kernel for matched diff probes
    (``epgpy_tpu/fisp_dispatch.py:843-887``; `nstate` ignored).

    A tracked ``g`` turns on the kernel's ddf tangent group (column 3);
    B1-tracked trains get the kernel's dB1 column (2) divided by the
    matcher's ``b1_scale``.  Returns a tuple over probes: signal
    (N, *batch), Jacobian (N, *batch, k) with columns in probe-variable
    order."""
    track_df = "g" in (params.get("vars") or ())
    (re, im), (dre, dim) = cuda_bssfp.bssfp_jacobian_echoes(
        *_ssfp_args(params), demodulate=bool(params.get("demod")),
        inversion=params.get("TI"), track_df=track_df)
    cols = {"T1": (0, None), "T2": (1, None)}
    if track_df:
        cols["g"] = (3, None)
    inv = _b1_inv(params, re.dtype)
    if inv is not None:
        cols["B1"] = (2, inv)
    return _assemble_jac_outputs(re, im, dre, dim, specs,
                                 tuple(params["shape"]), cols)


def match_dess(sequence):
    """Match DESS trains ``[T, E, ADC, E, S(1), E, ADC] * N``
    (``epgpy_tpu/fisp_dispatch.py:890``).

    The double-echo steady-state family (reference examples/basics/
    dess.py): one FISP echo at TE after each pulse and one PSIF echo
    after the gradient.  Per-TR flip, phase and timing, rank-1
    ``outer(FA, B1)`` flips, per-atom off-resonance and ``Adc(phase=
    -phi)`` demodulation (on both echoes) are accepted; E ops may track
    ``order1=["T1", "T2"]`` and T ops B1.  The PSIF echo depends only on
    the full TR = tau1 + tau2 + tau3.  Returns the JAX matcher's dict
    ``(FA, phi, TR, TE, T1, T2, B1, TI, vars, b1_scale, demod, shape,
    df)`` or None, logging the reason at INFO; memoized on operator
    identities.
    """
    n = len(sequence)
    if n < 14 or n % 7 != 0:
        params, reason = None, (f"{n} ops is not [T, E, ADC, E, S(1), E, "
                                f"ADC] x N (N >= 2)")
    else:
        key = ("dess",) + tuple(id(op) for op in sequence)
        params, reason = _memoized(key, sequence,
                                   lambda: _match_dess_impl(sequence))
    if params is None:
        LOGGER.info("match_dess: not a DESS train: %s", reason)
    return params


def _match_dess_impl(sequence):
    """(params, None) for a DESS train, else (None, reason)."""
    from .ops.evolution import E
    from .ops.probe import Adc
    from .ops.shift import S
    from .ops.transition import T

    types = (T, E, Adc, E, S, E, Adc)
    alphas, phis, te_taus, tr_taus, adc_phases = [], [], [], [], []
    b1_coeffs = []
    T1 = T2 = DF = tracked = None
    for i in range(len(sequence) // 7):
        ops = sequence[7 * i:7 * i + 7]
        for j, (op, typ) in enumerate(zip(ops, types)):
            if type(op) is not typ:
                return None, (f"op {7 * i + j} ({op.name}) is not "
                              f"{typ.__name__}")
        t_op, e1, a1, e2, s, e3, a2 = ops
        at = 7 * i
        b1c = _t_b1_order1(t_op)
        if b1c is None or not all(map(_no_diff, (a1, a2, s))):
            return None, (f"ops {at}-{at + 6}: derivative spec the kernel "
                          f"does not take")
        b1_coeffs.append(b1c)
        if s._kint != 1:
            return None, f"op {at + 4}: shift is not S(1)"
        cs = [_canonical_order1(e) for e in (e1, e2, e3)]
        if cs[0] is None or cs[0] != cs[1] or cs[0] != cs[2] \
                or (tracked is not None and tracked != cs[0]):
            return None, (f"ops {at + 1},{at + 3},{at + 5}: E derivative "
                          f"specs are not one canonical T1/T2 tracking")
        tracked = cs[0]
        ph = _scalar(t_op.phi)
        taus = [_scalar(e.tau) for e in (e1, e2, e3)]
        if ph is None or any(t is None for t in taus):
            return None, f"ops {at}-{at + 5}: phase or delay not a host scalar"
        # both ADCs: F0, phase absent or a host scalar
        for k, adc in ((at + 2, a1), (at + 6, a2)):
            ph_adc = None if adc.phase is None else _scalar(adc.phase)
            if not _plain_adc(adc) or (adc.phase is not None
                                    and ph_adc is None):
                return None, f"op {k}: not a plain F0 readout"
            adc_phases.append(ph_adc)
        g1, g2, g3 = (_host_nd(e.g) for e in (e1, e2, e3))
        if (g1 is None or g2 is None or g3 is None
                or not np.array_equal(g1, g2)
                or not np.array_equal(g1, g3)):
            return None, (f"ops {at + 1},{at + 3},{at + 5}: off-resonance "
                          f"differs")
        if DF is None:
            DF = g1
        elif not np.array_equal(DF, g1):
            return None, f"op {at + 1}: off-resonance differs from TR 0"
        for e in (e1, e2, e3):
            t1v, t2v = _host_nd(e.T1), _host_nd(e.T2)
            if t1v is None or t2v is None:
                return None, f"{e.name}: T1/T2 not host values"
            if T1 is None:
                T1, T2 = t1v, t2v
            elif not (np.array_equal(T1, t1v) and np.array_equal(T2, t2v)):
                return None, f"{e.name}: T1/T2 differ from TR 0's"
        a = _host_nd(t_op.alpha)
        if a is None:
            return None, f"op {at}: flip angle not a host value"
        alphas.append(a)
        phis.append(ph)
        te_taus.append(taus[0])
        tr_taus.append(taus[0] + taus[1] + taus[2])

    te_arr = np.asarray(te_taus)
    TE = float(te_arr[0]) if (te_arr == te_arr[0]).all() else te_arr
    # ADC phases: all absent -> plain; all equal to -phi_i -> receiver
    # demodulation on both echoes
    if all(p is None for p in adc_phases):
        demod = False
    elif any(p is None for p in adc_phases):
        return None, "some readouts are demodulated, some not"
    else:
        d = (np.asarray(adc_phases) + np.repeat(np.asarray(phis), 2)) % 360.0
        if (np.minimum(d, 360.0 - d) > 1e-6).any():
            return None, "readout phases are not -phi_i"
        demod = True
    fab = _rank1_factor(alphas)
    if fab is None:
        return None, "flip angles are not rank-1 outer(FA, B1)"
    FA, B1 = fab
    b1_scale = None
    if any(c != () for c in b1_coeffs):
        b1_scale = _b1_scale_from_coeffs(FA, b1_coeffs)
        if b1_scale is None:
            return None, "B1 chain-rule coefficients are not one ratio of FA"
    if not common.broadcastable(T1.shape, T2.shape, B1.shape, DF.shape):
        return None, "T1, T2, B1 and df batch shapes do not broadcast"
    bshape = common.broadcast_shapes(T1.shape, T2.shape, B1.shape, DF.shape)
    T1f, T2f, B1f, DFf = _append_rows((T1, T2, B1, DF), bshape)
    return {
        "FA": FA, "phi": np.asarray(phis), "TR": np.asarray(tr_taus),
        "TE": TE, "T1": T1f, "T2": T2f, "B1": B1f, "TI": None,
        "vars": tracked if b1_scale is None
        else tuple(sorted(tracked + ("B1",))),
        "b1_scale": b1_scale, "demod": demod, "shape": bshape,
        "df": DFf if DFf.any() else None,
    }, None


def run_dess_kernel(params, nstate):
    """Run the DESS kernel on a match dict; returns both echo trains as
    one complex tensor in the engine's layout, (2N, *batch) with rows
    FISP_0, PSIF_0, FISP_1, ... (the kernel writes that order)."""
    re, im = cuda_dess.dess_echoes(
        *_ssfp_args(params), nstate=max(int(nstate), 1),
        demodulate=bool(params.get("demod")))
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))


def run_dess_jacobian(params, nstate, specs):
    """Run the DESS Jacobian kernel for matched diff probes
    (``epgpy_tpu/fisp_dispatch.py:1051-1110``): both echoes' signal and
    Jacobian rows in ADC order (FISP_0, PSIF_0, ...), the dB1 columns of
    B1-tracked trains divided by the matcher's ``b1_scale``.  Returns a
    tuple over probes: signal (2N, *batch), Jacobian (2N, *batch, k)."""
    (re, im), (dre, dim) = cuda_dess.dess_jacobian_echoes(
        *_ssfp_args(params), nstate=max(int(nstate), 1),
        demodulate=bool(params.get("demod")))
    cols = {"T1": (0, None), "T2": (1, None)}
    inv = _b1_inv(params, re.dtype)
    if inv is not None:
        cols["B1"] = (2, inv)
    return _assemble_jac_outputs(re, im, dre, dim, specs,
                                 tuple(params["shape"]), cols)


# -- the ME-GRE family (epgpy_tpu/fisp_dispatch.py:1113-1346) --


def match_megre(sequence):
    """Match multi-echo spoiled GRE trains ``[T, (E, ADC) * m, E?, S(1)] *
    N`` with m >= 2 echoes per TR (``epgpy_tpu/fisp_dispatch.py:1113``).

    The T2*/B0-mapping acquisition: m echoes at increasing cumulative echo
    times before the spoiler (single-echo trains belong to
    :func:`match_fisp`; DESS reads its second echo after the shift and is
    disjoint).  Per-TR flip, phase and timing, rank-1 ``outer(FA, B1)``
    flips, per-atom off-resonance and ``Adc(phase=-phi)`` demodulation are
    accepted; the echo count and the trailing E must be the same in every
    TR.  E ops may track ``order1=["T1", "T2", "g"]`` (one spec on every
    E), T ops B1.  Returns the JAX matcher's dict ``(FA, phi, TR, TE, T1,
    T2, B1, TI, vars, b1_scale, demod, shape, nechoes, df)`` -- TE the (m,
    N) cumulative echo times, TR the full TRs -- or None, logging the
    reason at INFO; memoized on operator identities.
    """
    n = len(sequence)
    if n < 12:
        params, reason = None, f"{n} ops is shorter than 2 TRs of 2 echoes"
    else:
        key = ("megre",) + tuple(id(op) for op in sequence)
        params, reason = _memoized(key, sequence,
                                   lambda: _match_megre_impl(sequence))
    if params is None:
        LOGGER.info("match_megre: not an ME-GRE train: %s", reason)
    return params


def _match_megre_impl(sequence):
    """(params, None) for an ME-GRE train, else (None, reason)."""
    from .ops.evolution import E
    from .ops.probe import Adc
    from .ops.shift import S
    from .ops.transition import T

    # echo count and block shape from the first TR
    if type(sequence[0]) is not T:
        return None, "op 0 is not T"
    m, i = 0, 1
    while (i + 1 < len(sequence) and type(sequence[i]) is E
           and type(sequence[i + 1]) is Adc):
        m, i = m + 1, i + 2
    if m < 2 or i >= len(sequence):
        return None, f"TR 0 reads {m} echo(es), not m >= 2 before the shift"
    has_rest = type(sequence[i]) is E
    L = 2 + 2 * m + int(has_rest)
    if len(sequence) % L != 0 or len(sequence) // L < 2:
        return None, (f"{len(sequence)} ops is not N >= 2 blocks of TR 0's "
                      f"{L} ops")

    alphas, phis, adc_phases, te_rows, tr_taus, b1_coeffs = \
        [], [], [], [], [], []
    T1 = T2 = DF = tracked = None
    for b in range(len(sequence) // L):
        blk = sequence[L * b:L * (b + 1)]
        at = L * b
        t_op, s_op = blk[0], blk[-1]
        e_ops = list(blk[1:1 + 2 * m:2]) + (list(blk[-2:-1]) if has_rest
                                            else [])
        adcs = blk[2:2 + 2 * m:2]
        if (type(t_op) is not T or type(s_op) is not S
                or any(type(e) is not E for e in e_ops)
                or any(type(a) is not Adc for a in adcs)):
            return None, f"ops {at}-{at + L - 1}: not TR 0's block shape"
        b1c = _t_b1_order1(t_op)
        if b1c is None or not all(map(_no_diff, [s_op] + list(adcs))):
            return None, (f"ops {at}-{at + L - 1}: derivative spec the "
                          f"kernel does not take")
        b1_coeffs.append(b1c)
        if s_op._kint != 1:
            return None, f"op {at + L - 1}: shift is not S(1)"
        cs = [_canonical_order1(e, allowed=("T1", "T2", "g")) for e in e_ops]
        if cs[0] is None or any(c != cs[0] for c in cs) \
                or (tracked is not None and tracked != cs[0]):
            return None, (f"ops {at}-{at + L - 1}: E derivative specs are "
                          f"not one canonical T1/T2/g tracking")
        tracked = cs[0]
        ph = _scalar(t_op.phi)
        taus = [_scalar(e.tau) for e in e_ops]
        if ph is None or any(t is None for t in taus):
            return None, (f"ops {at}-{at + L - 1}: phase or delay not a "
                          f"host scalar")
        for adc in adcs:
            ph_adc = None if adc.phase is None else _scalar(adc.phase)
            if not _plain_adc(adc) or (adc.phase is not None
                                    and ph_adc is None):
                return None, f"ops {at}-{at + L - 1}: not a plain F0 readout"
            adc_phases.append(ph_adc)
        gs = [_host_nd(e.g) for e in e_ops]
        if any(g is None for g in gs) \
                or any(not np.array_equal(gs[0], g) for g in gs[1:]):
            return None, f"ops {at}-{at + L - 1}: off-resonance differs"
        if DF is None:
            DF = gs[0]
        elif not np.array_equal(DF, gs[0]):
            return None, f"op {at + 1}: off-resonance differs from TR 0's"
        for e in e_ops:
            t1v, t2v = _host_nd(e.T1), _host_nd(e.T2)
            if t1v is None or t2v is None:
                return None, f"{e.name}: T1/T2 not host values"
            if T1 is None:
                T1, T2 = t1v, t2v
            elif not (np.array_equal(T1, t1v) and np.array_equal(T2, t2v)):
                return None, f"{e.name}: T1/T2 differ from TR 0's"
        a = _host_nd(t_op.alpha)
        if a is None:
            return None, f"op {at}: flip angle not a host value"
        alphas.append(a)
        phis.append(ph)
        te_rows.append(np.cumsum(taus[:m]))
        tr_taus.append(float(np.sum(taus)))

    TE = np.asarray(te_rows).T                       # (m, N)
    TR = np.asarray(tr_taus)
    # ADC phases: all absent -> plain; all equal to -phi_i -> receiver
    # demodulation on every echo
    if all(p is None for p in adc_phases):
        demod = False
    elif any(p is None for p in adc_phases):
        return None, "some readouts are demodulated, some not"
    else:
        d = (np.asarray(adc_phases) + np.repeat(np.asarray(phis), m)) % 360.0
        if (np.minimum(d, 360.0 - d) > 1e-6).any():
            return None, "readout phases are not -phi_i"
        demod = True
    fab = _rank1_factor(alphas)
    if fab is None:
        return None, "flip angles are not rank-1 outer(FA, B1)"
    FA, B1 = fab
    b1_scale = None
    if any(c != () for c in b1_coeffs):
        b1_scale = _b1_scale_from_coeffs(FA, b1_coeffs)
        if b1_scale is None:
            return None, "B1 chain-rule coefficients are not one ratio of FA"
    if not common.broadcastable(T1.shape, T2.shape, B1.shape, DF.shape):
        return None, "T1, T2, B1 and df batch shapes do not broadcast"
    bshape = common.broadcast_shapes(T1.shape, T2.shape, B1.shape, DF.shape)
    T1f, T2f, B1f, DFf = _append_rows((T1, T2, B1, DF), bshape)
    return {
        "FA": FA, "phi": np.asarray(phis), "TR": TR, "TE": TE,
        "T1": T1f, "T2": T2f, "B1": B1f, "TI": None,
        "vars": tracked if b1_scale is None
        else tuple(sorted(tracked + ("B1",))),
        "b1_scale": b1_scale, "demod": demod, "shape": bshape,
        "nechoes": m, "df": DFf if DFf.any() else None,
    }, None


def run_megre_kernel(params, nstate):
    """Run the ME-GRE kernel on a match dict; returns the echo trains as
    one complex tensor in the engine's layout, (m N, *batch) with row i m
    + j for echo j of TR i (the kernel writes that order)."""
    re, im = cuda_megre.megre_echoes(
        *_ssfp_args(params), nstate=max(int(nstate), 1),
        demodulate=bool(params.get("demod")))
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))


def run_megre_jacobian(params, nstate, specs):
    """Run the ME-GRE Jacobian kernel for matched diff probes
    (``epgpy_tpu/fisp_dispatch.py:1333``): columns T1 0, T2 1, B1 2
    (divided by the matcher's ``b1_scale``) and g 3, the off-resonance
    column, exact at df = 0.  Returns a tuple over probes: signal (m N,
    *batch), Jacobian (m N, *batch, k) in ADC order."""
    (re, im), (dre, dim) = cuda_megre.megre_jacobian_echoes(
        *_ssfp_args(params), nstate=max(int(nstate), 1),
        demodulate=bool(params.get("demod")))
    cols = {"T1": (0, None), "T2": (1, None), "g": (3, None)}
    inv = _b1_inv(params, re.dtype)
    if inv is not None:
        cols["B1"] = (2, inv)
    return _assemble_jac_outputs(re, im, dre, dim, specs,
                                 tuple(params["shape"]), cols)


# -- the DW-FISP family (epgpy_tpu/fisp_dispatch.py:628-790) --


def match_dwfisp(sequence, kvalue=1.0):
    """Match diffusion-weighted FISP trains ``[T, E, ADC, E, S(1), D] * N``
    (optionally after a ``[T, E(TI)]`` prep; ``epgpy_tpu/fisp_dispatch.py:
    669``).

    One isotropic or tensor ``D`` op right after each unit spoiler (``k=1``
    gradient-ramp attenuation, or ``k=None`` constant k), the same op
    instance every TR; ``kvalue`` (rad/m per state index, a host number)
    sets the physical b-values.  A scalar D may track its diffusivity
    (``order1=["Dcoef"]``).  Returns the :func:`match_fisp` dict with its
    ``diffusion`` entry ``(bT, bL, Dcoef, ramp)`` and ``d_var``, or None,
    logging the reason at INFO; memoized on operator identities and
    kvalue.
    """
    n = len(sequence)
    if n < 12 or n % 6 not in (0, 2) or not isinstance(kvalue, (int, float)):
        params, reason = None, (
            f"{n} ops (kvalue {kvalue!r}) is not [T, E, ADC, E, S(1), D] x N "
            f"(N >= 2), optionally after a [T, E] prep, with a host kvalue")
    else:
        key = ("dw", float(kvalue)) + tuple(id(op) for op in sequence)
        params, reason = _memoized(key, sequence, lambda: _match_fisp_impl(
            sequence, dw=True, kvalue=kvalue))
    if params is None:
        LOGGER.info("match_dwfisp: not a DW-FISP train: %s", reason)
    return params


def _dw_diffusion(params):
    """The FISP kernels' ``diffusion=(bT, bL, Dc)`` and ramp flag of a
    DW-FISP match dict: a tensor D with 1-D wavenumbers reduces to
    ``sum(D)`` (reference epgpy/diffusion.py broadcast semantics), a
    scalar the kernels broadcast over the atoms."""
    diff = params["diffusion"]
    Dc = np.asarray(diff["Dcoef"], np.float64)
    Dc = float(Dc if Dc.ndim == 0 else Dc.sum())
    return (float(diff["bT"]), float(diff["bL"]), Dc), bool(diff["ramp"])


def run_dwfisp_kernel(params, nstate):
    """Run the FISP kernel with its DW-FISP attenuation on a match dict;
    returns the echo train as a complex tensor in the engine's layout,
    (N, *batch)."""
    diffusion, ramp = _dw_diffusion(params)
    re, im = cuda_fisp.fisp_echoes(
        *_ssfp_args(params), nstate=max(int(nstate), 1),
        demodulate=bool(params.get("demod")), inversion=params.get("TI"),
        inversion_df=bool(params.get("inv_df")), diffusion=diffusion,
        diff_ramp=ramp)
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))


def run_dwfisp_jacobian(params, nstate, specs):
    """Run the FISP Jacobian kernel with its DW-FISP attenuation for
    matched diff probes (``epgpy_tpu/fisp_dispatch.py:752``): the T1, T2
    and B1 groups ride through the parameter-free attenuation, a tracked
    diffusivity adds the dD column (3, named by ``d_var``), the dB1 column
    is divided by the matcher's ``b1_scale``.  Returns a tuple over
    probes: signal (N, *batch), Jacobian (N, *batch, k)."""
    diffusion, ramp = _dw_diffusion(params)
    d_var = params.get("d_var")
    (re, im), (dre, dim) = cuda_fisp.fisp_jacobian_echoes(
        *_ssfp_args(params), nstate=max(int(nstate), 1),
        demodulate=bool(params.get("demod")), inversion=params.get("TI"),
        inversion_df=bool(params.get("inv_df")), diffusion=diffusion,
        diff_ramp=ramp, track_diffusivity=d_var is not None)
    cols = {"T1": (0, None), "T2": (1, None)}
    inv = _b1_inv(params, re.dtype)
    if inv is not None:
        cols["B1"] = (2, inv)
    if d_var is not None:
        cols[d_var] = (3, None)
    return _assemble_jac_outputs(re, im, dre, dim, specs,
                                 tuple(params["shape"]), cols)


# -- the composite-GRE family (epgpy_tpu/fisp_dispatch.py:2888-3292) --


def match_composite(sequence, kvalue=1.0):
    """Match gradient-echo *stage* trains for the composite kernels
    (``epgpy_tpu/fisp_dispatch.py:2892``).

    A stage is ``[T?, E*, Adc?, E*, S(+-k)?, D?]``, every element optional:
    the op list folds greedily into stages (consecutive E taus accumulate;
    a shift, a second Adc or a D closes the stage; ``S(+-k)`` with |k| <= 8
    expands into |k| unit-shift stages; Wait and other empty ops are
    skipped).  This covers the segmented and prepared GRE trains the
    exact-pattern families reject -- MPRAGE/MP2RAGE, cardiac MRF with IR
    and T2prep preps, saturation recovery, DW-prepared trains -- and is
    the last family of the engine's tables.  Requirements: 3 to 8192
    stages and at least one readout; host scalar taus and phases; one
    shared (T1, T2, g) on every E, which may track them canonically; F0
    Adc ops with an optional host scalar phase; a rank-1 ``outer(FA, B1)``
    of the vector flips, scalar flips being adiabatic (b1u = 0); B1
    tracking on exactly the B1-sensitive stages; D ops with a float tau,
    one shared scalar Dcoef and a ramp (``k=+-1``) only in the direction of
    its stage's shift.  Returns the JAX matcher's dict (FA, phi, ta, tb,
    adci, shift, aph, b1u, T1, T2, B1, df, nadc, shape, vars, b1_scale,
    diffusion: None or {btd, rdir, Dc}, Dc a host float) or None, logging
    the reason at INFO; memoized on the operator identities and kvalue.
    """
    if len(sequence) < 8 or not isinstance(kvalue, (int, float)):
        params, reason = None, (f"{len(sequence)} ops (kvalue {kvalue!r}): "
                                f"fewer than 8, or kvalue not a host number")
    else:
        key = ("comp", float(kvalue)) + tuple(id(op) for op in sequence)
        params, reason = _memoized(
            key, sequence, lambda: _match_composite_impl(sequence, kvalue))
    if params is None:
        LOGGER.info("match_composite: not a composite-GRE stage train: %s",
                    reason)
    return params


def _fold_stages(sequence):
    """(stages, T1, T2, DF, tracked) of the stage grammar, or (None,
    reason): each stage a dict of its flip, phase, ta, tb, readout, ADC
    phase, shift, closing D op and B1 tracking coefficient."""
    from .ops import base as _base
    from .ops.diffusion import D
    from .ops.evolution import E
    from .ops.probe import Adc, Probe
    from .ops.shift import S
    from .ops.transition import T

    stages, cur = [], None

    def new_stage(fa=None, ph=0.0, b1c=()):
        return {"fa": np.zeros(1) if fa is None else fa, "phi": ph,
                "ta": 0.0, "tb": 0.0, "adc": False, "aph": 0.0, "shift": 0,
                "d": None, "b1c": b1c}

    def close():
        nonlocal cur
        if cur is not None:
            stages.append(cur)
            cur = None

    T1 = T2 = DF = tracked = None
    for n, op in enumerate(sequence):
        if type(op) is T:
            b1c = _t_b1_order1(op)
            a, ph = _host_nd(op.alpha), _scalar(op.phi)
            if b1c is None or a is None or ph is None:
                return None, (f"op {n} ({op.name}): flip or phase not a host "
                              f"value, or a derivative spec other than B1")
            close()
            cur = new_stage(a, ph, b1c)
        elif type(op) is E:
            c = _canonical_order1(op, ("T1", "T2", "g"))
            if c is None or (tracked is not None and tracked != c):
                return None, (f"op {n} ({op.name}): E derivative specs are "
                              f"not one canonical T1/T2/g tracking")
            tracked = c
            tau = _scalar(op.tau)
            if tau is None or tau < 0:
                return None, f"op {n} ({op.name}): tau not a host scalar >= 0"
            t1v, t2v, gv = _host_nd(op.T1), _host_nd(op.T2), _host_nd(op.g)
            if t1v is None or t2v is None or gv is None:
                return None, f"op {n} ({op.name}): T1/T2/g not host values"
            if T1 is None:
                T1, T2, DF = t1v, t2v, gv
            elif not (np.array_equal(T1, t1v) and np.array_equal(T2, t2v)
                      and np.array_equal(DF, gv)):
                return None, (f"op {n} ({op.name}): T1, T2 or g differ from "
                              f"the first E's")
            if cur is None or cur["shift"]:
                close()
                cur = new_stage()
            cur["tb" if cur["adc"] else "ta"] += tau
        elif type(op) is Adc:
            ph_adc = None if op.phase is None else _scalar(op.phase)
            if not _plain_adc(op) or (op.phase is not None and ph_adc is None):
                return None, f"op {n}: not a plain F0 readout"
            if cur is None or cur["adc"] or cur["shift"]:
                close()
                cur = new_stage()
            cur["adc"] = True
            cur["aph"] = 0.0 if ph_adc is None else float(ph_adc)
        elif type(op) is S:
            if op._kint is None:
                return None, f"op {n}: a float or vector shift"
            k = op._kint
            if not _no_diff(op) or abs(k) > 8:
                return None, f"op {n}: shift {k} tracked or beyond +-8"
            if cur is None:
                cur = new_stage()
            for _ in range(abs(k)):
                if cur["shift"]:
                    close()
                    cur = new_stage()
                cur["shift"] = 1 if k > 0 else -1
        elif type(op) is D:
            # a D op closes its stage: its attenuation follows the shift
            if cur is None:
                cur = new_stage()
            cur["d"] = op
            close()
        elif isinstance(op, Probe):
            return None, f"op {n}: a probe other than Adc"
        elif not isinstance(op, _base.EmptyOperator):
            return None, f"op {n} ({type(op).__name__}): not a stage op"
    close()
    return (stages, T1, T2, DF, tracked), None


def _composite_diffusion(stages, kvalue):
    """The per-stage D tables {btd, rdir, Dc} (``fisp_dispatch._dw_bvalue``
    conventions), None without D stages, or a string: why not."""
    d_list = [(i, s["d"]) for i, s in enumerate(stages) if s["d"] is not None]
    if not d_list:
        return None
    N = len(stages)
    btd, rdir = np.zeros(N), np.zeros(N)
    dc0, seen = None, set()
    for i, d in d_list:
        if not _no_diff(d) or not isinstance(d.tau, float):
            return f"stage {i}: D tracked or its tau not a host float"
        if _is_device(d.Dcoef) or getattr(d.Dcoef, "ndim", 0) != 0:
            return f"stage {i}: Dcoef not a host scalar"
        rd = 0.0
        if d.kshift is not None:
            ks = np.asarray(d.kshift)
            rd = float(ks.reshape(-1)[0]) if ks.shape == (1, 1) else None
            if rd not in (-1.0, 1.0) or rd != float(stages[i]["shift"]):
                return f"stage {i}: D ramp is not its stage's unit shift"
        if dc0 is None:
            dc0 = d.Dcoef
            seen.add(id(dc0))
        elif id(d.Dcoef) not in seen:
            if len(seen) >= 16 or not np.array_equal(
                    np.asarray(_host(dc0)), np.asarray(_host(d.Dcoef))):
                return f"stage {i}: D ops do not share one Dcoef"
            seen.add(id(d.Dcoef))
        btd[i] = d.tau * 1e-3 * (float(kvalue) * 1e-3) ** 2
        rdir[i] = rd
    return {"btd": btd, "rdir": rdir, "Dc": float(np.asarray(_host(dc0)))}


def _match_composite_impl(sequence, kvalue=1.0):
    """(params, None) for a composite stage train, else (None, reason)."""
    folded, reason = _fold_stages(sequence)
    if folded is None:
        return None, reason
    stages, T1, T2, DF, tracked = folded
    N = len(stages)
    nadc = sum(1 for s in stages if s["adc"])
    if N < 3 or N > 8192 or nadc < 1 or T1 is None:
        return None, (f"{N} stages, {nadc} readouts: needs 3 to 8192 stages, "
                      f"a readout and an E op")

    # rank-1 flip factorization; scalar-flip stages (adiabatic preps)
    # bypass the per-atom B1 scale (b1u = 0)
    FA, b1u = np.zeros(N), np.ones(N)
    vec = [i for i, s in enumerate(stages) if s["fa"].size > 1]
    if vec:
        fab = _rank1_factor([stages[i]["fa"] for i in vec])
        if fab is None:
            return None, "vector flips are not rank-1 outer(FA, B1)"
        FAv, B1 = fab
        FA[vec] = FAv
        for i, s in enumerate(stages):
            if s["fa"].size == 1:
                FA[i] = float(s["fa"].reshape(-1)[0])
                b1u[i] = 0.0
        if np.all(B1 == 1.0):
            b1u[:] = 1.0
    else:
        B1 = np.ones(1)
        for i, s in enumerate(stages):
            FA[i] = float(s["fa"].reshape(-1)[0])

    # B1 tracking: the kernel's dB1 group sums d(a)/dB1 = FA_i over the
    # B1-sensitive stages; the tracked set must be exactly those
    b1_coeffs = [s["b1c"] for s in stages]
    b1_scale = None
    if any(c != () for c in b1_coeffs):
        sens = [b1u[i] != 0.0 and abs(FA[i]) > 1e-12 for i in range(N)]
        b1_scale = _b1_scale_from_coeffs(FA, b1_coeffs, sens)
        if b1_scale is None:
            return None, ("B1 tracking is not one ratio of FA over exactly "
                          "the B1-sensitive stages")

    adci = np.full(N, -1, np.int64)
    aph, shift = np.zeros(N), np.zeros(N, np.int64)
    j = 0
    for i, s in enumerate(stages):
        if s["adc"]:
            adci[i] = j
            j += 1
            aph[i] = s["aph"] * np.pi / 180.0
        shift[i] = s["shift"]

    diffusion = _composite_diffusion(stages, kvalue)
    if isinstance(diffusion, str):
        return None, diffusion
    if not common.broadcastable(T1.shape, T2.shape, B1.shape, DF.shape):
        return None, "T1, T2, B1 and g batch shapes do not broadcast"
    bshape = common.broadcast_shapes(T1.shape, T2.shape, B1.shape, DF.shape)
    T1f, T2f, B1f, DFf = _append_rows((T1, T2, B1, DF), bshape)
    return {
        "FA": FA, "phi": np.asarray([s["phi"] for s in stages]),
        "ta": np.asarray([s["ta"] for s in stages]),
        "tb": np.asarray([s["tb"] for s in stages]),
        "adci": adci, "shift": shift, "aph": aph, "b1u": b1u,
        "T1": T1f, "T2": T2f, "B1": B1f, "df": DFf if DFf.any() else None,
        "nadc": int(nadc), "shape": bshape,
        "vars": (tracked or ()) if b1_scale is None
        else tuple(sorted((tracked or ()) + ("B1",))),
        "b1_scale": b1_scale, "diffusion": diffusion,
    }, None


def _comp_device_params(params, device=None, dtype=None):
    """The composite kernels' tensors of a match dict, cached on it (like
    :func:`device_params`): the stage tables (FA, phi, ta, tb, aph, b1u,
    btd, rdir in the working precision, adci and shift int32) and the
    atoms (T1, T2, B1, df or None, Dc (B,) or None)."""
    def build(device, dtype):
        def vec(k, src=params, dt=dtype):
            return torch.as_tensor(np.array(src[k], np.float64), dtype=dt,
                                   device=device)

        dev = {k: vec(k) for k in ("FA", "phi", "ta", "tb", "aph", "b1u",
                                   "T1", "T2", "B1")}
        dev["adci"] = vec("adci", dt=torch.int32)
        dev["shift"] = vec("shift", dt=torch.int32)
        dev["df"] = None if params.get("df") is None else vec("df")
        diff = params.get("diffusion")
        if diff is None:
            dev["diffusion"] = None
        else:
            dev["diffusion"] = (vec("btd", diff), vec("rdir", diff),
                                torch.full_like(dev["T1"], float(diff["Dc"])))
        return dev

    return _cached_device(params, device, build,
                          config.real_dtype() if dtype is None else dtype)


def _comp_call(params, nstate):
    """Positional tensors and keywords of the composite kernels for a
    match dict: a shifting train runs at nstate >= 1 (``:3212-3214``), the
    static flags come from the host tables."""
    d = _comp_device_params(params)
    shift = np.asarray(params["shift"])
    up, down = bool((shift == 1).any()), bool((shift == -1).any())
    ns = int(nstate)
    if (up or down) and ns < 1:
        ns = 1
    args = tuple(d[k] for k in ("FA", "phi", "ta", "tb", "adci", "shift",
                                "aph", "b1u", "T1", "T2", "B1", "df"))
    kw = dict(nadc=int(params["nadc"]), nstate=ns,
              diffusion=d["diffusion"], has_up=up, has_down=down,
              has_adcph=bool(np.asarray(params["aph"]).any()),
              has_b1u=not bool(np.asarray(params["b1u"]).all()))
    return args, kw


def run_composite_kernel(params, nstate):
    """Run the composite kernel on a match dict (``:3205``); returns the
    echo train as a complex tensor in the engine's layout, (nadc, *batch):
    the kernel writes (nadc, B)."""
    args, kw = _comp_call(params, nstate)
    re, im = cuda_composite.composite_echoes(*args, **kw)
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))


def composite_jac_groups(specs):
    """The kernel's tangent groups the matched probe specs need, in the
    canonical order (T1, T2, B1, df) (``:3225``); dispatch specs name the
    df column "g", the E ops' parameter."""
    want = set()
    for spec in specs:
        if spec[0] == "jac":
            want.update(n for n in spec[1] if n != "magnitude")
    return tuple(g for g in cuda_composite.COMP_JAC_GROUPS
                 if ("g" if g == "df" else g) in want)


def run_composite_jacobian(params, nstate, specs):
    """Run the composite Jacobian kernel for matched diff probes
    (``:3270``) with only the tangent groups the probes need; the B1
    column is divided by the matcher's ``b1_scale``, and each name maps to
    its column in group order.  Returns a tuple over probes: signal (nadc,
    *batch), Jacobian (nadc, *batch, k)."""
    args, kw = _comp_call(params, nstate)
    groups = composite_jac_groups(specs)
    (re, im), (dre, dim) = cuda_composite.composite_jacobian_echoes(
        *args, groups=groups, **kw)
    inv = _b1_inv(params, re.dtype)
    cols = {("g" if g == "df" else g): (j, inv if g == "B1" else None)
            for j, g in enumerate(groups)}
    return _assemble_jac_outputs(re, im, dre, dim, specs,
                                 tuple(params["shape"]), cols)


# ---------------------------------------------------------------------------
# EPG-X GRE dispatch (``:2170-2504``): exchange / MT trains -> cuda_xgre
# ---------------------------------------------------------------------------


def match_xgre(sequence, shape, density=None):
    """Match EPG-X GRE trains (``epgpy_tpu/fisp_dispatch.py:2170``).

    Pattern (per TR, the same structure every TR):

        [ R(sat)? , T , X? , Adc , X? , S(1)? ]       (at least one X)

    The trailing S(1) is in EVERY block (spoiled GRE) or in NONE (the
    balanced family, bSSFP-MT: the kernel runs shiftless at nstate 0).
    ``T`` carries per-compartment flips on the leading (axis-0) compartment
    batch -- scalars per (TR, compartment), or a rank-1 ``outer(alpha_ic,
    B1)`` per-atom batch; the X stages are the SAME op instance every TR,
    with host scalar tau and a host (C, C) khi (T1/T2/g may be tensors:
    they pass through to the kernel); the saturation ``R`` has raw rates
    and no recovery.  `shape` is the engine's broadcast batch shape
    (compartments lead), `density` the simulate() option: a real host
    vector each stage's kinetic matrix conserves.  Returns the JAX
    matcher's dict (alpha, phi, B1, satf_re/im, satz_re/im, dens, khiA/B,
    T1A/B, T2A/B, gA/B, tauA/B, shape, C, balanced) or None, logging the
    reason at INFO; memoized on the operator identities, shape and
    density."""
    if len(sequence) < 8:
        params, reason = None, f"{len(sequence)} ops: fewer than 8"
    else:
        dkey = _density_key(density)
        if dkey is False:
            params, reason = None, "density is not a host vector"
        else:
            key = ("xgre", tuple(shape), dkey) + tuple(id(op)
                                                       for op in sequence)
            params, reason = _memoized(
                key, sequence,
                lambda: _match_xgre_impl(sequence, tuple(shape), density))
    if params is None:
        LOGGER.info("match_xgre: not an EPG-X GRE train: %s", reason)
    return params


def _density_key(density):
    """The memo key of a density option: None, a tuple of its values, or
    False when it is not a host vector."""
    if density is None:
        return None
    if _is_device(density):
        return False
    try:
        return tuple(np.ravel(np.asarray(_host(density))).tolist())
    except (TypeError, ValueError):
        return False


def _comp_vec(x, C):
    """Host per-compartment (C,) float vector from a scalar, (C,) or
    (C, 1, ...) value (the compartment axis leads), else None."""
    v = _host_nd(x)
    if v is None or any(d != 1 for d in v.shape[1:]):
        return None
    v = v.reshape(-1)
    if v.shape[0] == 1:
        return np.full((C,), v[0])
    return v if v.shape[0] == C else None


def _comp_cvec(x, C):
    """Host complex (C,) vector of an R op's rate (None = 0), else
    None."""
    if x is None:
        return np.zeros(C, complex)
    if _is_device(x):
        return None
    try:
        v = np.atleast_1d(np.asarray(_host(x), dtype=complex))
    except (TypeError, ValueError):
        return None
    if any(d != 1 for d in v.shape[1:]):
        return None
    v = v.reshape(-1)
    if v.shape[0] == 1:
        return np.full((C,), v[0])
    return v if v.shape[0] == C else None


def _xgre_stage_ok(x, C):
    """One X stage op the kernels take: compartments on axis 0, no
    derivative specs, a host scalar tau, a (C, C) khi, T1/T2/g (host or
    tensors without grad) with a leading axis of 1 or C."""
    if getattr(x, "axis", None) != 0 or not _no_diff(x):
        return False
    if _scalar(x.tau) is None or tuple(np.shape(x.khi)) != (C, C):
        return False
    for leaf in (x.T1, x.T2, x.g):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor) and leaf.requires_grad:
            return False
        s = tuple(np.shape(leaf))
        if s and s[0] not in (1, C):
            return False
    return True


def _x_density(density, C, khis):
    """(dens, None): the (C,) host densities (ones without the option) if
    every kinetic matrix of `khis` conserves them, else (None, reason)."""
    if density is None:
        dens = np.ones(C)
    else:
        d = np.asarray(_host(density))
        if np.iscomplexobj(d):
            if not np.allclose(d.imag, 0):
                return None, "complex density"
            d = d.real
        dens = _comp_vec(d.astype(float), C)
        if dens is None:
            return None, f"density is not a ({C},) vector"
    for khi in khis:
        if not np.allclose(khi @ dens, 0, atol=1e-8):
            return None, "a kinetic matrix does not conserve the density"
    return dens, None


def _sat_factors(sat, C):
    """(satf, satz): the F+ factor conj(e^{-rT}) and the Z factor
    e^{-rL} of a saturation R op (ones without one), or None."""
    if sat is None:
        return np.ones(C, complex), np.ones(C, complex)
    if not _no_diff(sat) or getattr(sat, "axes", None) is not None \
            or sat.r0 is not None:
        return None
    rT, rL = _comp_cvec(sat.rT, C), _comp_cvec(sat.rL, C)
    if rT is None or rL is None:
        return None
    return np.conj(np.exp(-rT)), np.exp(-rL)


def _comp_flips(op, C):
    """(alpha, phi) of a T op: alpha (C, *rest) host flips (a scalar or
    size-1 leading axis broadcasts over the compartments), phi a (C,)
    host vector; None if not so."""
    if not _no_diff(op) or getattr(op, "axes", None) is not None:
        return None
    a, p = _host_nd(op.alpha), _comp_vec(op.phi, C)
    if a is None or p is None:
        return None
    if a.ndim == 0 or a.size == 1:
        a = np.full((C,), float(a.reshape(-1)[0]))
    if a.shape[0] == 1:
        a = np.broadcast_to(a, (C,) + a.shape[1:])
    if a.shape[0] != C:
        return None
    return a, p


def _match_xgre_impl(sequence, shape, density):
    """(params, None) for an EPG-X GRE train, else (None, reason)."""
    from .ops.evolution import R
    from .ops.exchange import X
    from .ops.probe import Adc
    from .ops.shift import S
    from .ops.transition import T

    n = len(sequence)

    def parse_block(i):
        sat = x1 = x2 = s = None
        j = i
        if j < n and type(sequence[j]) is R:
            sat, j = sequence[j], j + 1
        if j >= n or type(sequence[j]) is not T:
            return None
        t, j = sequence[j], j + 1
        if j < n and type(sequence[j]) is X:
            x1, j = sequence[j], j + 1
        if j >= n or type(sequence[j]) is not Adc:
            return None
        adc, j = sequence[j], j + 1
        if j < n and type(sequence[j]) is X:
            x2, j = sequence[j], j + 1
        if j < n and type(sequence[j]) is S:
            s, j = sequence[j], j + 1
        return (sat, t, x1, adc, x2, s), j

    blocks, i = [], 0
    while i < n:
        blk = parse_block(i)
        if blk is None:
            return None, (f"op {i}: not a block [R?, T, X?, Adc, X?, "
                          f"S(1)?]")
        blocks.append(blk[0])
        i = blk[1]
    if len(blocks) < 2:
        return None, "fewer than 2 blocks"
    sat0, _, x1_0, _, x2_0, s0 = blocks[0]
    xop = x1_0 if x1_0 is not None else x2_0
    if xop is None:
        return None, "no X stage"
    for sat, _, x1, adc, x2, s in blocks:
        if ((sat is None) != (sat0 is None) or x1 is not x1_0
                or x2 is not x2_0 or (s is None) != (s0 is None)):
            return None, ("blocks differ in structure or in their X "
                          "instances")
        if not _plain_adc(adc) or adc.phase is not None or not _no_diff(adc):
            return None, "a readout is not a plain F0 Adc"
        if s is not None and (s._kint != 1 or not _no_diff(s)):
            return None, "a shift is not S(1)"
    C = int(np.shape(xop.khi)[-1])
    if len(shape) < 1 or shape[0] != C:
        return None, f"batch shape {shape} does not lead with {C} pools"
    for x in (x1_0, x2_0):
        if x is not None and not _xgre_stage_ok(x, C):
            return None, (f"{x.name}: not axis 0, tracked, or tau / khi / "
                          f"T1 / T2 / g not of the kernel's form")
    khis = {tag: (np.zeros((C, C)) if x is None
                  else np.asarray(x.khi, dtype=float))
            for tag, x in (("A", x1_0), ("B", x2_0))}
    dens, reason = _x_density(density, C, [khis[t] for t in "AB"
                                           if khis[t].any()])
    if dens is None:
        return None, reason

    ahs, phis, satf, satz = [], [], [], []
    for sat, t, _, _, _, _ in blocks:
        fl = _comp_flips(t, C)
        sf = _sat_factors(sat, C)
        if fl is None or sf is None:
            return None, (f"{t.name}: flips or phases not host values, or "
                          f"a saturation with recovery or tracking")
        ahs.append(fl[0])
        phis.append(fl[1])
        satf.append(sf[0])
        satz.append(sf[1])
    if all(all(d == 1 for d in a.shape[1:]) for a in ahs):
        alphas, B1 = np.stack([a.reshape(C) for a in ahs]), None
    else:
        fab = _rank1_factor([np.atleast_1d(a[c]) for a in ahs
                             for c in range(C)])
        if fab is None:
            return None, "per-atom flips are not rank-1 outer(alpha, B1)"
        coefs, B1 = fab
        alphas = coefs.reshape(len(ahs), C)
        if not common.broadcastable(B1.shape, tuple(shape[1:])):
            return None, "the B1 batch does not broadcast into the atoms"
    satf, satz = np.asarray(satf), np.asarray(satz)

    def leaf(x, name):
        return None if x is None else getattr(x, name)

    return {
        "alpha": alphas, "phi": np.asarray(phis), "B1": B1,
        "satf_re": satf.real, "satf_im": satf.imag,
        "satz_re": satz.real, "satz_im": satz.imag,
        "dens": dens, "khiA": khis["A"], "khiB": khis["B"],
        "T1A": leaf(x1_0, "T1"), "T2A": leaf(x1_0, "T2"),
        "gA": leaf(x1_0, "g"),
        "tauA": 0.0 if x1_0 is None else _scalar(x1_0.tau),
        "T1B": leaf(x2_0, "T1"), "T2B": leaf(x2_0, "T2"),
        "gB": leaf(x2_0, "g"),
        "tauB": 0.0 if x2_0 is None else _scalar(x2_0.tau),
        "shape": tuple(shape), "C": C, "balanced": s0 is None,
    }, None


def _comp_atoms(x, bshape, default, device, dtype):
    """(C, B) tensor of a per-compartment parameter: append-rule
    right-pad to the batch shape, broadcast, flatten the atoms."""
    x = default if x is None else x
    if isinstance(x, torch.Tensor):
        x = x.to(device=device, dtype=dtype)
    else:
        x = torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                            device=device)
    if x.ndim == 0:
        x = x.reshape(1)
    x = x.reshape(tuple(x.shape) + (1,) * (len(bshape) - x.ndim))
    return torch.broadcast_to(x, bshape).reshape(bshape[0],
                                                 -1).contiguous()


def _atom_b1(B1, bshape, device, dtype):
    """The (B,) flip scale of a rank-1 flip batch, or None."""
    if B1 is None:
        return None
    rest = tuple(bshape[1:])
    b1 = np.asarray(B1, dtype=np.float64)
    b1 = np.broadcast_to(b1.reshape(b1.shape + (1,) * (len(rest) - b1.ndim)),
                         rest).reshape(-1)
    return torch.as_tensor(np.array(b1), dtype=dtype,
                           device=device)


def _x_train(params, device, dtype):
    """The (N, C) per-TR tables of an EPG-X match dict as tensors."""
    return {k: torch.as_tensor(np.asarray(params[k], np.float64),
                               dtype=dtype, device=device).contiguous()
            for k in ("alpha", "phi", "satf_re", "satf_im", "satz_re",
                      "satz_im", "dens")}


def _xgre_device_params(params, device=None, dtype=None):
    """The xgre kernels' tensors of a match dict, cached on it: the train
    tables, the B1 row and the two stages (khi, T1, T2, g as (C, B), tau);
    an absent stage is the identity (khi = 0, tau = 0)."""
    def build(device, dtype):
        bshape = tuple(params["shape"])
        dev = _x_train(params, device, dtype)
        dev["B1"] = _atom_b1(params.get("B1"), bshape, device, dtype)
        for s in ("A", "B"):
            dev["stage" + s] = (
                params["khi" + s],
                _comp_atoms(params["T1" + s], bshape, np.inf, device, dtype),
                _comp_atoms(params["T2" + s], bshape, np.inf, device, dtype),
                _comp_atoms(params["g" + s], bshape, 0.0, device, dtype),
                float(params["tau" + s]))
        return dev

    return _cached_device(params, device, build,
                          config.real_dtype() if dtype is None else dtype)


def xgre_kernel_fits(params, nstate) -> bool:
    """Whether an xgre match's 6 C planes fit at 32 threads (a balanced
    train runs at nstate 0 and always does)."""
    ns = 0 if params["balanced"] else max(int(nstate), 1)
    return cuda_xgre.xgre_kernel_fits(ns, params["C"])


def run_xgre_kernel(params, nstate):
    """Run the EPG-X GRE kernel on a match dict (``:2491``); returns the
    echoes as a complex tensor in the engine's layout, (N, C, *rest)."""
    d = _xgre_device_params(params)
    balanced = bool(params["balanced"])
    re, im = cuda_xgre.xgre_dictionary_echoes(
        d["alpha"], d["phi"], d["satf_re"], d["satf_im"], d["satz_re"],
        d["satz_im"], d["dens"], d["stageA"], d["stageB"], d["B1"],
        nstate=0 if balanced else max(int(nstate), 1), shift=not balanced)
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))


# ---------------------------------------------------------------------------
# Composite EPG-X dispatch (``:2507-2884``): prepared stage trains ->
# cuda_xcomposite
# ---------------------------------------------------------------------------


def match_xcomposite(sequence, shape, density=None):
    """Match composite EPG-X stage trains (``:2507``):

        stage = [R(sat)?, T(alpha_c, phi_c)?, X(tau)*, Adc?, X(tau)*,
                 S(+-1)?]

    -- the prepared and segmented multi-compartment schedules
    :func:`match_xgre` rejects (MT-prepared GRE with saturation blocks and
    recovery delays, IR-MT, saturation-recovery MT).  Consecutive X ops
    accumulate their taus; every X carries the same khi/T1/T2/g (one
    generator, so X(t1) X(t2) = X(t1 + t2)), and the distinct accumulated
    taus (at most 16) become a stage-matrix table indexed per stage.  Flips
    are host per-compartment values, vector flips a rank-1 ``outer(alpha_c,
    B1)`` with scalar flips adiabatic (b1u = 0); saturation by raw-rate
    ``R`` ops without recovery; F0 readouts with an optional host ADC
    phase; shifts S(+-k), |k| <= 8.  Returns the JAX matcher's dict
    (alpha, B1, phi, satf_re/im, satz_re/im, adci, shift, aph, b1u, mia,
    mib, taus, dens, khi, T1, T2, g, nadc, shape, C, has_sat) or None,
    logging the reason; memoized like :func:`match_xgre`."""
    if len(sequence) < 6:
        params, reason = None, f"{len(sequence)} ops: fewer than 6"
    else:
        dkey = _density_key(density)
        if dkey is False:
            params, reason = None, "density is not a host vector"
        else:
            key = ("xcomp", tuple(shape), dkey) + tuple(id(op)
                                                        for op in sequence)
            params, reason = _memoized(
                key, sequence, lambda: _match_xcomposite_impl(
                    sequence, tuple(shape), density))
    if params is None:
        LOGGER.info("match_xcomposite: not a composite EPG-X train: %s",
                    reason)
    return params


def _x_generator(xops):
    """The first X op if every X op shares its generator (khi, T1, T2, g
    equal in value; at most 8 distinct leaf groups) and is a kernel stage,
    else None."""
    x0 = xops[0]
    if not _xgre_stage_ok(x0, int(np.shape(x0.khi)[-1])):
        return None
    groups = {}
    for x in xops:
        if not _no_diff(x) or _scalar(x.tau) is None:
            return None
        groups.setdefault((id(x.khi), id(x.T1), id(x.T2), id(x.g)), x)
    if len(groups) > 8:
        return None
    for x in list(groups.values())[1:]:
        for a, b in ((x.khi, x0.khi), (x.T1, x0.T1), (x.T2, x0.T2),
                     (x.g, x0.g)):
            if (a is None) != (b is None):
                return None
            if a is not None and a is not b and (
                    _is_device(a) or _is_device(b)
                    or not np.array_equal(np.asarray(_host(a)),
                                          np.asarray(_host(b)))):
                return None
    return x0


def _fold_xstages(sequence, C):
    """The composite EPG-X stages of an op list, or (None, reason)."""
    from .ops import base as _base
    from .ops.evolution import R
    from .ops.exchange import X
    from .ops.probe import Adc, Probe
    from .ops.shift import S
    from .ops.transition import T

    stages, cur, have_pulse = [], None, False

    def new_stage():
        return {"sat": None, "alpha": np.zeros(C), "phi": np.zeros(C),
                "ta": 0.0, "tb": 0.0, "adc": False, "aph": 0.0, "shift": 0}

    def close():
        nonlocal cur
        if cur is not None:
            stages.append(cur)
            cur = None

    for n, op in enumerate(sequence):
        if type(op) is R:
            close()
            cur, have_pulse = new_stage(), False
            cur["sat"] = op
        elif type(op) is T:
            fl = _comp_flips(op, C)
            if fl is None:
                return None, (f"op {n} ({op.name}): flips or phases not host "
                              f"per-compartment values, or tracked")
            if cur is None or have_pulse or cur["ta"] or cur["tb"] \
                    or cur["adc"] or cur["shift"]:
                close()
                cur = new_stage()
            cur["alpha"], cur["phi"], have_pulse = fl[0], fl[1], True
        elif type(op) is X:
            tau = _scalar(op.tau)
            if tau < 0:
                return None, f"op {n}: negative tau"
            if cur is None or cur["shift"]:
                close()
                cur, have_pulse = new_stage(), False
            cur["tb" if cur["adc"] else "ta"] += tau
        elif type(op) is Adc:
            ph = None if op.phase is None else _scalar(op.phase)
            if not _plain_adc(op) or (op.phase is not None and ph is None) \
                    or not _no_diff(op):
                return None, f"op {n}: not a plain F0 readout"
            if cur is None or cur["adc"] or cur["shift"]:
                close()
                cur, have_pulse = new_stage(), False
            cur["adc"] = True
            cur["aph"] = 0.0 if ph is None else float(ph) * np.pi / 180.0
        elif type(op) is S:
            k = op._kint
            if k is None or not _no_diff(op) or abs(k) > 8:
                return None, f"op {n}: shift tracked or beyond +-8"
            if cur is None:
                cur, have_pulse = new_stage(), False
            for _ in range(abs(k)):
                if cur["shift"]:
                    close()
                    cur, have_pulse = new_stage(), False
                cur["shift"] = 1 if k > 0 else -1
        elif isinstance(op, Probe):
            return None, f"op {n}: a probe other than Adc"
        elif not isinstance(op, _base.EmptyOperator):
            return None, f"op {n} ({type(op).__name__}): not a stage op"
    close()
    return stages, None


def _match_xcomposite_impl(sequence, shape, density):
    """(params, None) for a composite EPG-X train, else (None, reason)."""
    from .ops.exchange import X

    xops = [op for op in sequence if type(op) is X]
    if not xops:
        return None, "no X op"
    if len({id(x) for x in xops}) > 64:
        return None, "more than 64 distinct X instances"
    x0 = _x_generator(xops)
    if x0 is None:
        return None, ("the X ops do not share one kernel-form generator "
                      "(khi, T1, T2, g), or one is tracked")
    C = int(np.shape(x0.khi)[-1])
    if len(shape) < 1 or shape[0] != C:
        return None, f"batch shape {shape} does not lead with {C} pools"
    stages, reason = _fold_xstages(sequence, C)
    if stages is None:
        return None, reason
    N = len(stages)
    nadc = sum(1 for s in stages if s["adc"])
    if N < 2 or nadc < 1 or N > 8192:
        return None, (f"{N} stages, {nadc} readouts: needs 2 to 8192 stages "
                      f"and a readout")
    khi = np.asarray(x0.khi, dtype=float)
    dens, reason = _x_density(density, C, [khi])
    if dens is None:
        return None, reason

    satf, satz = np.ones((N, C), complex), np.ones((N, C), complex)
    for i, s in enumerate(stages):
        sf = _sat_factors(s["sat"], C)
        if sf is None:
            return None, f"stage {i}: saturation with recovery or tracking"
        satf[i], satz[i] = sf

    taus, mia, mib = [0.0], np.zeros(N, np.int64), np.zeros(N, np.int64)

    def tau_idx(t):
        if t not in taus:
            taus.append(t)
        return taus.index(t)

    for i, s in enumerate(stages):
        mia[i], mib[i] = tau_idx(float(s["ta"])), tau_idx(float(s["tb"]))
    if len(taus) > 16:
        return None, f"{len(taus)} distinct taus: more than 16"

    adci, aph = np.full(N, -1, np.int64), np.zeros(N)
    shift = np.asarray([s["shift"] for s in stages], np.int64)
    j = 0
    for i, s in enumerate(stages):
        if s["adc"]:
            adci[i], aph[i] = j, s["aph"]
            j += 1

    # rank-1 factorization over the vector (stage, compartment) flips only:
    # scalar-flip stages (adiabatic preps) bypass B1 (b1u = 0)
    ahs, b1u = [s["alpha"] for s in stages], np.ones(N)
    vec = [i for i, a in enumerate(ahs)
           if not all(d == 1 for d in a.shape[1:])]
    if not vec:
        alphas = np.stack([np.asarray(a).reshape(C) for a in ahs])
        B1 = None
    else:
        fab = _rank1_factor([np.atleast_1d(ahs[i][c]) for i in vec
                             for c in range(C)])
        if fab is None:
            return None, "vector flips are not rank-1 outer(alpha, B1)"
        coefs, B1 = fab
        alphas, vset, k = np.zeros((N, C)), set(vec), 0
        for i in range(N):
            if i in vset:
                alphas[i] = coefs[k:k + C]
                k += C
            else:
                alphas[i] = np.asarray(ahs[i]).reshape(C)
                b1u[i] = 0.0
        if np.all(B1 == 1.0):
            b1u[:] = 1.0
        if not common.broadcastable(B1.shape, tuple(shape[1:])):
            return None, "the B1 batch does not broadcast into the atoms"

    return {
        "alpha": alphas, "B1": B1,
        "phi": np.stack([s["phi"] for s in stages]),
        "satf_re": satf.real, "satf_im": satf.imag,
        "satz_re": satz.real, "satz_im": satz.imag,
        "adci": adci, "shift": shift, "aph": aph, "b1u": b1u,
        "mia": mia, "mib": mib, "taus": np.asarray(taus),
        "dens": dens, "khi": khi, "T1": x0.T1, "T2": x0.T2, "g": x0.g,
        "nadc": int(nadc), "shape": tuple(shape), "C": C,
        "has_sat": bool(np.any(satf != 1.0) or np.any(satz != 1.0)),
    }, None


def _xcomp_device_params(params, device=None, dtype=None):
    """The composite EPG-X kernels' tensors of a match dict, cached on it:
    the (N, C) train, the per-stage tables (adci, shift, mia, mib int32;
    aph, b1u), the atoms' T1, T2, g as (C, B) and the B1 row."""
    def build(device, dtype):
        bshape = tuple(params["shape"])
        dev = _x_train(params, device, dtype)
        for k in ("adci", "shift", "mia", "mib"):
            dev[k] = torch.as_tensor(np.asarray(params[k]), dtype=torch.int32,
                                     device=device)
        for k in ("aph", "b1u"):
            dev[k] = torch.as_tensor(np.asarray(params[k], np.float64),
                                     dtype=dtype, device=device)
        dev["T1"] = _comp_atoms(params["T1"], bshape, np.inf, device, dtype)
        dev["T2"] = _comp_atoms(params["T2"], bshape, np.inf, device, dtype)
        dev["g"] = _comp_atoms(params["g"], bshape, 0.0, device, dtype)
        dev["B1"] = _atom_b1(params.get("B1"), bshape, device, dtype)
        return dev

    return _cached_device(params, device, build,
                          config.real_dtype() if dtype is None else dtype)


def _xcomp_nstate(params, nstate):
    shift = np.asarray(params["shift"])
    moves = bool((shift != 0).any())
    return max(int(nstate), 1) if moves else int(nstate)


def xcomposite_kernel_fits(params, nstate) -> bool:
    """Whether a composite EPG-X match's 6 C planes fit at 32 threads."""
    return cuda_xgre.xgre_kernel_fits(_xcomp_nstate(params, nstate),
                                      params["C"])


def _xcomp_call(params, nstate):
    """Positional tensors and keywords of the composite EPG-X kernels for
    a match dict (``:2867``)."""
    d = _xcomp_device_params(params)
    shift = np.asarray(params["shift"])
    args = tuple(d[k] for k in ("alpha", "phi", "satf_re", "satf_im",
                                "satz_re", "satz_im", "adci", "shift", "aph",
                                "mia", "mib", "dens"))
    kw = dict(nadc=int(params["nadc"]), nstate=_xcomp_nstate(params, nstate),
              has_up=bool((shift == 1).any()),
              has_down=bool((shift == -1).any()),
              has_adcph=bool(np.asarray(params["aph"]).any()),
              has_sat=bool(params["has_sat"]),
              has_b1u=not bool(np.asarray(params["b1u"]).all()))
    return args, d, kw


def run_xcomposite_kernel(params, nstate):
    """Run the composite EPG-X kernel on a match dict; returns the echoes
    as a complex tensor in the engine's layout, (nadc, C, *rest)."""
    args, d, kw = _xcomp_call(params, nstate)
    re, im = cuda_xcomposite.xcomposite_echoes(
        *args, params["taus"], params["khi"], d["T1"], d["T2"], d["g"],
        d["B1"], d["b1u"], **kw)
    return torch.complex(re, im).reshape((re.shape[0],)
                                         + tuple(params["shape"]))
