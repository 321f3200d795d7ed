"""Simulation engine: run an operator sequence, return the probe values.

Counterpart of ``epgpy_tpu/engine.py`` (:47-125, :153-159, :362-1277).
``simulate()`` has two routes:

* **the kernel dispatch**: a family table (JAX ``engine.py:874-940``)
  tries FISP, CPMG, bSSFP, DESS, ME-GRE, DW-FISP, EPG-X GRE, composite
  EPG-X, then composite GRE; the first match wins.  An exact FISP train
  (fisp_dispatch.match_fisp) runs
  as one fused CUDA kernel (models/cuda_fisp.py), a CPMG / multi-spin-echo
  train, DW-TSE included (fisp_dispatch.match_mse), as the CPMG kernel
  (models/cuda_mse.py), a balanced SSFP train (match_bssfp) as the k = 0
  bSSFP kernel (models/cuda_bssfp.py), a DESS train (match_dess) as the
  two-echo DESS kernel (models/cuda_dess.py), a multi-echo GRE train
  (match_megre) as the ME-GRE kernel (models/cuda_megre.py), a DW-FISP
  train (match_dwfisp) as the FISP kernel with its diffusion
  attenuation, and any other stage train ``[T?, E*, Adc?, E*, S(+-k)?,
  D?]`` -- MPRAGE, prepared cardiac MRF, saturation recovery
  (match_composite) -- as the composite kernel (models/cuda_composite.py).
  With the ``density`` option only the EPG-X families take part: an
  exchange / MT gradient-echo train over C compartments, spoiled or
  balanced (match_xgre), runs as the EPG-X kernel (models/cuda_xgre.py),
  a prepared multi-compartment stage train (match_xcomposite) as the
  composite EPG-X kernel (models/cuda_xcomposite.py).
  They engage only without ``probe``, and
  so do their Jacobian probes
  (``probe=[ADC, Jacobian([...])]`` on a train whose E ops track
  ``order1=["T1", "T2"]`` and whose T ops may track B1): the fused
  primal+tangent kernel of the family; per-pulse trains (T ops tracking
  alpha aliases, E ops T1/T2 and tau aliases) with Jacobian/Hessian
  probes run as one launch of the per-pulse Hessian kernel
  (models/cuda_hessian.py), the flagship (magnitude, T1, T2) x (alphas +
  taus) Hessian and the CRLB design's workload.  ``fisp_kernel="auto"``
  engages them when the working device is CUDA and the precision float32
  (the kernels compute in float32); ``"force"`` engages them anywhere,
  running the kernels' plain twins for the CPU; ``False`` opts out.
  Whenever a call does not take a kernel, one INFO line says why (device,
  precision, off-pattern op or probe, shared-memory gate);
* **the general path**: the JAX package's scan planner
  (``_build_plan``, ``_stack_block``, ``_plan_and_payload``,
  ``_execute_plan``): the flat op list becomes unrolled runs and
  periodic blocks whose slots are applied as they are, precomputed
  (E/P/R coefficients, X mixing matrices) or stacked over the
  repetitions, every payload tensor on the working device.  On CUDA a
  memoized call replays the planned program as one CUDA graph captured
  on first use (``_replay``; the counterpart of ``_run_compiled``); a
  plan with host work between ops (a callback, ``disp``, a callable
  probe) runs eagerly, as every plan does on the CPU.  Jacobian and
  Hessian probes that no kernel family takes run through the same
  planner (diff.simulate_diff, JAX ``engine.py:1137-1156``): the tracked
  train substituted with a value-signature memo and planned, tangents as
  planes on a batch axis of the state, each tracked slot's coefficient
  derivatives computed once per chunk, the program cached across calls
  and captured as one CUDA graph per stage on the card.

The ladder capacity is fixed up front from the sequence's total shift
count, capped by ``max_nstate`` (``nstate`` is a floor); a train of float
or vector shifts gets a coordinate table of ``2 * ncap + 1`` rows instead,
``ncap`` from the lattice bound of its shifts in ``kgrid`` cells
(``_capacity``), attached before the first op (``_setup_table``) with the
merge engine the train allows: the dense rows-are-cells merges where the
capacity covers the whole range (``_dense_bound``,
``_dense_varying_bound``), else the sort merge (``ops/shiftnd.py``).  The
host analysis is memoized per operator list (``_sequence_preamble``),
plans and their graphs in ``_PLAN_CACHE``, with the planned diff
programs (``clear_caches`` drops all).
``kvalue`` (rad/m per ladder index or table unit) scales the wavenumbers
the diffusion operator and the imaging probes read.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from . import common, config
from .ops import base, probe as probe_mod
from .statematrix import StateMatrix

LOGGER = logging.getLogger(__name__)

__all__ = ["simulate", "simulate_simple", "modify", "default_modifier",
           "flatten_sequence", "squeeze_sequence", "getshape", "getnshift",
           "getkdim", "get_adc_times", "clear_caches"]


# -- sequence introspection (host-side) --


def flatten_sequence(seq, flatten_multi: bool = True) -> List[base.Operator]:
    """Flatten nested lists / MultiOperators into a flat operator list."""
    seq = [seq] if isinstance(seq, base.Operator) else seq
    out = []
    for item in seq:
        if isinstance(item, (list, tuple)):
            out.extend(flatten_sequence(item, flatten_multi))
        elif flatten_multi and isinstance(item, base.MultiOperator):
            out.extend(flatten_sequence(item.operators, flatten_multi))
        elif isinstance(item, base.Operator):
            out.append(item)
        else:
            raise ValueError(f"Invalid operator: {item!r}")
    return out


def getshape(sequence) -> tuple:
    """Broadcast batch shape of the whole sequence (append rule)."""
    return common.broadcast_shapes(*[op.shape
                                     for op in flatten_sequence(sequence)])


def getnshift(sequence) -> int:
    """Total ladder growth over the sequence."""
    return sum(op.nshift for op in flatten_sequence(sequence))


def get_adc_times(sequence):
    """ADC opening times from operator durations (host-side metadata)."""
    tic, times = 0, []
    for op in flatten_sequence(sequence):
        tic = tic + np.asarray(op.duration)
        if isinstance(op, probe_mod.Probe):
            times.append(tic)
    return times


#: per-sequence preamble memo (JAX ``engine.py:293-338``): keyed on the
#: operator identities, ``max_nstate``, ``kgrid``, ``kvalue`` and
#: ``tvalue``; each entry pins its operator list so ids cannot be reused
#: while cached, oldest evicted first
_PREAMBLE_CACHE: dict = {}
_PREAMBLE_CACHE_MAX = 32


def clear_caches():
    """Drop the per-sequence preamble memo, the plan cache (with its CUDA
    graphs) and the dispatch's match memo (needed after mutating an
    operator's arrays in place, or after monkeypatching the capacity and
    dense-grid gates)."""
    from . import fisp_dispatch

    _PREAMBLE_CACHE.clear()
    _PLAN_CACHE.clear()
    fisp_dispatch.clear_cache()


def _host_key(value):
    """A memo key for kvalue / tvalue: host numbers by value, a tensor by
    identity (no device read)."""
    if isinstance(value, torch.Tensor):
        return ("id", id(value))
    if common.get_shape(value):
        return tuple(np.ravel(np.asarray(value, dtype=float)))
    return float(value)


def _sequence_preamble(sequence, max_nstate, kvalue, kgrid=None,
                       tvalue=1.0):
    """Cached host analysis of a flat operator list: (nshift, shape,
    ncap, dense, varying) -- the shift count, the batch shape, the ladder
    capacity (:func:`_capacity`), the shared dense-grid bound
    (:func:`_dense_bound`) and the batch-varying one
    (:func:`_dense_varying_bound`).  Repeat simulate() calls on one train
    (dictionary services, Gauss-Newton loops) skip the O(n_ops) sweeps."""
    key = (max_nstate, kgrid, _host_key(kvalue), _host_key(tvalue)) \
        + tuple(id(op) for op in sequence)

    def compute():
        nshift = getnshift(sequence)
        dense = _dense_bound(sequence, kgrid, max_nstate, kvalue)
        varying = (None if dense is not None else _dense_varying_bound(
            sequence, kgrid, max_nstate, kvalue))
        return (nshift, getshape(sequence),
                _capacity(sequence, nshift, max_nstate, kgrid, kvalue,
                          tvalue), dense, varying)

    return common.memoize_on_ops(_PREAMBLE_CACHE, _PREAMBLE_CACHE_MAX, key,
                                 sequence, compute)


#: default half-capacity of a coordinate table (the reference grows its
#: tables; a table of fixed shape needs a default cap)
DEFAULT_TABLE_NSTATE = 255
#: the dense-grid merge's bound on the ladder half-capacity (its rows must
#: cover the train's whole wavenumber range)
_DENSE_MAX_NSTATE = 8192


def _shift_ops(sequence):
    from .ops.shift import S

    return [op for op in sequence if isinstance(op, S)]


def _is_table(shift_ops) -> bool:
    """Whether a train's shifts need the coordinate table (a float or a
    vector shift)."""
    return any(op._kint is None for op in shift_ops)


def _capacity(sequence, nshift: int, max_nstate, kgrid=None, kvalue=1.0,
              tvalue=1.0) -> int:
    """Static ladder half-capacity (JAX ``engine._capacity``).

    1-D integer trains are exact with ``nshift``, capped at
    ``max_nstate``.  A coordinate table can fill at most the lattice box
    ``prod_d (2 sum|k_d| + 1)`` -- counted in grid cells of the physical
    wavenumbers ``|k| * kvalue / kgrid`` when the shifts are floats -- or
    ``3^m`` splitting paths if fewer, capped at ``max_nstate`` or
    :data:`DEFAULT_TABLE_NSTATE` (a warning when the cap trims)."""
    shift_ops = _shift_ops(sequence)
    if not _is_table(shift_ops):
        return min(int(nshift), int(max_nstate)) if max_nstate \
            else int(nshift)
    kdim = max(op.kdim for op in shift_ops)
    sums = np.zeros(kdim)
    any_float = False
    for op in shift_ops:
        if op._kint is not None:
            sums[0] += abs(op._kint)
            continue
        karr = np.asarray(op.kleaf, dtype=float)
        any_float = any_float or not op._int_table
        sums[:karr.shape[-1]] += np.max(np.abs(
            karr.reshape(-1, karr.shape[-1])), axis=0)
    if any_float and kgrid:
        # per-axis physical scale [kvalue (<= 3 axes), tvalue (time)];
        # device scales have no host value: 1
        kvalue = None if isinstance(kvalue, torch.Tensor) else kvalue
        tvalue = None if isinstance(tvalue, torch.Tensor) else tvalue
        if kvalue is not None and common.get_shape(kvalue):
            kscales = np.abs(np.asarray(kvalue, dtype=float).ravel())[:3]
        else:
            kscales = np.full(min(kdim, 3), abs(
                1.0 if kvalue is None else float(kvalue)))
        scales = np.ones(kdim)
        scales[:len(kscales)] = kscales[:kdim]
        if kdim == 4:
            scales[3] = abs(float(tvalue)) if tvalue is not None else 1.0
        sums = sums * scales / float(kgrid)
    box = int(np.prod(np.minimum(2 * np.ceil(sums) + 1, 2 ** 20)))
    paths = 3 ** min(len(shift_ops), 16)
    bound = (min(box, paths) - 1) // 2 + 1
    cap = int(max_nstate) if max_nstate else DEFAULT_TABLE_NSTATE
    if bound > cap:
        LOGGER.warning(
            "State-table capacity %d is below the sequence's lattice bound "
            "%d: magnitude-ranked truncation pruning is active and results "
            "may lose accuracy (raise max_nstate to silence).", cap, bound)
    return max(min(bound, cap), 1)


def _dense_analysis(sequence, kgrid, max_nstate, kvalue):
    """The dense engines' eligibility sweep (JAX
    ``engine._dense_analysis``): every shift 1-D with host values, some
    of them floats, a scalar host kvalue, no System op that may change
    kvalue mid-train, and a ladder covering the train's whole range
    ``sum|k| kvalue / kgrid`` within the cap (so no trim can happen).
    Returns (bound, window, any_varying), else None."""
    from .ops.base import System

    if not kgrid or common.get_shape(kvalue) or isinstance(kvalue,
                                                           torch.Tensor):
        return None
    shift_ops = _shift_ops(sequence)
    if not shift_ops:
        return None
    if any(getattr(op, "scalars", None) for op in sequence
           if isinstance(op, System)):
        return None
    total = step_max = 0.0
    any_float = any_varying = False
    for op in shift_ops:
        if op._kint is not None:
            total += abs(op._kint)
            step_max = max(step_max, abs(op._kint))
            continue
        karr = np.atleast_2d(np.asarray(op.kleaf))
        if karr.shape[-1] != 1:
            return None
        any_varying = any_varying or int(np.prod(op.shape)) > 1
        any_float = any_float or not op._int_table
        m = float(np.max(np.abs(karr)))
        total += m
        step_max = max(step_max, m)
    if not any_float:
        return None
    kv = abs(float(kvalue))
    bound = int(np.floor(total * kv / float(kgrid) + 0.5)) + 1
    window = int(np.ceil(step_max * kv / float(kgrid))) + 1
    cap = int(max_nstate) if max_nstate else DEFAULT_TABLE_NSTATE
    if bound > cap or bound > _DENSE_MAX_NSTATE:
        return None
    return bound, window, any_varying


def _dense_bound(sequence, kgrid, max_nstate, kvalue):
    """Half-capacity of the shared dense 1-D merge, or None (a module
    function, so tests can force the gate off)."""
    a = _dense_analysis(sequence, kgrid, max_nstate, kvalue)
    return None if a is None or a[2] else a[0]


def _dense_varying_bound(sequence, kgrid, max_nstate, kvalue):
    """(half-capacity, shift half-window) of the batch-varying dense
    merge, or None (a module function, so tests can force it off)."""
    a = _dense_analysis(sequence, kgrid, max_nstate, kvalue)
    return None if a is None or not a[2] else (a[0], a[1])


def _center_only_init(sm) -> bool:
    """True if the initial states are confined to the k = 0 row (reads
    the device ladder once)."""
    if sm.coords is not None:
        return False
    off = sm.states.clone()
    off[..., sm.nstate, :] = 0
    return not bool(off.any())


def _setup_table(sm, sequence, shape=None, dense=False,
                 varying_window=None):
    """Attach the coordinate table up front for a table train (JAX
    ``engine._setup_table``), so that the table -- the carried state of a
    CUDA graph -- has one shape and dtype from the first op on: a float
    table, which an all-integer train quantizes on the unit grid
    (``_int_grid``: the merge's output is a float mean, as in JAX, whose
    table shifts always take this route); the dense engines' options;
    with a batch-varying shift, the table expanded to the full batch shape
    (each atom's own)."""
    shift_ops = _shift_ops(sequence)
    if not _is_table(shift_ops) or sm.coords is not None:
        return sm
    sm = sm.setup_coords(max(op.kdim for op in shift_ops))
    all_int = all(op._int_table for op in shift_ops)
    opts = dict(sm.options)
    if all_int:
        opts["_int_grid"] = True
    if dense and not all_int:
        opts["_dense_grid"] = True
        LOGGER.info("table merges: dense-grid engine (rows are cells)")
    elif varying_window and not all_int:
        opts["_dense_grid_varying"] = int(varying_window)
        LOGGER.info("table merges: batch-varying dense engine (window=%d)",
                    int(varying_window))
    elif not all_int:
        LOGGER.info("table merges: general table engine (sort)")
    sm = sm.update(options=opts)
    if any(int(np.prod(op.shape)) > 1 for op in shift_ops) \
            and shape is not None:
        coords = sm.coords
        bshape = common.broadcast_shapes(sm.shape, tuple(shape))
        pad = len(bshape) - (coords.ndim - 2)
        if pad > 0:
            coords = coords.reshape(coords.shape[:-2] + (1,) * pad
                                    + coords.shape[-2:])
        target = common.broadcast_shapes(tuple(coords.shape[:-2]), bshape)
        sm = sm.update(coords=coords.expand(target + coords.shape[-2:]))
    return sm


def _table_state(sm, sequence, shape, dense, varying, center_only):
    """The state a table train starts from: the dense engines only where
    the initial states sit on k = 0, were checked symmetric and every op
    keeps the ladder symmetry (their windows assume exactly
    antisymmetric mean wavenumbers); then :func:`_setup_table`."""
    if (dense is not None or varying is not None) and not (
            center_only and sm.options.get("_sym_verified", False)
            and all(getattr(op, "preserves_ladder_symmetry", True)
                    for op in sequence)):
        dense = varying = None
    return _setup_table(sm, sequence, shape, dense=dense is not None,
                        varying_window=None if varying is None
                        else varying[1])


def simulate_simple(sm, sequence, probes=None, callback=None, disp=False,
                    max_nstate=None):
    """Plain eager sequence loop (reference functions.py:173-192).

    Applies each operator to `sm` and acquires `probes` (or the
    sequence's own probe ops) at every Probe.  Returns ``(values,
    times)`` with ``values[i] = [probe values at the i-th probe op]``.
    The ladder is pre-sized as :func:`simulate` sizes it, from the
    state's options (``max_nstate`` unless `max_nstate` is given,
    ``kgrid``) and its kvalue / tvalue; a table train starts from the
    table and merge engine :func:`simulate` would give it.  It plans
    nothing: the A/B baseline of the planned general path of
    :func:`simulate`.
    """
    from .utils.helpers import progressbar

    seq = flatten_sequence(sequence)
    opts = getattr(sm, "options", None) or {}
    if max_nstate is None:
        max_nstate = opts.get("max_nstate")
    _, shape, ncap, dense, varying = _sequence_preamble(
        seq, max_nstate, sm.kvalue, opts.get("kgrid"), sm.tvalue)
    if sm.coords is None and _is_table(_shift_ops(seq)):
        if dense is not None:
            ncap = dense
        elif varying is not None:
            ncap = varying[0]
    if sm.nstate < ncap:
        sm = sm.resize(ncap)
    if sm.coords is None and _is_table(_shift_ops(seq)):
        sm = _table_state(sm, seq, shape, dense, varying,
                          _center_only_init(sm))
    tic = 0
    times, values = [], []
    for op in (progressbar(seq, "Simulating: ") if disp else seq):
        sm = op(sm)
        tic = tic + np.asarray(op.duration)
        if isinstance(op, probe_mod.Probe):
            values.append([_own((pb if pb is not None else op).acquire(
                sm, post=op.post)) for pb in (probes or [op])])
            times.append(tic)
        elif callback is not None:
            callback(sm)
    return values, times


def _kernel_gate(fisp_kernel, what):
    """Whether the device and precision let `fisp_kernel` engage a fused
    kernel; logs the reason at INFO when they do not."""
    if fisp_kernel not in ("auto", "force"):
        raise ValueError(f"fisp_kernel must be 'auto', 'force' or False, "
                         f"got {fisp_kernel!r}")
    if fisp_kernel == "auto":
        if config.device().type != "cuda":
            LOGGER.info("simulate: %s not used: device is %s (the kernel "
                        "runs on cuda)", what, config.device())
            return False
        if config.precision() != "float32":
            LOGGER.info("simulate: %s not used: precision is %s (the kernel "
                        "computes in float32)", what, config.precision())
            return False
    return True


def _primal_dispatch(sequence, ncap, fisp_kernel, kvalue, disp, shape,
                     density):
    """The family table (engine.py:874-940 of the JAX package): FISP,
    CPMG, bSSFP, DESS, ME-GRE, DW-FISP, EPG-X GRE, composite EPG-X,
    composite GRE; the first match wins, each family behind its own
    shared-memory gate (none for bSSFP: its state is three registers).
    With `density` set only the EPG-X families take part (the others
    assume a unit equilibrium).
    Returns the kernel's echo train (N, *batch), or None (logged)."""
    from . import fisp_dispatch as fd
    from .models import cuda_composite

    if not _kernel_gate(fisp_kernel, "fused kernels"):
        return None
    # the EPG-X families: 6 planes per compartment (a balanced train runs
    # at nstate 0); the JAX gates' output windows (engine.py:910-922) do
    # not apply, the echoes go to HBM
    xfamilies = [
        (lambda seq: fd.match_xgre(seq, shape, density),
         lambda p: fd.xgre_kernel_fits(p, ncap), fd.run_xgre_kernel,
         "EPG-X GRE", "xgre"),
        (lambda seq: fd.match_xcomposite(seq, shape, density),
         lambda p: fd.xcomposite_kernel_fits(p, ncap),
         fd.run_xcomposite_kernel, "EPG-X composite", "xcomp"),
    ]
    if density is not None:
        return _run_families(xfamilies, sequence, ncap, disp)
    families = [
        (fd.match_fisp, lambda p: fd.kernel_fits(ncap), fd.run_fisp_kernel,
         "FISP", "fisp"),
        (lambda seq: fd.match_mse(seq, kvalue),
         lambda p: fd.mse_kernel_fits(ncap, p["diffusion"] is not None),
         fd.run_mse_kernel, "CPMG", "mse"),
        # k = 0 only: three floats per atom in registers, always fits
        (fd.match_bssfp, lambda p: True, fd.run_bssfp_kernel, "bSSFP",
         "bssfp"),
        (fd.match_dess, lambda p: fd.kernel_fits(ncap), fd.run_dess_kernel,
         "DESS", "dess"),
        # cuda_megre.megre_kernel_fits: the thread-per-atom layout's bound
        # (the FISP kernel's 6 planes), kept so that no train changes route
        (fd.match_megre, lambda p: fd.kernel_fits(ncap),
         fd.run_megre_kernel, "ME-GRE", "megre"),
        # the FISP kernel computes the attenuation rows per TR: its 6
        # planes, not the JAX gate's 9 VMEM planes
        (lambda seq: fd.match_dwfisp(seq, kvalue),
         lambda p: fd.kernel_fits(ncap), fd.run_dwfisp_kernel, "DW-FISP",
         "dw"),
    ] + xfamilies + [
        # Composite stage trains come last: the exact-pattern families
        # above keep their faster kernels.  Its gate counts the 6 planes
        # only: the JAX gate folds its VMEM output windows in
        # (engine.py:925-929), but on the card the echoes go to HBM
        (lambda seq: fd.match_composite(seq, kvalue),
         lambda p: cuda_composite.composite_kernel_fits(ncap),
         fd.run_composite_kernel,
         "composite GRE", "comp"),
    ]
    return _run_families(families, sequence, ncap, disp)


def _run_families(families, sequence, ncap, disp):
    """The first family of `families` whose matcher takes the train and
    whose gate passes runs it; None (logged) when none does."""
    from . import fisp_dispatch as fd

    for matcher, fits, runner, family, tag in families:
        params = matcher(sequence)
        if params is None:
            continue
        if not fits(params):
            LOGGER.info("simulate: %s kernel not used: gate: nstate=%d does "
                        "not fit in shared memory", family, ncap)
            continue
        if disp:
            LOGGER.info("simulate: %s train -> fused CUDA kernel (%d pulses, "
                        "nstate=%d)", family,
                        len(params.get("FA", params.get("alpha", ()))), ncap)
        fd.count_dispatch(tag)
        return runner(params, ncap)
    return None


def _hessian_dispatch(sequence, probes, ncap, disp):
    """Per-pulse (alias-variable) trains with Jacobian/Hessian probes
    (engine.py:1002-1041 of the JAX package): the per-pulse Hessian
    kernel's outputs, a tuple over probes, or None (logged)."""
    from . import fisp_dispatch

    params = fisp_dispatch.match_fisp_hessian(sequence)
    if params is None:
        return None
    hmatch = fisp_dispatch.match_hessian_probes(probes, params)
    if hmatch is None:
        LOGGER.info("simulate: FISP Hessian kernel not used: probes are "
                    "not [Adc | Jacobian(F0) | Hessian(F0) of (magnitude, "
                    "T1, T2) x aliases] over the train's aliases")
        return None
    specs, second = hmatch
    if not fisp_dispatch.hess_kernel_fits(ncap, second):
        LOGGER.info("simulate: FISP Hessian kernel not used: gate: "
                    "nstate=%d does not fit in shared memory", ncap)
        return None
    if disp:
        LOGGER.info("simulate: per-pulse diff train -> fused CUDA Hessian "
                    "kernel (%d TR, nstate=%d, order=%d)", len(params["FA"]),
                    ncap, 2 if second else 1)
    fisp_dispatch.count_dispatch("hessian")
    return fisp_dispatch.run_fisp_hessian(params, ncap, specs, second)


def _diff_dispatch(sequence, probes, ncap, fisp_kernel, kvalue, disp):
    """Jacobian/Hessian probes through a fused kernel: the per-pulse
    Hessian kernel first, then the FISP and CPMG Jacobian kernels; None
    (logged) takes the general diff path."""
    if not _kernel_gate(fisp_kernel, "fused diff kernels"):
        return None
    values = _hessian_dispatch(sequence, probes, ncap, disp)
    if values is None:
        values = _jacobian_dispatch(sequence, probes, ncap, kvalue, disp)
    return values


def _jacobian_dispatch(sequence, probes, ncap, kvalue, disp):
    """Jacobian probes on a FISP, CPMG, bSSFP, DESS, ME-GRE, DW-FISP or
    composite-GRE train (engine.py:1042-1136 of the JAX package): the
    fused primal+tangent kernel's outputs, a tuple over probes, or None
    (logged) for the general path.  Each family's gate sees the match and
    the probe specs."""
    from . import fisp_dispatch
    from .models import cuda_composite

    # cheap probe-shape pre-check against the maximal variable set before
    # paying the host-side train factorization
    specs = fisp_dispatch.match_jacobian_probes(
        probes, ("T1", "T2", "g", "B1", "D", "Dcoef"))
    if specs is None:
        LOGGER.info("simulate: FISP Jacobian kernel not used: probes are "
                    "not [Adc | Jacobian(F0)] over kernel variables")
        return None
    families = [
        (fisp_dispatch.match_fisp,
         lambda p, s: fisp_dispatch.jac_kernel_fits(ncap),
         fisp_dispatch.run_fisp_jacobian, "FISP", "jac:fisp"),
        # 24 planes, 30 with the DW-TSE attenuation (engine.py:1083-1099)
        (lambda seq: fisp_dispatch.match_mse(seq, kvalue),
         lambda p, s: fisp_dispatch.mse_jac_kernel_fits(
             ncap, p["diffusion"] is not None),
         fisp_dispatch.run_mse_jacobian, "CPMG", "jac:mse"),
        # k = 0 only, always fits (engine.py:1081-1082)
        (fisp_dispatch.match_bssfp, lambda p, s: True,
         fisp_dispatch.run_bssfp_jacobian, "bSSFP", "jac:bssfp"),
        (fisp_dispatch.match_dess,
         lambda p, s: fisp_dispatch.jac_kernel_fits(ncap),
         fisp_dispatch.run_dess_jacobian, "DESS", "jac:dess"),
        # 30 planes: the df tangent group (engine.py:1084-1085), the
        # FISP Jacobian kernel's with its dD group
        (fisp_dispatch.match_megre, lambda p, s: _megre_jac_fits(p, ncap),
         fisp_dispatch.run_megre_jacobian, "ME-GRE", "jac:megre"),
        # the FISP Jacobian kernel's 24 planes, 30 with the dD group (not
        # the JAX gate's 30/36 VMEM planes: the attenuation rows are
        # computed per TR)
        (lambda seq: fisp_dispatch.match_dwfisp(seq, kvalue),
         lambda p, s: fisp_dispatch.jac_kernel_fits(
             ncap, p["d_var"] is not None),
         fisp_dispatch.run_dwfisp_jacobian, "DW-FISP", "jac:dw"),
        # composite comes last; its gate counts 6 (1 + ng) planes for the
        # ng tangent groups the probes need -- not the JAX gate's output
        # windows (engine.py:1086-1095): the outputs go to HBM.  The EPG-X
        # trains have no Jacobian dispatch (engine.py:1047-1080): with the
        # density option they take the general diff path, as in JAX
        (lambda seq: fisp_dispatch.match_composite(seq, kvalue),
         lambda p, s: cuda_composite.composite_jac_kernel_fits(
             ncap, len(fisp_dispatch.composite_jac_groups(s))),
         fisp_dispatch.run_composite_jacobian, "composite GRE", "jac:comp"),
    ]
    for matcher, fits, runner, family, tag in families:
        params = matcher(sequence)
        if params is None:
            continue
        specs = fisp_dispatch.match_jacobian_probes(probes, params["vars"])
        if specs is None:
            LOGGER.info("simulate: %s Jacobian kernel not used: probe "
                        "variables %s are not the train's tracked %s",
                        family,
                        [getattr(pb, "variables", None) for pb in probes],
                        params["vars"])
            return None
        if not fits(params, specs):
            LOGGER.info("simulate: %s Jacobian kernel not used: gate: "
                        "nstate=%d does not fit in shared memory", family,
                        ncap)
            return None
        if disp:
            LOGGER.info("simulate: %s diff train -> fused CUDA Jacobian "
                        "kernel (%d pulses, nstate=%d)", family,
                        len(params["FA"]), ncap)
        fisp_dispatch.count_dispatch(tag)
        return runner(params, ncap, specs)
    LOGGER.info("simulate: Jacobian kernels not used: not a FISP, CPMG, "
                "bSSFP, DESS, ME-GRE, DW-FISP or composite-GRE train")
    return None


def _megre_jac_fits(params, ncap):
    """The ME-GRE Jacobian family's gate: the kernel's 30 planes of ncap + 1
    rows and one pulse's staged echoes, m per TR
    (``cuda_megre.megre_jac_kernel_fits``); the echo count's refusal is
    logged here."""
    from .models import cuda_megre

    m = int(params["nechoes"])
    if not cuda_megre.megre_jac_kernel_fits(ncap):
        return False
    if cuda_megre.megre_jac_kernel_fits(ncap, m):
        return True
    LOGGER.info("simulate: ME-GRE Jacobian kernel not used: gate: %d echoes "
                "per TR stage more than one block's shared memory holds at "
                "nstate=%d", m, ncap)
    return False


# -- squeeze and the scan planner (JAX engine.py:362-395, 470-775) --


def squeeze_sequence(sequence):
    """Merge runs of adjacent combinable linear operators into one
    CombinedOp each (JAX ``engine.squeeze_sequence``; the reference
    declares this NotImplemented).  An op that tracks derivatives (an
    ``order1`` spec) is never merged."""
    out, run = [], []

    def flush():
        if len(run) == 1:
            out.append(run[0])
        elif run:
            op = run[0]
            for nxt in run[1:]:
                op = op.combine(nxt)
            out.append(op)
        run.clear()

    for op in flatten_sequence(sequence):
        if (isinstance(op, base.CombinableOperator)
                and not isinstance(op, probe_mod.Probe) and not op.order1):
            run.append(op)
        else:
            flush()
            out.append(op)
    flush()
    return out


def getkdim(sequence) -> int:
    """Number of gradient axes used by the sequence (4 with a time axis,
    the C operator's)."""
    return max([getattr(op, "kdim", 1) for op in flatten_sequence(sequence)],
               default=1)


class _ScanBlock:
    """`reps` repetitions of a `period`-operator block."""

    __slots__ = ("ops", "period", "reps")

    def __init__(self, ops, period, reps):
        self.ops = ops
        self.period = period
        self.reps = reps


def _build_plan(ops, *, min_reps=3, min_ops=6, max_period=64, scan=True):
    """Split the op list into unrolled runs (lists) and periodic blocks
    (:class:`_ScanBlock`): at each position the smallest period whose
    block repeats at least `min_reps` times over at least `min_ops` ops
    wins (JAX ``engine._build_plan``, same thresholds)."""
    if not scan:
        return [list(ops)]
    sigs = [op.signature() for op in ops]
    plan, buf, i, n = [], [], 0, len(ops)
    while i < n:
        best = None
        for p in range(1, min(max_period, (n - i) // 2) + 1):
            if sigs[i:i + p] != sigs[i + p:i + 2 * p]:
                continue
            r = 2
            while (i + (r + 1) * p <= n
                   and sigs[i + r * p:i + (r + 1) * p] == sigs[i:i + p]):
                r += 1
            if r >= min_reps and r * p >= min_ops:
                best = (p, r)
                break
        if best:
            if buf:
                plan.append(buf)
                buf = []
            p, r = best
            plan.append(_ScanBlock(ops[i:i + p * r], p, r))
            i += p * r
        else:
            buf.append(ops[i])
            i += 1
    if buf:
        plan.append(buf)
    return plan


def _device_leaf(x, dtype=None):
    """A parameter as a tensor on the working device: in `dtype` where an
    operator asks for one (``Operator.LEAF_DTYPES``), else complex values
    in the complex working dtype and others in the real one (None
    passes)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        dtype = dtype or (config.complex_dtype() if x.is_complex()
                          else config.real_dtype())
        return x.to(device=config.device(), dtype=dtype)
    arr = np.asarray(x)
    dtype = dtype or (config.complex_dtype() if np.iscomplexobj(arr)
                      else config.real_dtype())
    return torch.as_tensor(arr, dtype=dtype, device=config.device())


def _device_value(v):
    """A numeric host array as a tensor on the working device; scalars
    and anything else as they are."""
    if isinstance(v, np.ndarray) and v.ndim and v.dtype.kind in "biufc":
        return _device_leaf(v)
    return v


def _device_op(op):
    """A copy of `op` whose parameters are tensors on the working device
    (exchange ops with their mixing matrix computed), so that applying it
    moves nothing from the host: what a CUDA graph capture requires."""
    from .ops.combined import CombinedOp
    from .ops.exchange import X, precompute_exchange

    if isinstance(op, CombinedOp):
        return op.copy(ops=[_device_op(o) for o in op.ops])
    if isinstance(op, base.System):
        # system properties (imaging weights, modulation, positions) are
        # read inside the program
        return op.copy(values=tuple(_device_value(v) for v in op.values))
    if isinstance(op, probe_mod.Imaging):
        op = op.copy(opts={k: _device_value(v) for k, v in op.opts.items()})
    if type(op) is X:
        pre = precompute_exchange(op)
        if pre is not None:
            return pre
    leaves = op.leaves()
    if not any(x is not None for x in leaves):
        return op
    return op.with_leaves([_device_leaf(x, dt) for x, dt in
                           zip(leaves, op.leaf_dtypes())])


def _slot_invariant(ops) -> bool:
    """True when every repetition of a block's slot (ops of one
    signature: the same class and static configuration) is
    parameter-identical.  Tensors compare by identity only (a value check
    would cost a device to host copy); host values by
    ``np.array_equal``."""
    op0 = ops[0]
    leaves0 = op0.leaves()
    for op in ops[1:]:
        if op is op0:
            continue
        for a, b in zip(leaves0, op.leaves()):
            if a is b:
                continue
            if (a is None or b is None or isinstance(a, torch.Tensor)
                    or isinstance(b, torch.Tensor)):
                return False
            a, b = np.asarray(a), np.asarray(b)
            if (a.shape != b.shape or a.dtype != b.dtype
                    or not np.array_equal(a, b)):
                return False
    return True


def _stack_leaves(ops):
    """Each parameter position of structurally identical ops stacked
    along a new leading repetition axis, on the working device."""
    columns = zip(*[op.leaves() for op in ops])
    out = []
    for dtype, col in zip(ops[0].leaf_dtypes(), columns):
        if col[0] is None:
            out.append(None)
        elif any(isinstance(x, torch.Tensor) for x in col):
            out.append(torch.stack([_device_leaf(x, dtype) for x in col]))
        else:
            out.append(_device_leaf(np.stack([np.asarray(x) for x in col]),
                                    dtype))
    return out


def _stack_block(block: _ScanBlock):
    """The slots of a periodic block, one per position of its period:
    ``("const", op)`` for a slot identical at every repetition (E/P/R
    precomputed once, X with its mixing matrix, others on the device), or
    ``("stack", template, leaves)`` with each parameter stacked over the
    repetitions -- E/P/R as precomputed coefficients over the whole
    repetition axis, T/Phi and the rest as their parameters (the rotation
    is formed inside the step).  Step k applies
    ``template.with_leaves([leaf[k] ...])``."""
    from .ops.evolution import E, P, R
    from .ops.scalarop import precompute_diagonal

    p, r = block.period, block.reps
    slots = []
    for j in range(p):
        ops_j = [block.ops[j + k * p] for k in range(r)]
        if _slot_invariant(ops_j):
            op = ops_j[0].strip_meta()
            pre = precompute_diagonal(op) if isinstance(op, (E, P, R)) \
                else None
            slots.append(("const", _device_op(op) if pre is None else pre))
            continue
        template = ops_j[0].strip_meta()
        leaves = _stack_leaves(ops_j)
        if isinstance(template, (E, P, R)):
            pre = precompute_diagonal(template.with_leaves(leaves), reps=r)
            if pre is not None:
                template, leaves = pre, pre.leaves()
        slots.append(("stack", template, leaves))
    return slots


class _PlanEntry:
    """A cached plan: the pinned operator list, the plan's kinds and
    payload (tensors on the working device), its CUDA graphs and the
    device bytes they hold."""

    __slots__ = ("ops", "kinds", "payload", "nbytes", "graphs")

    def __init__(self, ops, kinds, payload, nbytes):
        self.ops = ops
        self.kinds = kinds
        self.payload = payload
        self.nbytes = nbytes
        self.graphs = {}


#: plan cache: repeated simulate() calls on the same operator objects skip
#: signatures, period detection, stacking and capture; entries pin their
#: ops (ids stay valid) and are evicted oldest first past either limit
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 16
_PLAN_CACHE_MAX_BYTES = 6 * 1024 ** 3


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(x) for x in obj)
    if isinstance(obj, base.Operator):
        sub = getattr(obj, "ops", None)
        return _tensor_bytes(obj.leaves()) + (_tensor_bytes(sub) if sub
                                              else 0)
    return 0


def _evict(keep=None):
    """Drop the oldest plans until both cache limits hold (`keep` stays)."""
    while True:
        total = sum(e.nbytes for e in _PLAN_CACHE.values())
        if len(_PLAN_CACHE) <= _PLAN_CACHE_MAX and \
                total <= _PLAN_CACHE_MAX_BYTES:
            return
        victim = next((k for k in _PLAN_CACHE if k != keep), None)
        if victim is None:
            return
        _PLAN_CACHE.pop(victim)


def _plan_and_payload(sequence, *, scan=True, cache=True):
    """The cached :class:`_PlanEntry` of a flat operator list, keyed on
    the operators' ids, `scan`, the working device and precision."""
    key = (tuple(id(op) for op in sequence), scan, str(config.device()),
           config.precision())
    entry = _PLAN_CACHE.get(key) if cache else None
    if entry is not None:
        return entry
    plan = _build_plan(sequence, scan=scan)
    kinds = tuple(("unroll",) if isinstance(pl, list) else ("scan", pl.reps)
                  for pl in plan)
    payload = [[_device_op(op) for op in pl] if isinstance(pl, list)
               else (pl.ops[:pl.period], _stack_block(pl)) for pl in plan]
    entry = _PlanEntry(list(sequence), kinds, payload,
                       sum(_tensor_bytes(pl[1] if isinstance(pl, tuple)
                                         else pl) for pl in payload))
    if cache:
        _PLAN_CACHE[key] = entry
        _evict(keep=key)
    return entry


def _own(value):
    """A probe value that holds no view of the ladder: an ``F0`` read is
    a view that would keep the whole step's ladder alive until the end
    of the train (1000 ladders of 51.6 MB at the headline's width)."""
    if isinstance(value, (tuple, list)):
        return type(value)(_own(v) for v in value)
    if isinstance(value, torch.Tensor) and value._base is not None:
        return value.clone()
    return value


def _acquire(op, probes, sm):
    """All probe values at a probe position (a tuple over probes)."""
    return tuple(_own((pb if pb is not None else op).acquire(sm,
                                                             post=op.post))
                 for pb in (probes if probes is not None else [None]))


def _execute_plan(kinds, payload, probes, sm, callback=None, disp=False,
                  max_reps=None):
    """Run the planned program (JAX ``engine._execute_plan``): returns
    (sm, acquired), one tuple of probe values per probe position in
    sequence order (a block's probe slots interleave rep-major).
    ``max_reps`` runs at most that many repetitions of each block."""
    from .utils.helpers import progressbar

    acquired = []
    for kind, pl in zip(kinds, payload):
        if kind[0] == "unroll":
            for op in (progressbar(pl, "Simulating: ") if disp else pl):
                sm = op(sm)
                if isinstance(op, probe_mod.Probe):
                    acquired.append(_acquire(op, probes, sm))
                elif callback is not None:
                    callback(sm)
            continue
        template, slots = pl
        probe_slots = {j for j, op in enumerate(template)
                       if isinstance(op, probe_mod.Probe)}
        reps = kind[1] if max_reps is None else min(kind[1], max_reps)
        for k in range(reps):
            for j, slot in enumerate(slots):
                op = slot[1] if slot[0] == "const" else slot[1].with_leaves(
                    [None if x is None else x[k] for x in slot[2]])
                sm = op(sm)
                if j in probe_slots:
                    # the per-step op: probe parameters (an Adc phase)
                    # vary across repetitions
                    acquired.append(_acquire(op, probes, sm))
    return sm, acquired


def _stack_values(acquired):
    """Per-probe values stacked over the ADC axis; a tuple-valued probe
    (``Probe("(real(F0), imag(F0))")``) gives a tuple of stacks."""
    out = []
    for i in range(len(acquired[0])):
        vals = [a[i] for a in acquired]
        if isinstance(vals[0], (tuple, list)):
            out.append(tuple(torch.stack([torch.as_tensor(v[c]) for v in vals])
                             for c in range(len(vals[0]))))
        else:
            out.append(torch.stack([torch.as_tensor(v) for v in vals]))
    return tuple(out)


def _host_work(callback, disp, probes, sequence):
    """Why the planned program must run eagerly (host work between ops:
    a callback, the progress bar, a user-callable probe), or None."""
    if callback is not None:
        return "a callback runs after every operator"
    if disp:
        return "disp shows a progress bar"
    for pb in list(probes or ()) + [op for op in sequence
                                    if isinstance(op, probe_mod.Probe)]:
        if getattr(pb, "_callable", None) is not None:
            return f"probe {pb!r} calls user code"
    return None


class _Graph:
    """A captured CUDA graph of a planned program: its static input
    ladders, its output tensors and the device bytes it holds."""

    __slots__ = ("graph", "states", "equilibrium", "coords", "outputs",
                 "nbytes")


#: CUDA graph captures and replays (counted for tests and chip_smoke.py)
GRAPH_COUNTS = {"captures": 0, "replays": 0}


def _freeze_probe(pb):
    if pb is None:
        return None
    leaves = tuple(base._freeze(np.asarray(x)) if x is not None and
                   not isinstance(x, torch.Tensor) else ("id", id(x))
                   for x in pb.leaves())
    return (pb.signature(), leaves)


def _graph_key(sm, probes):
    coords = None if sm.coords is None else (tuple(sm.coords.shape),
                                             sm.coords.dtype)
    return (tuple(sm.states.shape), tuple(sm.equilibrium.shape),
            sm.states.dtype, coords,
            tuple(_freeze_probe(pb) for pb in probes or ()),
            base._freeze(sm.kvalue), base._freeze(sm.tvalue),
            base._freeze(sm.system), base._freeze(sm.options))


def _capture(entry, probes, sm):
    """Capture the planned program as one CUDA graph (after an eager
    warm-up of every block's first repetition and the unrolled runs, on a
    side stream: lazy module loading and library handles happen there).
    A failure raises: a plan judged capturable never falls back."""
    g = _Graph()
    g.states = sm.states.clone()
    g.equilibrium = sm.equilibrium.clone()
    # the coordinate table is carried state of a table train: a static
    # input of fixed shape, like the ladders
    g.coords = None if sm.coords is None else sm.coords.clone()
    sm0 = sm.update(states=g.states, equilibrium=g.equilibrium,
                    coords=g.coords)
    if probes is not None:
        probes = tuple(None if pb is None else _device_op(pb)
                       for pb in probes)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _execute_plan(entry.kinds, entry.payload, probes, sm0, max_reps=1)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    g.graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g.graph):
            _, acquired = _execute_plan(entry.kinds, entry.payload, probes,
                                        sm0)
            g.outputs = _stack_values(acquired)
    except Exception as exc:
        raise RuntimeError(f"simulate: CUDA graph capture of the planned "
                           f"program failed ({exc}); a capturable plan does "
                           f"not fall back to eager execution") from exc
    g.nbytes = max(torch.cuda.memory_reserved() - before, 0) \
        + 2 * _tensor_bytes([g.states, g.equilibrium, g.coords])
    GRAPH_COUNTS["captures"] += 1
    return g


def _replay(entry, probes, sm):
    """The planned program's outputs through the plan's memoized CUDA
    graph (captured on first use): the input ladders are copied into the
    graph's static inputs, the outputs cloned out."""
    key = _graph_key(sm, probes)
    g = entry.graphs.get(key)
    if g is None:
        g = _capture(entry, probes, sm)
        entry.graphs[key] = g
        entry.nbytes += g.nbytes
        _evict(keep=next((k for k, e in _PLAN_CACHE.items() if e is entry),
                         None))
    g.states.copy_(sm.states)
    g.equilibrium.copy_(sm.equilibrium)
    if g.coords is not None:
        g.coords.copy_(sm.coords)
    g.graph.replay()
    GRAPH_COUNTS["replays"] += 1
    return tuple(tuple(c.clone() for c in v) if isinstance(v, tuple)
                 else v.clone() for v in g.outputs)


def _run_general(sequence, probes, sm, callback, disp):
    """The general path: the planned program (JAX ``_plan_and_payload`` /
    ``_execute_plan``), one CUDA graph replay on the card unless host work
    forces it eager, eager on the CPU.  Returns the per-probe values.  As
    in JAX's compiled program, an exchange op's density-conservation check
    does not run here (it runs where the op is applied directly, as
    ``X.apply`` in JAX's eager loop)."""
    entry = _plan_and_payload(sequence, scan=callback is None)
    if disp:
        LOGGER.info("simulate: %d-op program planned as %s", len(sequence),
                    "/".join(k[0] if k[0] == "unroll" else f"scan x{k[1]}"
                             for k in entry.kinds))
    reason = _host_work(callback, disp, probes, sequence)
    on_card = sm.states.is_cuda
    if on_card and reason is None:
        return _replay(entry, probes, sm)
    if on_card:
        LOGGER.info("simulate: planned program runs eagerly: %s", reason)
    _, acquired = _execute_plan(entry.kinds, entry.payload, probes, sm,
                                callback=callback, disp=disp)
    return _stack_values(acquired)


#: simulate() options consumed by the StateMatrix or the shifts; anything
#: else is logged and forwarded to ``StateMatrix.options`` (JAX
#: ``_KNOWN_OPTIONS``)
_KNOWN_OPTIONS = frozenset({"tvalue", "equilibrium", "nstate", "shape",
                            "check", "system", "kgrid", "prune", "coords"})


def simulate(sequence, *, adc_time: bool = False, init=None,
             squeeze: bool = False, probe=None, callback=None,
             asarray: bool = True, disp: bool = False, max_nstate=None,
             fisp_kernel="auto", jacobian_chunk=None, kvalue=None,
             density=None, **options):
    """Simulate an operator sequence; returns the ADC values.

    API of ``epgpy_tpu.simulate`` (reference epgpy/functions.py:50-170).
    Without `probe`, returns an (N_adc, *batch) complex array of the
    sequence's own ADC values.  With `probe` (one probe or a list:
    ``Adc``, expression strings such as ``"F0"``/``"Z0"``, callables,
    ``diff.Jacobian``, ``diff.Hessian``), returns one array per probe (a
    tuple for a list), acquired at every ADC; a Jacobian is (N_adc,
    *batch, nvars), a Hessian (N_adc, *batch, n1, n2).  Arrays are numpy
    with ``asarray`` (default), else tensors on the working device; with
    ``adc_time``, the ADC times come first.

    ``squeeze`` merges adjacent linear ops first (:func:`squeeze_sequence`);
    ``callback(sm)`` runs after every non-probe op; ``disp`` shows a
    progress bar.  ``init`` is the initial state: a complex (..., K, 3)
    ladder (default ``[0, 0, 1]``) or a StateMatrix (its options merged
    under these).  Options: ``max_nstate`` (ladder cap), ``nstate`` (a
    capacity floor), ``kvalue`` (rad/m per ladder index, the wavenumbers
    D ops read), ``tvalue``, ``kgrid`` (the merge grid of float shifts),
    ``prune`` (accepted, as in JAX), ``coords`` (an initial coordinate
    table), ``density`` / ``equilibrium``, ``shape``, ``check``,
    ``system``; others are logged and forwarded to
    ``StateMatrix.options``.  ``jacobian_chunk=N`` pushes N tangent columns
    at a time on the general diff path (the planned program's chunk).  With ``density`` set only the
    EPG-X kernel families take part; with `init`, a callback, an array
    `kvalue` or any of the StateMatrix options (``kgrid`` included), no
    kernel does.
    """
    from . import diff

    unknown = set(options) - _KNOWN_OPTIONS
    if unknown:
        LOGGER.warning("simulate: unrecognized option(s) %s (forwarded to "
                       "StateMatrix.options)", sorted(unknown))
    sequence = flatten_sequence(sequence)
    if squeeze:
        sequence = squeeze_sequence(sequence)
    if not any(isinstance(op, probe_mod.Probe) for op in sequence):
        raise ValueError("Cannot simulate sequence without at least one "
                         "Probe/ADC")
    probes = None
    if probe is not None:
        probes = tuple(pb if isinstance(pb, (probe_mod.Probe, type(None)))
                       else probe_mod.Probe(pb)
                       for pb in (probe if isinstance(probe, (tuple, list))
                                  else [probe]))
    sm_init = init if isinstance(init, StateMatrix) else None
    kgrid = options.get("kgrid")
    if sm_init is not None:
        if max_nstate is None:
            max_nstate = sm_init.options.get("max_nstate")
        if kgrid is None:
            kgrid = sm_init.options.get("kgrid")
    if kvalue is None:
        kvalue = 1.0 if sm_init is None else sm_init.kvalue
    tvalue = options.get("tvalue")
    if tvalue is None:
        tvalue = 1.0 if sm_init is None else sm_init.tvalue
    nshift, shape, ncap, dense, varying = _sequence_preamble(
        sequence, max_nstate, kvalue, kgrid, tvalue)
    LOGGER.info("simulate: %d ops, nshift=%d, shape=%s", len(sequence),
                nshift, shape)
    # a kgrid, any other option, an init (a coordinate table's included)
    # or an array kvalue keeps every kernel family off (JAX
    # engine.py:854-858); a table train's float or vector shifts fail
    # every family's unit-shift pattern
    use_kernel = (fisp_kernel not in (False, None) and init is None
                  and callback is None and not options
                  and isinstance(kvalue, (int, float)))
    table = _is_table(_shift_ops(sequence))

    def initial_state():
        n = ncap
        # the dense engines size the ladder exactly from the lattice;
        # `nstate` is a floor on the other paths
        if dense is not None:
            n = dense
        elif varying is not None:
            n = varying[0]
        elif options.get("nstate") is not None:
            n = max(n, int(options["nstate"]))
        opts = {k: v for k, v in options.items() if k != "nstate"}
        if max_nstate is not None:
            opts.setdefault("max_nstate", max_nstate)
        if sm_init is not None:
            sm = sm_init.update(options={**sm_init.options, **opts})
            sm = sm.resize(max(n, sm.nstate)).broadcast(shape)
        else:
            sm = StateMatrix([0, 0, 1] if init is None else init,
                             density=1.0 if density is None else density,
                             nstate=n, kvalue=kvalue,
                             **opts).broadcast(shape)
        if not table:
            return sm
        # the fresh [0, 0, 1] start is on k = 0 by construction: no
        # device read
        center = init is None or (
            (dense is not None or varying is not None)
            and _center_only_init(sm))
        return _table_state(sm, sequence, shape, dense, varying, center)

    values = None
    if probes is not None and any(isinstance(pb, (diff.Jacobian,
                                                  diff.Hessian))
                                  for pb in probes):
        if any(pb is None for pb in probes):
            raise ValueError("None probes are not supported with "
                             "Jacobian/Hessian")
        if use_kernel and density is None:
            values = _diff_dispatch(sequence, probes, ncap, fisp_kernel,
                                    kvalue, disp)
        if values is None:
            if disp:
                LOGGER.info("simulate: general diff path (%d ops, "
                            "nstate=%d)", len(sequence), ncap)
            values = diff.simulate_diff(sequence, probes, initial_state(),
                                        jacobian_chunk=jacobian_chunk)
    else:
        if use_kernel and probes is None:
            values = _primal_dispatch(sequence, ncap, fisp_kernel, kvalue,
                                      disp, shape, density)
            if values is not None:
                values = (values,)
        if values is None:
            if disp:
                LOGGER.info("simulate: general path (%d ops, nstate=%d)",
                            len(sequence), ncap)
            values = _run_general(sequence, probes, initial_state(),
                                  callback, disp)
    if asarray:
        values = tuple(_to_numpy(v) for v in values)
    if len(values) == 1:
        values = values[0]
    if adc_time:
        times = get_adc_times(sequence)
        return (np.asarray(times) if asarray else times), values
    return values


def _to_numpy(v):
    """One probe's output as a host array; a tuple-valued probe stacks its
    components on axis 1 (the reference's per-ADC tuple layout)."""
    if isinstance(v, (tuple, list)):
        return np.stack([x.detach().cpu().numpy() for x in v], axis=1)
    return v.detach().cpu().numpy()


# -- modify (reference epgpy/functions.py:251-347) --


def modify(sequence, modifier=None, *, expand: bool = True, **params):
    """Rewrite a sequence, combining ops with duration-matched E/P."""
    shape = getshape(sequence)
    values = common.expand_arrays(*params.values())
    if expand and (len(shape) > 1 or shape[0] > 1):
        dims = len(shape)
        values = tuple(
            v.reshape((1,) * dims + common.get_shape(v))
            if common.get_shape(v) else v for v in values)
    params = dict(zip(params, values))

    if modifier is None:
        modifier = default_modifier
        if not params:
            return sequence
    elif not callable(modifier):
        raise TypeError("`modifier` must be a callable")

    newseq, opdict = [], {}
    for op in flatten_sequence(sequence):
        if id(op) not in opdict:
            opdict[id(op)] = modifier(op, **params)
        newseq.append(opdict[id(op)])
    if isinstance(sequence, base.MultiOperator):
        return base.MultiOperator(newseq, name=sequence.name)
    return newseq


def default_modifier(op, **kwargs):
    """Default modifier: B1 attenuation of T, relaxation over durations."""
    from .ops import evolution, transition

    if isinstance(op, transition.T):
        att = kwargs.get("att")
        if att is not None and not (
                common.get_shape(att) == () and np.allclose(att, 1)):
            op = transition.T(op.alpha * att, op.phi, name=op.name + "#",
                              duration=op.duration)

    if np.any(np.asarray(op.duration) > 0):
        T1, T2, g = kwargs.get("T1"), kwargs.get("T2"), kwargs.get("g")
        if T1 is None and T2 is None and g is None:
            pass
        elif T1 is None and T2 is None:
            op = op * evolution.P(op.duration, g, duration=0)
            op.name = op[0].name + "*"
        else:
            T1 = 1e10 if T1 is None else T1
            T2 = 1e10 if T2 is None else T2
            g = 0 if g is None else g
            op = op * evolution.E(op.duration, T1, T2, g, duration=0)
            op.name = op[0].name + "*"
    return op
