"""Simulation engine: run an operator sequence, return the probe values.

Counterpart of ``epgpy_tpu/engine.py`` (:47-125, :153-159, :778-1277).
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
* **the general path**: the eager operator loop of ``simulate_simple``
  over a StateMatrix broadcast to the sequence's batch shape (for
  Jacobian and Hessian probes, forward-mode autodiff through it:
  diff.simulate_diff).
  It stands in for the JAX package's scan planner, which is not ported
  yet.

The ladder capacity is fixed up front from the sequence's total shift
count, capped by ``max_nstate``; the count and the batch shape are
memoized per operator list (``_sequence_preamble``, ``clear_caches``).
``kvalue`` (rad/m per ladder index) scales the wavenumbers the diffusion
operator reads.
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
           "flatten_sequence", "getshape", "getnshift", "get_adc_times",
           "clear_caches"]


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
#: operator identities, ``max_nstate`` and ``kvalue``; each entry pins its
#: operator list so ids cannot be reused while cached, oldest evicted first
_PREAMBLE_CACHE: dict = {}
_PREAMBLE_CACHE_MAX = 32


def clear_caches():
    """Drop the per-sequence preamble memo and the dispatch's match memo
    (needed only after mutating an operator's arrays in place)."""
    from . import fisp_dispatch

    _PREAMBLE_CACHE.clear()
    fisp_dispatch.clear_cache()


def _sequence_preamble(sequence, max_nstate, kvalue):
    """Cached (nshift, shape) of a flat operator list: repeat simulate()
    calls on one train (dictionary services, Gauss-Newton loops) skip the
    O(n_ops) sweeps of :func:`getnshift` and :func:`getshape`."""
    key = (max_nstate, float(kvalue)) + tuple(id(op) for op in sequence)
    return common.memoize_on_ops(
        _PREAMBLE_CACHE, _PREAMBLE_CACHE_MAX, key, sequence,
        lambda: (getnshift(sequence), getshape(sequence)))


def _capacity(nshift: int, max_nstate) -> int:
    """Static ladder half-capacity of a 1-D integer-shift sequence: exact
    with ``nshift``, capped at ``max_nstate``."""
    return min(int(nshift), int(max_nstate)) if max_nstate else int(nshift)


def simulate_simple(sm, sequence, probes=None, callback=None, disp=False,
                    max_nstate=None):
    """Plain eager sequence loop (reference functions.py:173-192).

    Applies each operator to `sm` and acquires `probes` (or the
    sequence's own probe ops) at every Probe.  Returns ``(values,
    times)`` with ``values[i] = [probe values at the i-th probe op]``.
    The ladder is pre-sized to the sequence's shift count, capped at
    `max_nstate` (the reference resizes inside each shift).
    """
    seq = flatten_sequence(sequence)
    ncap = _capacity(_sequence_preamble(seq, max_nstate, sm.kvalue)[0],
                     max_nstate)
    if sm.nstate < ncap:
        sm = sm.resize(ncap)
    if disp:
        LOGGER.info("simulate_simple: %d ops, nstate=%d", len(seq), ncap)
    tic = 0
    times, values = [], []
    for op in seq:
        sm = op(sm)
        tic = tic + np.asarray(op.duration)
        if isinstance(op, probe_mod.Probe):
            values.append([(pb if pb is not None else op).acquire(
                sm, post=op.post) for pb in (probes or [op])])
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


def simulate(sequence, *, adc_time: bool = False, asarray: bool = True,
             disp: bool = False, max_nstate=None, fisp_kernel="auto",
             probe=None, jacobian_chunk=None, kvalue=1.0, density=None,
             init=None):
    """Simulate an operator sequence; returns the ADC values.

    API of ``epgpy_tpu.simulate`` (reference epgpy/functions.py:50-170)
    for the options this port honours.  Without `probe`, returns an
    (N_adc, *batch) complex array of the sequence's own ADC values.  With
    `probe` (one probe or a list: ``Adc``, callables, ``diff.Jacobian``,
    ``diff.Hessian``), returns one array per probe (a tuple for a list),
    acquired at every ADC; a Jacobian is (N_adc, *batch, nvars), a Hessian
    (N_adc, *batch, n1, n2).  Arrays
    are numpy with ``asarray`` (default), else tensors on the working
    device; with ``adc_time``, the ADC times come first.
    ``jacobian_chunk=N`` pushes N tangent columns at a time on the
    general diff path (N x N Hessian blocks; memory bound).  ``kvalue``
    (rad/m per ladder index) sets the physical wavenumbers of D ops.
    ``density`` sets the equilibrium (the per-compartment densities of
    EPG-X trains, whose X ops mix ``states - equilibrium``); with it set
    only the EPG-X kernel families take part.  ``init`` is the initial
    state (a complex (..., K, 3) ladder, default ``[0, 0, 1]``); with it
    set no kernel takes the train.
    """
    from . import diff

    sequence = flatten_sequence(sequence)
    if not any(isinstance(op, probe_mod.Probe) for op in sequence):
        raise ValueError("Cannot simulate sequence without at least one "
                         "Probe/ADC")
    probes = None
    if probe is not None:
        probes = tuple(pb if isinstance(pb, probe_mod.Probe)
                       else probe_mod.Probe(pb)
                       for pb in (probe if isinstance(probe, (tuple, list))
                                  else [probe]))
    nshift, shape = _sequence_preamble(sequence, max_nstate, kvalue)
    ncap = _capacity(nshift, max_nstate)
    LOGGER.info("simulate: %d ops, nshift=%d, shape=%s", len(sequence),
                nshift, shape)
    use_kernel = fisp_kernel not in (False, None) and init is None

    def initial_state():
        return StateMatrix([0, 0, 1] if init is None else init,
                           density=1.0 if density is None else density,
                           nstate=ncap, kvalue=kvalue).broadcast(shape)

    values = None
    if probes is not None and any(isinstance(pb, (diff.Jacobian,
                                                  diff.Hessian))
                                  for pb in probes):
        if use_kernel and density is None:
            values = _diff_dispatch(sequence, probes, ncap, fisp_kernel,
                                    kvalue, disp)
        if values is None:
            if disp:
                LOGGER.info("simulate: general diff path (%d ops, "
                            "nstate=%d)", len(sequence), ncap)
            values = diff.simulate_diff(sequence, probes, initial_state(),
                                        max_nstate=max_nstate,
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
            acquired, _ = simulate_simple(initial_state(), sequence,
                                          probes=probes,
                                          max_nstate=max_nstate)
            values = tuple(torch.stack([v[i] for v in acquired])
                           for i in range(len(acquired[0])))
    if asarray:
        values = tuple(v.detach().cpu().numpy() for v in values)
    if len(values) == 1:
        values = values[0]
    if adc_time:
        times = get_adc_times(sequence)
        return (np.asarray(times) if asarray else times), values
    return values


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
