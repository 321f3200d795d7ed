"""Differentiation layer: Jacobian and Hessian probes by forward-mode
autodiff.

Counterpart of ``epgpy_tpu/diff.py:47-617``.  The reference hand-derives
per-operator derivative matrices (reference epgpy/diff.py:20-378); here,
as in the JAX package, derivatives come from autodiff through the whole
sequence:

* every operator keeps its physical parameters, so the derivative of its
  coefficients w.r.t. any parameter is exact autodiff;
* variable aliases and chain-rule coefficients (order1/order2 specs)
  become an epsilon substitution: each tracked parameter is replaced by

      p(eps) = p + sum_v c1[v] eps_v
                 + sum_{v<=w} c2[(v,w)] eps_v eps_w (1/2 if v == w)

  and the Jacobian/Hessian are the first/second derivatives of the signal
  w.r.t. eps at 0;
* the forward pass is the port's eager operator loop
  (``engine.simulate_simple``); ``torch.func.jvp`` pushes the tangent
  basis through it, batched by ``torch.func.vmap`` (the primal does not
  depend on the tangent, so it runs once per call); a Hessian is a jvp of
  that jvp over the restricted tangent sets vars1 x vars2;
* on the card, a stage of ``jacobian_chunk`` passes of one shape (the
  Jacobian chunks, the Hessian blocks) captures its first pass as a CUDA
  graph and replays it for every chunk, the chunk's tangent basis copied
  into the graph's static input: the per-op host work of the transforms
  (milliseconds per op under nested ``jvp``) is paid once per stage, as
  JAX compiles the chunk program once.

Outputs match the reference probes: Jacobian -> (nADC, ..., nvars),
Hessian -> (nADC, ..., n1, n2); the pseudo-variable "magnitude" maps to
the signal itself / its first derivatives (reference epgpy/diff.py:384-476).
"""

from __future__ import annotations

import copy
import itertools
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from . import config
from .ops import base, probe as probe_mod

__all__ = ["Jacobian", "Hessian", "Pair", "PartialsPruner", "get_combinations",
           "parse_order1", "parse_order2", "tracked_variables", "substitute",
           "simulate_diff"]

def Pair(*args):
    """Sorted variable pair (reference epgpy/diff.py:534)."""
    if len(args) == 1:
        args = tuple(args[0])
    if len(args) != 2:
        raise ValueError(f"Expected a pair, got {args}")
    return tuple(sorted(args))


def get_combinations(items):
    return list(itertools.combinations_with_replacement(sorted(items), 2))


def parse_order1(order1, parameters):
    """Normalize an order1 spec to {var: {param: coeff}}."""
    parameters = set(parameters)
    if isinstance(order1, str):
        order1 = [order1]
    if not order1:
        return {}
    if order1 is True:
        out = {p: {p: 1.0} for p in parameters}
    elif isinstance(order1, (list, tuple, set)):
        out = {p: {p: 1.0} for p in order1}
    elif isinstance(order1, dict) and all(isinstance(v, str)
                                          for v in order1.values()):
        out = {var: {order1[var]: 1.0} for var in order1}
    elif isinstance(order1, dict) and all(isinstance(v, dict)
                                          for v in order1.values()):
        out = {var: dict(cfs) for var, cfs in order1.items()}
    else:
        raise ValueError(f"Invalid 'order1' value: {order1!r}")
    invalid = {p for var in out for p in set(out[var]) - parameters}
    if invalid:
        raise ValueError(f"Unknown parameter(s): {invalid}")
    return out


def parse_order2(order2, order1, parameters):
    """Normalize an order2 spec to {Pair: {param: coeff}} (curvature terms)."""
    if not order2:
        return {}
    if not order1:
        raise ValueError("order1 must be set.")
    parameters = set(parameters)
    if order2 is True:
        out = {Pair(p): {} for p in get_combinations(order1)}
    elif isinstance(order2, str):
        out = {(order2, order2): {}}
    elif not isinstance(order2, dict) and all(isinstance(v, str)
                                              for v in order2):
        out = {Pair(p): {} for p in get_combinations(order2)}
    elif not isinstance(order2, dict) and all(isinstance(p, tuple)
                                              for p in order2):
        out = {Pair(p): {} for p in order2}
    elif isinstance(order2, dict):
        out = {Pair(p): dict(order2[p]) for p in order2}
    else:
        raise ValueError(f"Invalid 'order2' value: {order2!r}")
    invalid = {pair for pair in out if not (set(pair) & set(order1))}
    if invalid:
        raise ValueError(f"Variable pair(s) missing from order1: {invalid}")
    invalid = {p for pair in out for p in set(out[pair]) - parameters}
    if invalid:
        raise ValueError(f"Unknown parameter(s) in order2: {invalid}")
    return out


# -- probes --


def _as_list(variables):
    if isinstance(variables, tuple):
        return list(variables)
    return list(variables) if isinstance(variables, list) else [variables]


class Jacobian(probe_mod.Probe):
    """Probe returning d(signal)/d(variables) at each ADC."""

    def __init__(self, variables, *, probe="F0"):
        self.probe_attr = probe
        self.variables = _as_list(variables)
        base.Operator.__init__(self, name=f"Jacobian({probe})")

    def __repr__(self):
        return f"Jacobian({self.probe_attr})"


class Hessian(probe_mod.Probe):
    """Probe returning d2(signal)/d(vars1)d(vars2) at each ADC."""

    def __init__(self, variables1, variables2=None, *, probe="F0"):
        self.probe_attr = probe
        self.variables1 = _as_list(variables1)
        self.variables2 = (list(self.variables1) if not variables2
                           else _as_list(variables2))
        base.Operator.__init__(self, name=f"Hessian({probe})")

    def __repr__(self):
        return f"Hessian({self.probe_attr})"


class PartialsPruner:
    """API-compat no-op (reference epgpy/diff.py:479-527).

    The reference prunes small derivative state matrices to bound its
    Python-loop forward accumulation.  Here derivatives are dense
    forward-mode tangents, so there is nothing to prune; the memory knob
    is ``simulate(..., jacobian_chunk=N)`` (N tangent columns at a time).
    """

    _warned = False

    def __init__(self, *, condition=1e-5, variables=None):
        if not PartialsPruner._warned:
            PartialsPruner._warned = True
            logging.getLogger(__name__).warning(
                "PartialsPruner is an API-compat no-op in epgpy_torch: "
                "derivatives are dense forward-mode tangents (nothing to "
                "prune, no accuracy trade).  Use simulate(..., "
                "jacobian_chunk=N) to bound derivative memory instead.")
        self.condition = condition
        self.variables = variables

    def __call__(self, sm):  # pragma: no cover - intentional no-op
        return None


# -- epsilon substitution --


def tracked_variables(sequence) -> List[str]:
    """All variables tracked by order1 specs, in first-appearance order."""
    seen, out = set(), []
    for op in sequence:
        for var in getattr(op, "order1", {}) or {}:
            if var not in seen:
                seen.add(var)
                out.append(var)
    return out


def _param_tensor(value):
    """An operator parameter as a tensor of the working precision (complex
    for complex parameters), on the working device."""
    if isinstance(value, torch.Tensor):
        cplx = value.is_complex()
    else:
        cplx = np.iscomplexobj(value)
    dtype = config.complex_dtype() if cplx else config.real_dtype()
    return torch.as_tensor(value, dtype=dtype, device=config.device())


def substitute(op, eps: Dict[str, torch.Tensor]):
    """Copy `op` with tracked parameters shifted by the eps expansion:
    linear deltas ``sum_v c1 eps_v`` and the order2 curvature terms
    ``c2 eps_v eps_w`` (scale 1/2 on the diagonal), which reach the
    Hessian only.  Operators with user derivative arrays (ScalarOp
    ``darrs`` / MatrixOp ``dmats``) shift their coefficients by them; a
    CombinedOp substitutes its constituents.  Ops without specs are
    returned as they are."""
    from .ops.combined import CombinedOp

    if isinstance(op, CombinedOp):
        subs = [substitute(sub, eps) for sub in op.ops]
        if all(s is o for s, o in zip(subs, op.ops)):
            return op
        return CombinedOp(subs, name=op.name, duration=op.duration)
    order1 = getattr(op, "order1", {}) or {}
    order2 = getattr(op, "order2", {}) or {}
    if not order1:
        return op
    lin: Dict[str, object] = {}
    quad: Dict[str, object] = {}

    def add(terms, param, term):
        terms[param] = term if param not in terms else terms[param] + term

    for var, coeffs in order1.items():
        if var in eps:
            for param, c in coeffs.items():
                add(lin, param, _param_tensor(c) * eps[var])
    for (v1, v2), coeffs in order2.items():
        if v1 in eps and v2 in eps:
            scale = 0.5 if v1 == v2 else 1.0
            for param, c in coeffs.items():
                add(quad, param, scale * _param_tensor(c) * eps[v1]
                    * eps[v2])
    new = copy.copy(op)
    new.order1, new.order2 = {}, {}
    handled = set()
    if getattr(op, "diff_arrays", None) is not None:
        handled = new.apply_diff_arrays(lin, quad)
    for param in (set(lin) | set(quad)) - handled:
        d = lin.get(param, 0.0) + quad.get(param, 0.0)
        old = getattr(new, param, None)
        if param not in op.PARAMETERS_ORDER1 or old is None:
            raise ValueError(f"Cannot substitute parameter {param!r} on "
                             f"{type(op).__name__}")
        setattr(new, param, d + _param_tensor(old))
    return new


# -- diff simulation path --

#: CUDA graphs of chunked diff passes: captured and replayed (diagnostics)
GRAPH_COUNTS = {"captures": 0, "replays": 0}


def _on_device(op):
    """A copy of `op` whose parameters and derivative coefficients are
    tensors on the working device: a pass captured in a CUDA graph may copy
    nothing from the host.  Ops without derivative specs take the planner's
    device copy (``engine._device_op``)."""
    from .engine import _device_leaf, _device_op
    from .ops.combined import CombinedOp

    if not (getattr(op, "order1", None) or getattr(op, "order2", None)):
        return _device_op(op)
    if isinstance(op, CombinedOp):
        new = op.copy(ops=[_on_device(o) for o in op.ops])
    else:
        leaves = op.leaves()
        new = op.with_leaves([_device_leaf(x, dt) for x, dt in
                              zip(leaves, op.leaf_dtypes())])
        if getattr(op, "diff_arrays", None) is not None:
            new.diff_arrays = {
                key: {k: tuple(None if a is None else _param_tensor(a)
                               for a in pair) for k, pair in part.items()}
                for key, part in op.diff_arrays.items()}
    new.order1 = {v: {p: _param_tensor(c) for p, c in cfs.items()}
                  for v, cfs in (op.order1 or {}).items()}
    new.order2 = {v: {p: _param_tensor(c) for p, c in cfs.items()}
                  for v, cfs in (op.order2 or {}).items()}
    return new


class _PassGraph:
    """One diff pass ``fn(*bases)`` captured as a CUDA graph: each call
    copies its tangent bases into the static inputs, replays, and clones
    the outputs out (a tuple of tensors)."""

    def __init__(self, fn, bases):
        self.inputs = [b.clone() for b in bases]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)
        except Exception as exc:
            raise RuntimeError(f"simulate: CUDA graph capture of a diff pass "
                               f"failed ({exc})") from exc
        GRAPH_COUNTS["captures"] += 1

    def __call__(self, *bases):
        for dst, src in zip(self.inputs, bases):
            dst.copy_(src)
        self.graph.replay()
        GRAPH_COUNTS["replays"] += 1
        return tuple(o.clone() for o in self.outputs)


def _graph_passes(njac, nhess):
    """Whether the chunked passes replay CUDA graphs: on the card, when a
    stage has two or more passes of one shape."""
    return config.device().type == "cuda" and (njac > 1 or nhess > 1)


def _run_passes(fn, chunks, graphs, cut):
    """``fn(*chunk)`` for every chunk (a tuple of tangent bases, each
    (c, nvars)).  With `graphs`, the chunks' rows are padded to the first
    chunk's with zero tangents, one captured pass replays them all, and
    ``cut(outputs, rows)`` trims a padded chunk's outputs back to its
    rows."""
    if not graphs:
        return [fn(*ch) for ch in chunks]
    full = [b.shape[0] for b in chunks[0]]
    graph, out = None, []
    for ch in chunks:
        rows = [b.shape[0] for b in ch]
        padded = [torch.cat([b, b.new_zeros((n - b.shape[0],) + b.shape[1:])])
                  if b.shape[0] < n else b for b, n in zip(ch, full)]
        if graph is None:
            graph = _PassGraph(fn, padded)
        res = graph(*padded)
        out.append(res if rows == full else cut(res, rows))
    return out


def simulate_diff(sequence, probes, sm, *, max_nstate=None,
                  jacobian_chunk: Optional[int] = None):
    """Run simulate with Jacobian/Hessian probes by forward-mode autodiff.

    Tangents are seeded on an epsilon vector with one slot per tracked
    variable and pushed through the eager operator loop with
    ``torch.func.jvp``, ``jacobian_chunk`` columns at a time (all at once
    by default) under ``torch.func.vmap``.  Hessians differentiate the
    *restricted* tangent sets vars1 x vars2 of the Hessian probes (not all
    pairs: what keeps an 800-variable MRF Hessian tractable), a jvp of the
    jvp, in ``jacobian_chunk`` x ``jacobian_chunk`` blocks.

    Args:
        sequence: flat op list (with order1/order2 specs attached).
        probes: tuple of probe objects (plain probes, Jacobians, Hessians).
        sm: initial StateMatrix, broadcast to the sequence's batch shape.
        max_nstate: ladder cap of the operator loop.
        jacobian_chunk: max tangent columns pushed at once (None = all).

    Returns a tuple over probes of tensors with the ADC axis leading:
    plain probes (N, *batch), Jacobians (N, *batch, len(variables)),
    Hessians (N, *batch, len(variables1), len(variables2)).
    """
    from .engine import _device_op, simulate_simple
    from .ops.probe import Adc

    variables = tracked_variables(sequence)
    nvars = len(variables)
    var_idx = {v: i for i, v in enumerate(variables)}
    for pb in probes:
        if isinstance(pb, Jacobian):
            _check_tracked(pb.variables, var_idx, "Jacobian")
        elif isinstance(pb, Hessian):
            _check_tracked(pb.variables1 + pb.variables2, var_idx, "Hessian")

    hess_probes = [pb for pb in probes if isinstance(pb, Hessian)]
    vars1 = list(dict.fromkeys(v for pb in hess_probes for v in pb.variables1
                               if v != "magnitude"))
    vars2 = list(dict.fromkeys(v for pb in hess_probes for v in pb.variables2
                               if v != "magnitude"))
    need_hessian = bool(vars1) and bool(vars2)

    diff_types = (Jacobian, Hessian)
    attrs = list(dict.fromkeys(pb.probe_attr for pb in probes
                               if isinstance(pb, diff_types)))
    regular = [pb for pb in probes if not isinstance(pb, diff_types)]
    eval_probes = regular + [Adc(attr=a, name=f"_d_{a}") for a in attrs]

    def run(eps_vec):
        eps = {var: eps_vec[i] for i, var in enumerate(variables)}
        memo, seq2 = {}, []
        for op in sequence:
            sub = memo.get(id(op))
            if sub is None:
                sub = memo[id(op)] = substitute(op, eps)
            seq2.append(sub)
        acquired, _ = simulate_simple(sm, seq2, probes=eval_probes,
                                      max_nstate=max_nstate)
        return tuple(torch.stack([v[i] for v in acquired])
                     for i in range(len(eval_probes)))

    zero = torch.zeros((nvars,), dtype=config.real_dtype(),
                       device=config.device())
    basis = torch.eye(max(nvars, 1), dtype=zero.dtype, device=zero.device)
    # the Jacobian columns the outputs read; a Hessian pass also pushes
    # the first-order tangents of its vars1 and vars2 columns, so only the
    # others take Jacobian passes
    needed = set()
    for pb in probes:
        if isinstance(pb, Jacobian):
            needed.update(pb.variables)
        elif isinstance(pb, Hessian):
            if "magnitude" in pb.variables1:
                needed.update(pb.variables2)
            if "magnitude" in pb.variables2:
                needed.update(pb.variables1)
    covered = set(vars1) | set(vars2) if need_hessian else set()
    jac_vars = [v for v in variables if v in needed and v not in covered]
    chunk = max(len(jac_vars), 1) if not jacobian_chunk \
        else int(jacobian_chunk)
    BJ = basis[[var_idx[v] for v in jac_vars]]
    jac_chunks = [(BJ[i:i + chunk],) for i in range(0, len(jac_vars), chunk)]
    B1 = basis[[var_idx[v] for v in vars1]]
    B2 = basis[[var_idx[v] for v in vars2]]
    c1 = len(vars1) if not jacobian_chunk else int(jacobian_chunk)
    c2 = len(vars2) if not jacobian_chunk else int(jacobian_chunk)
    hess_chunks = [(B1[i:i + c1], B2[j:j + c2])
                   for i in range(0, len(vars1), c1)
                   for j in range(0, len(vars2), c2)] if need_hessian else []
    graphs = _graph_passes(len(jac_chunks), len(hess_chunks))
    if graphs:
        moved = {}
        for op in sequence:
            if id(op) not in moved:
                moved[id(op)] = _on_device(op)
        sequence = [moved[id(op)] for op in sequence]
        eval_probes = ([_device_op(pb) for pb in regular]
                       + eval_probes[len(regular):])
    # the primal pass (also the warm-up of any capture below: lazy
    # library loads and memoized constants happen outside the graph)
    value = run(zero)
    nout = len(eval_probes)
    cols = [{} for _ in range(nout)]       # per output: var -> column

    def d1(x, u):
        return torch.func.jvp(run, (x,), (u,))[1]

    def put(names, tangents):
        for k in range(nout):
            for n, var in enumerate(names):
                cols[k][var] = tangents[k][n]

    if jac_chunks:
        parts = _run_passes(
            lambda b: torch.func.vmap(lambda u: d1(zero, u))(b),
            jac_chunks, graphs and len(jac_chunks) > 1,
            lambda res, rows: tuple(r[:rows[0]] for r in res))
        for i, part in zip(range(0, len(jac_vars), chunk), parts):
            put(jac_vars[i:i + chunk], part)

    hess = None
    if need_hessian:
        def d2(u, w):
            # the jvp along w of (run, its jvp along u): shared variables
            # get both tangents; returns (J u, J w, d2/du dw) at eps = 0
            (_, ju), (jw, h) = torch.func.jvp(
                lambda x: torch.func.jvp(run, (x,), (u,)), (zero,), (w,))
            return ju, jw, h

        def block(bu, bw):
            # inner vmap over vars2 tangents, outer over vars1: H leaves
            # (c1, c2, N, ...); J u does not vary along w, nor J w along u
            ju, jw, h = torch.func.vmap(lambda u: torch.func.vmap(
                lambda w: d2(u, w))(bw))(bu)
            return (tuple(t[:, 0] for t in ju) + tuple(t[0] for t in jw)
                    + tuple(h))

        def cut(res, rows):
            return (tuple(r[:rows[0]] for r in res[:nout])
                    + tuple(r[:rows[1]] for r in res[nout:2 * nout])
                    + tuple(r[:rows[0], :rows[1]] for r in res[2 * nout:]))

        blocks = _run_passes(block, hess_chunks,
                             graphs and len(hess_chunks) > 1, cut)
        nj = -(-len(vars2) // c2)
        rows = []
        for bi, i in enumerate(range(0, len(vars1), c1)):
            row = blocks[bi * nj:(bi + 1) * nj]
            put(vars1[i:i + c1], row[0][:nout])
            for j, blk in zip(range(0, len(vars2), c2), row):
                put(vars2[j:j + c2], blk[nout:2 * nout])
            rows.append(tuple(torch.cat([b[2 * nout + k] for b in row],
                                        dim=1) for k in range(nout)))
        hess = tuple(torch.cat([r[k] for r in rows]).movedim(0, -1)
                     .movedim(0, -1) for k in range(nout))

    row1 = {v: k for k, v in enumerate(vars1)}
    col2 = {v: k for k, v in enumerate(vars2)}
    out = []
    for pb in probes:
        if isinstance(pb, Jacobian):
            k = len(regular) + attrs.index(pb.probe_attr)
            out.append(torch.stack([value[k] if var == "magnitude"
                                    else cols[k][var]
                                    for var in pb.variables], dim=-1))
        elif isinstance(pb, Hessian):
            k = len(regular) + attrs.index(pb.probe_attr)
            rows_out = []
            for v1 in pb.variables1:
                row = []
                for v2 in pb.variables2:
                    if v1 == "magnitude" and v2 == "magnitude":
                        row.append(torch.zeros_like(value[k]))
                    elif v1 == "magnitude":
                        row.append(cols[k][v2])
                    elif v2 == "magnitude":
                        row.append(cols[k][v1])
                    elif v1 in row1 and v2 in col2:
                        row.append(hess[k][..., row1[v1], col2[v2]])
                    else:
                        raise ValueError(
                            f"Hessian pair ({v1!r}, {v2!r}) is outside the "
                            f"computed block ({sorted(row1)} x "
                            f"{sorted(col2)})")
                rows_out.append(torch.stack(row, dim=-1))
            out.append(torch.stack(rows_out, dim=-2))
        else:
            out.append(value[regular.index(pb)])
    return tuple(out)


def _check_tracked(names, var_idx, kind):
    """A probe variable that no operator tracks raises: a zero column
    would silently poison downstream CRLB / Gauss-Newton fits (the
    reference raises KeyError)."""
    for var in names:
        if var != "magnitude" and var not in var_idx:
            raise ValueError(
                f"{kind} probe variable {var!r} is not tracked by any "
                f"operator (tracked: {sorted(var_idx)})")
