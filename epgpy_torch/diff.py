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
* the forward pass is the planner's (JAX ``engine.py:1137-1156``): the
  train substituted at eps = 0 with a value-signature memo (equal ops
  per TR stay one scan constant, per-TR aliases stack) and planned by
  ``engine._plan_and_payload``; tangents are planes on a batch axis of
  the state (the primal, the chunk's directions, a Hessian block's mixed
  planes), each tracked slot's coefficients and their derivatives are
  taken once over the whole repetition axis, and every step is plain
  tensor ops (:func:`simulate_diff`);
* chunks of ``jacobian_chunk`` columns (Hessian blocks of vars1 x
  vars2) share one program, the last padded with zero directions; the
  program is cached across calls and, on the card, captured as one CUDA
  graph per stage and replayed per chunk, as JAX compiles its chunk
  program once;
* :func:`simulate_diff_eager` keeps the plain form -- ``torch.func.jvp``
  through the eager loop ``engine.simulate_simple`` -- as the oracle.

Outputs match the reference probes: Jacobian -> (nADC, ..., nvars),
Hessian -> (nADC, ..., n1, n2); the pseudo-variable "magnitude" maps to
the signal itself / its first derivatives (reference epgpy/diff.py:384-476).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import logging
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import config
from .ops import base, diffusion, probe as probe_mod, shiftnd
from .ops import shift as shift_mod

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


# -- the planned diff path --

#: CUDA graphs of the chunk programs: captured and replayed (diagnostics)
GRAPH_COUNTS = {"captures": 0, "replays": 0}
#: planned diff programs built (a cache miss plans) and reused
PROGRAM_COUNTS = {"plans": 0, "hits": 0}


def _subst_key(op):
    """A hashable value signature of `op` for the substitution memo (JAX
    ``diff._subst_key``): the class and every attribute by value, a
    CombinedOp by its constituents' signatures.  A train that builds one
    fresh-but-equal op per TR then substitutes ONE object, which the
    planner hoists as a scan constant (``engine._slot_invariant`` compares
    tensors by identity).  Host arrays enter by shape, dtype and a sample
    of their values (ops whose keys match are compared whole:
    :func:`_same_op`).  None (no memo) for an op holding tensors."""
    parts = []
    for name, value in sorted(vars(op).items()):
        if isinstance(value, torch.Tensor):
            return None
        if name == "ops":
            subs = tuple(_subst_key(o) for o in value)
            if any(s is None for s in subs):
                return None
            parts.append((name, subs))
        else:
            parts.append((name, _sampled(value)))
    return (type(op), tuple(parts))


def _sampled(v):
    """:func:`base._freeze` with host arrays by shape, dtype and at most
    64 sampled values."""
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, v.dtype.str,
                v.flat[::max(1, v.size // 64)].tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_sampled(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((str(k), _sampled(x)) for k, x in v.items()))
    return base._freeze(v)


def _same_value(a, b):
    """Whether two attribute values are equal (host arrays whole)."""
    if a is b:
        return True
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.shape == b.shape and a.dtype == b.dtype):
            return False
        return bool(np.array_equal(a, b))
    if isinstance(a, base.Operator) and isinstance(b, base.Operator):
        return _same_op(a, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_value(a[k], b[k])
                                            for k in a)
    return base._freeze(a) == base._freeze(b)


def _same_op(a, b):
    """Whether two ops of one signature key are equal attribute by
    attribute."""
    va, vb = vars(a), vars(b)
    return (type(a) is type(b) and va.keys() == vb.keys()
            and all(_same_value(va[k], vb[k]) for k in va))


def _substituted(sequence, variables):
    """The sequence with every tracked op substituted at eps = 0 (zero
    tensors): value-identical ops map to one substituted object, distinct
    tracked ops to distinct ones, untracked ops stay as they are -- the
    list JAX's planner sees inside ``simulate_diff``."""
    eps = {v: torch.zeros((), dtype=config.real_dtype(),
                          device=config.device()) for v in variables}
    by_id, by_value, out = {}, {}, []
    for op in sequence:
        if not getattr(op, "order1", None):
            out.append(op)
            continue
        sub = by_id.get(id(op))
        if sub is None:
            key = _subst_key(op)
            bucket = by_value.setdefault(key, []) if key is not None else []
            sub = next((s for o, s in bucket if _same_op(o, op)), None)
            if sub is None:
                sub = substitute(op, eps)
                bucket.append((op, sub))
            by_id[id(op)] = sub
        out.append(sub)
    return out


def _host(c):
    """A derivative coefficient as a host array."""
    if isinstance(c, torch.Tensor):
        return c.detach().cpu().numpy()
    return np.asarray(c)


def _leaf_derivatives(op, var_idx):
    """The eps derivatives of each of `op`'s leaves (``op.leaves()``
    order): per leaf ``(g1, h)``, g1 ``{a: coefficient}`` the first
    derivative along eps_a, h ``{(a, b): coefficient}`` (a <= b) the
    second along eps_a eps_b -- the substitution is a polynomial of degree
    two in eps, so these are its only terms.  A ScalarOp/MatrixOp with
    derivative arrays moves its coefficient leaves (``arr``/``mat`` and
    their recovery terms) by them; a CombinedOp lists its constituents'
    leaves."""
    from .ops.combined import CombinedOp

    if isinstance(op, CombinedOp):
        return [x for sub in op.ops for x in _leaf_derivatives(sub, var_idx)]
    out = [({}, {}) for _ in op.PARAMS]
    order1, order2 = op.order1 or {}, op.order2 or {}

    def add(d, key, val):
        d[key] = val if key not in d else d[key] + val

    def pair(v, w):
        a, b = var_idx[v], var_idx[w]
        return (min(a, b), max(a, b))

    darrs = getattr(op, "diff_arrays", None)
    if darrs is None:
        for v, cfs in order1.items():
            for p, c in cfs.items():
                add(out[op.PARAMS.index(p)][0], var_idx[v], _host(c))
        for (v, w), cfs in order2.items():
            for p, c in cfs.items():
                add(out[op.PARAMS.index(p)][1], pair(v, w), _host(c))
        return out
    # leaves 0 and 1 are the coefficients and their recovery terms
    d1, d2 = darrs.get("d1", {}), darrs.get("d2", {})
    lin = {}                             # param -> {var: d param / d eps}
    for v, cfs in order1.items():
        for p, c in cfs.items():
            lin.setdefault(p, {})[v] = _host(c)

    def put(k, arrays, coeff):
        for leaf, arr in zip(out, arrays):
            if arr is not None:
                add(leaf[k[0]], k[1], coeff * _host(arr))

    for p, (d, d0) in d1.items():
        for v, c in lin.get(p, {}).items():
            put((0, var_idx[v]), (d, d0), c)
    for (v, w), cfs in order2.items():
        for p, c in cfs.items():
            if p in d1:
                put((1, pair(v, w)), d1[p], _host(c))
    for (p1, p2), (d, d0) in d2.items():
        s = 0.5 if p1 == p2 else 1.0
        for v, cv in lin.get(p1, {}).items():
            for w, cw in lin.get(p2, {}).items():
                # s lin_p1 lin_p2 adds s a_p1v a_p2w (twice on the diagonal)
                put((1, pair(v, w)), (d, d0),
                    (2.0 if v == w else 1.0) * s * cv * cw)
    return out


def _form(op):
    """How a tracked op's coefficients act on the state planes: "diag"
    (ScalarOp, E/P/R, Phi, a diagonal CombinedOp), "mat" (T, MatrixOp, a
    CombinedOp), "xchg" (X's mixing matrix), "D" (the diffusivity; the
    attenuation depends on the step's wavenumbers)."""
    from .ops.exchange import X

    if isinstance(op, diffusion.D):
        return "D"
    if isinstance(op, X):
        return "xchg"
    if getattr(op, "diagonal", False) and hasattr(op, "coefficients"):
        return "diag"
    if hasattr(op, "matrices"):
        return "mat"
    raise NotImplementedError(
        f"simulate: no derivative form for {type(op).__name__}")


def _coefficients(form, op):
    """The tensors a tracked op of `form` applies (None entries kept)."""
    if form == "diag":
        return tuple(op.coefficients())
    if form == "mat":
        return tuple(op.matrices())
    if form == "xchg":
        from .ops.exchange import exchange_operator
        return (exchange_operator(op.tau, op.khi, axis=op.axis, T1=op.T1,
                                  T2=op.T2, g=op.g),)
    return (diffusion._real(op.Dcoef),)


def _planar(c, nb, core, stacked):
    """A coefficient tensor ``(L, [r], *cb, *core)`` (L planes, r
    repetitions) laid out against the planar state: ``([r], *cb, 1..., L,
    *core)`` with its batch axes padded to `nb` and the plane axis after
    them."""
    s = 1 if stacked else 0
    ncb = c.ndim - 1 - s - core
    if ncb > nb:
        raise ValueError(f"coefficient batch {tuple(c.shape)} exceeds the "
                         f"state's {nb} batch axes")
    c = c.reshape(c.shape[:1 + s + ncb] + (1,) * (nb - ncb)
                  + c.shape[1 + s + ncb:])
    return torch.movedim(c, 0, s + nb)


class _Layout:
    """The planes of a chunk program: the primal, n1 first-order planes
    (the Jacobian chunk's directions, or a Hessian block's vars1 rows),
    n2 more (the block's vars2 columns) and the n1 x n2 mixed planes,
    i-major."""

    def __init__(self, n1, n2):
        self.n1, self.n2 = n1, n2
        self.nd, self.nmix = n1 + n2, n1 * n2
        self.P = 1 + self.nd + self.nmix
        dev = config.device()
        self.pairs = [(i, j) for i in range(n1) for j in range(n2)]
        self.ii = torch.as_tensor([i for i, _ in self.pairs],
                                  dtype=torch.long, device=dev)
        self.jj = torch.as_tensor([j for _, j in self.pairs],
                                  dtype=torch.long, device=dev)
        mask = torch.zeros((self.P, 1, 1), dtype=config.real_dtype(),
                           device=dev)
        mask[0] = 1.0
        self.primal_mask = mask


class _TrackedSlot:
    """A planned slot whose ops track variables: its coefficient form, the
    leaves at eps = 0 (stacked over the repetitions of a block's stacked
    slot) and, per tracked leaf, the dense derivative tables over the
    variables and pairs that touch it."""

    def __init__(self, ops2, origs, var_idx, stacked, nb):
        from .engine import _device_leaf, _stack_leaves

        self.stacked, self.nb = stacked, nb
        self.template = ops2[0].strip_meta()
        self.form = _form(self.template)
        self.axis = getattr(self.template, "axis", None)
        if stacked:
            leaves = _stack_leaves(ops2)
        else:
            leaves = [_device_leaf(x, dt) for x, dt in zip(
                self.template.leaves(), self.template.leaf_dtypes())]
        if self.form == "xchg":
            # X's absent T1/T2/g as the device values exchange_operator
            # defaults them to (a capture copies nothing from the host)
            for i, name in enumerate(self.template.PARAMS):
                if leaves[i] is None and name in ("T1", "T2", "g"):
                    leaves[i] = torch.full(
                        (len(ops2),) if stacked else (),
                        0.0 if name == "g" else math.inf,
                        dtype=config.real_dtype(), device=config.device())
        self.leaves = leaves
        # per-repetition coefficients where a repetition axis cannot lead
        # (pinned axes, the exchange's compartment axis)
        self.per_rep = stacked and (
            self.form == "xchg" or getattr(self.template, "axes", None)
            is not None or any(getattr(o, "axes", None) is not None
                               for o in getattr(self.template, "ops", ())))
        specs = [_leaf_derivatives(o, var_idx)
                 for o in (origs if stacked else origs[:1])]
        self.tracked = []                # (leaf index, vars, G1, pairs, H)
        for i, leaf in enumerate(leaves):
            g1keys = sorted({a for sp in specs for a in sp[i][0]})
            hkeys = sorted({ab for sp in specs for ab in sp[i][1]})
            if not g1keys and not hkeys:
                continue
            shape = tuple(leaf.shape)
            dtype = leaf.dtype

            def table(keys, which):
                arr = np.zeros((len(keys),) + shape,
                               dtype=np.complex128 if dtype.is_complex
                               else np.float64)
                col = {k: n for n, k in enumerate(keys)}
                for k, sp in enumerate(specs):
                    for key, c in sp[i][which].items():
                        if stacked:
                            arr[col[key], k] = np.broadcast_to(c, shape[1:])
                        else:
                            arr[col[key]] = np.broadcast_to(c, shape)
                return torch.as_tensor(arr, dtype=dtype,
                                       device=config.device())

            self.tracked.append((
                i, torch.as_tensor(g1keys, dtype=torch.long,
                                   device=config.device()),
                table(g1keys, 0), hkeys and torch.as_tensor(
                    hkeys, dtype=torch.long, device=config.device()),
                table(hkeys, 1) if hkeys else None))
        core = {"diag": 1, "mat": 2}.get(self.form)
        self.core = core
        self.none = None

    def _g(self, *tracked):
        """The slot's coefficients as a function of its tracked leaves."""
        leaves = list(self.leaves)
        for (i, *_), x in zip(self.tracked, tracked):
            leaves[i] = x
        if self.per_rep:
            reps = leaves[self.tracked[0][0]].shape[0]
            outs = [_coefficients(self.form, self.template.with_leaves(
                [None if x is None else x[k] for x in leaves]))
                for k in range(reps)]
            coeffs = tuple(None if o[0] is None else torch.stack(list(o))
                           for o in zip(*outs))
        else:
            coeffs = _coefficients(self.form,
                                   self.template.with_leaves(leaves))
        self.none = tuple(c is None for c in coeffs)
        return tuple(c for c in coeffs if c is not None)

    def derivatives(self, lay, dirs, U1, U2):
        """The slot's coefficients and their derivatives along the chunk's
        directions, computed once over the whole repetition axis (the
        slot's coefficient function through ``torch.func``, in float64;
        the step loop then runs plain tensor ops): (C, dC, dCu, dCw, d2C),
        each a tuple over the form's tensors in the working precision,
        laid out against the planar state for the diagonal and matrix
        forms."""
        cdt, rdt = config.complex_dtype(), config.real_dtype()
        with _float64():
            C, dC, d2C = self._derivatives(lay, dirs, U1, U2)

        def narrow(ts):
            return ts and tuple(x.to(cdt if x.is_complex() else rdt)
                                for x in ts)

        return self._layout(lay, narrow(C), narrow(dC), narrow(d2C))

    def _derivatives(self, lay, dirs, U1, U2):
        L0 = tuple(_wide(self.leaves[i]) for i, *_ in self.tracked)
        G1s = [_wide(G1) for _, _, G1, _, _ in self.tracked]
        dL = tuple(torch.einsum("dm,m...->d...",
                                _wide(dirs[:, vi]).to(G.dtype), G)
                   for (_, vi, _, _, _), G in zip(self.tracked, G1s))
        C = self._g(*L0)
        dC = d2C = None
        if lay.nd:
            dC = torch.func.vmap(
                lambda *t: torch.func.jvp(self._g, L0, t)[1])(*dL)
        if lay.nmix:
            ii, jj = lay.ii, lay.jj
            d2L = []
            for (_, _, _, pairs, H), dl in zip(self.tracked, dL):
                if H is None:
                    d2L.append(torch.zeros((lay.nmix,) + dl.shape[1:],
                                           dtype=dl.dtype, device=dl.device))
                    continue
                a, b = pairs[:, 0], pairs[:, 1]
                u, w = U1[ii], U2[jj]
                K = u[:, a] * w[:, b] + (a != b) * u[:, b] * w[:, a]
                H = _wide(H)
                d2L.append(torch.einsum("nq,q...->n...", _wide(K).to(H.dtype),
                                        H))
            du = tuple(x[ii] for x in dL)
            dw = tuple(x[lay.n1 + jj] for x in dL)
            n = len(L0)

            def second(*t):
                tu, tw, t2 = t[:n], t[n:2 * n], t[2 * n:]
                inner = lambda *x: torch.func.jvp(self._g, x, tu)[1]  # noqa
                h = torch.func.jvp(inner, L0, tw)[1]
                h2 = torch.func.jvp(self._g, L0, t2)[1]
                return tuple(p + q for p, q in zip(h, h2))

            d2C = torch.func.vmap(second)(*du, *dw, *d2L)
        return C, dC, d2C

    def _layout(self, lay, C, dC, d2C):
        """The step's layout: the diagonal and matrix forms' tensors laid
        out against the planar state (:func:`_planar`), the others with
        their planes after the repetition axis; the mixed planes' u and w
        derivatives gathered."""
        def full(ts):
            it = iter(ts)
            return tuple(None if gap else next(it) for gap in self.none)

        C, dC, d2C = full(C), dC and full(dC), d2C and full(d2C)
        s = 1 if self.stacked else 0
        if self.core is None:
            def move(x):
                return x.movedim(0, s)
            ax = s
        else:
            def move(x):
                return _planar(x, self.nb, self.core, self.stacked)
            C = tuple(None if x is None else move(x[None]) for x in C)
            ax = s + self.nb
        dC, d2C = (ts and tuple(None if x is None else move(x) for x in ts)
                   for ts in (dC, d2C))
        dCu = dCw = None
        if dC is not None and lay.nmix:
            dCu = tuple(None if x is None else x.index_select(ax, lay.ii)
                        for x in dC)
            dCw = tuple(None if x is None else x.index_select(
                ax, lay.n1 + lay.jj) for x in dC)
        return C, dC, dCu, dCw, d2C


@contextlib.contextmanager
def _float64():
    """The working precision float64 inside the block: a slot's
    coefficient derivatives are taken in float64 (forward-mode AD of a
    product with a Python complex scalar returns a complex128 tangent of a
    complex64 primal, which later products reject)."""
    old = config.precision()
    config.set_precision("float64")
    try:
        yield
    finally:
        config.set_precision(old)


def _wide(x):
    """A tensor in float64 / complex128."""
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def _rep(ts, k):
    """The repetition k of a stacked slot's coefficient tuple."""
    if ts is None or k is None:
        return ts
    return tuple(None if x is None else x[k] for x in ts)


def _lin(form, c, X, EQ=None):
    """c applied to the planes X (and c's recovery term to EQ): the part
    of a diagonal or matrix op that is linear in its coefficients."""
    from .ops.matrixop import _matvec_states

    a, a0 = c
    if form == "diag":
        out = X * a[..., None, :]
        if a0 is not None and EQ is not None:
            out = torch.addcmul(out, a0[..., None, :], EQ)
        return out
    out = _matvec_states(a, X)
    if a0 is not None and EQ is not None:
        out = out + _matvec_states(a0, EQ)
    return out


def _step_coeffs(slot, sm, coefs, k, lay):
    """A tracked diagonal / matrix step on the planes:

        Y_0  = A X_0 + b,        Y_u = A X_u + dA_u X_0 + db_u,
        Y_uw = A X_uw + dA_u X_w + dA_w X_u + d2A_uw X_0 + d2b_uw

    (the recovery terms read the equilibrium, which has no tangents)."""
    C, dC, dCu, dCw, d2C = (_rep(t, k) for t in coefs)
    X, EQ = sm.states, sm.equilibrium
    Y = _lin(slot.form, C, X, EQ)
    if lay.nd:
        X0, E0 = X[..., :1, :, :], EQ[..., :1, :, :]
        Y[..., 1:1 + lay.nd, :, :] += _lin(slot.form, dC, X0, E0)
        if lay.nmix:
            Xu = X[..., 1:1 + lay.n1, :, :].index_select(-3, lay.ii)
            Xw = X[..., 1 + lay.n1:1 + lay.nd, :, :].index_select(-3, lay.jj)
            Y[..., 1 + lay.nd:, :, :] += (
                _lin(slot.form, dCu, Xw) + _lin(slot.form, dCw, Xu)
                + _lin(slot.form, d2C, X0, E0))
    return sm.update(states=Y)


def _bmatrices(op, sm0):
    """D's b-matrices (bL, bT) on the planar state: those of the primal
    view `sm0` (the wavenumbers are every plane's), with the plane axis
    (of 1) before the state axis."""
    return tuple(b.unsqueeze(-4) for b in op._bmatrices(sm0))


def _step_diffusion(slot, sm, coefs, k, lay, sm0):
    """A tracked D step: the attenuation exp(-s(D)) with s linear in the
    diffusivity, so its derivatives are -s(dD) exp(-s(D)) and
    (s(dD_u) s(dD_w) - s(d2D_uw)) exp(-s(D))."""
    C, dC, dCu, dCw, d2C = (_rep(t, k) for t in coefs)
    op = slot.template.with_leaves(
        slot.leaves if k is None else [None if x is None else x[k]
                                       for x in slot.leaves])
    bL, bT = _bmatrices(op, sm0)
    sL, sT = diffusion.diffusion_exponents(bL, bT, C[0])
    DL, DT = torch.exp(-sL), torch.exp(-sT)
    X = sm.states
    Fp, Z = X[..., 0] * DT.to(X.dtype), X[..., 2] * DL.to(X.dtype)

    def expo(ts):
        # per plane exponents, stacked on the plane axis (-2)
        pairs = [diffusion.diffusion_exponents(bL, bT, t)
                 for t in ts[0]]
        return (torch.cat([p[0] for p in pairs], dim=-2),
                torch.cat([p[1] for p in pairs], dim=-2))

    if lay.nd:
        X0 = X[..., :1, :, :]
        dsL, dsT = expo(dC)
        Fp[..., 1:1 + lay.nd, :] -= (dsT * DT).to(X.dtype) * X0[..., 0]
        Z[..., 1:1 + lay.nd, :] -= (dsL * DL).to(X.dtype) * X0[..., 2]
        if lay.nmix:
            Xu = X[..., 1:1 + lay.n1, :, :].index_select(-3, lay.ii)
            Xw = X[..., 1 + lay.n1:1 + lay.nd, :, :].index_select(-3, lay.jj)
            s2L, s2T = expo(d2C)
            uL, uT = dsL.index_select(-2, lay.ii), dsT.index_select(-2,
                                                                    lay.ii)
            wL, wT = (dsL.index_select(-2, lay.n1 + lay.jj),
                      dsT.index_select(-2, lay.n1 + lay.jj))
            for out, c, s_u, s_w, s2, D in ((Fp, 0, uT, wT, s2T, DT),
                                            (Z, 2, uL, wL, s2L, DL)):
                out[..., 1 + lay.nd:, :] += (
                    -(s_u * D).to(X.dtype) * Xw[..., c]
                    - (s_w * D).to(X.dtype) * Xu[..., c]
                    + ((s_u * s_w - s2) * D).to(X.dtype) * X0[..., c])
    Fm = torch.conj(torch.flip(Fp, dims=(-1,)))
    return sm.update(states=torch.stack([Fp, Fm, Z], dim=-1))


def _step_exchange(slot, sm, coefs, k, lay, sm0):
    """A tracked X step: the mixing matrix M on every plane, then dM_u
    (X_0 - eq) on the first-order planes and dM_u X_w + dM_w X_u + d2M_uw
    (X_0 - eq) on the mixed ones, one plane at a time."""
    from .ops.exchange import _apply_exchange

    C, dC, dCu, dCw, d2C = (_rep(t, k) for t in coefs)
    ax = slot.axis
    out = _apply_exchange(sm, C[0].to(sm.states.dtype), ax)
    Y = out.states
    if not lay.nd:
        return out
    zero = torch.zeros_like(sm0.equilibrium)

    def lin(M, states, eq):
        return _apply_exchange(sm0.update(states=states, equilibrium=eq),
                               M.to(sm.states.dtype), ax, linear=True)

    X = sm.states
    Y[..., 1:1 + lay.nd, :, :] += torch.stack(
        [lin(M, sm0.states, sm0.equilibrium) for M in dC[0]], dim=-3)
    if lay.nmix:
        mixed = []
        for n, (i, j) in enumerate(lay.pairs):
            mixed.append(lin(dCu[0][n], X[..., 1 + lay.n1 + j, :, :], zero)
                         + lin(dCw[0][n], X[..., 1 + i, :, :], zero)
                         + lin(d2C[0][n], sm0.states, sm0.equilibrium))
        Y[..., 1 + lay.nd:, :, :] += torch.stack(mixed, dim=-3)
    return out


def _step_pd(op, sm, lay):
    """PD on the planes: the new equilibrium on the primal plane only (it
    has no tangents), the reset states likewise."""
    out = op(sm)
    eq = out.equilibrium * lay.primal_mask
    states = torch.broadcast_to(eq, out.states.shape) if op.reset \
        else out.states
    return out.update(states=states, equilibrium=eq)


class _DiffPlan:
    """The planned diff program of one (sequence, probes, state) call
    signature: the substituted train planned as the primal general path
    plans it (``engine._plan_and_payload``), each slot whose ops track
    variables replaced by a :class:`_TrackedSlot`.  :meth:`run` executes
    one chunk: the planar state (the primal and the tangent planes on a
    batch axis after the state's own) through the plan, every step plain
    tensor ops."""

    def __init__(self, sequence, variables, var_idx, regular, attrs, sm):
        from .engine import _device_op, _plan_and_payload, _tensor_bytes
        from .ops.base import PD

        seq2 = _substituted(sequence, variables)
        entry = _plan_and_payload(seq2, cache=False)
        self.nb = sm.ndim
        self.slots = []                  # tracked slots, in plan order
        self.segments = []
        pos = 0
        for kind, pl in zip(entry.kinds, entry.payload):
            if kind[0] == "unroll":
                items = []
                for n, op in enumerate(pl):
                    items.append(self._item(
                        ("const", op), [seq2[pos + n]], [sequence[pos + n]],
                        var_idx, PD))
                self.segments.append((kind, items, None))
                pos += len(pl)
                continue
            template, slots = pl
            p, r = len(template), kind[1]
            items = [self._item(slot, seq2[pos + j:pos + p * r:p],
                                sequence[pos + j:pos + p * r:p], var_idx, PD)
                     for j, slot in enumerate(slots)]
            probe_slots = {j for j, op in enumerate(template)
                           if isinstance(op, probe_mod.Probe)}
            self.segments.append((kind, items, probe_slots))
            pos += p * r
        # device copies: an Adc's phase is read inside a capture
        self.regular = tuple(_device_op(pb) for pb in regular)
        self.attrs = tuple(attrs)
        self.eval_probes = tuple(probe_mod.Adc(attr=a, name=f"_d_{a}")
                                 for a in attrs)
        # the state's fields other than its tensors (kvalue, tvalue,
        # system, options)
        self.sm = type(sm)._from_tensors(None, None, None, sm.kvalue,
                                         sm.tvalue, sm.system, sm.options)
        self.nbytes = _tensor_bytes(entry.payload) + sum(
            _tensor_bytes([s.leaves] + [t[2] for t in s.tracked]
                          + [t[4] for t in s.tracked if t[4] is not None])
            for s in self.slots)

    def _item(self, slot, ops2, origs, var_idx, PD):
        """A plan entry: ("op", op) applied as it is, ("stack", template,
        leaves), ("pd", op), ("stackpd", template, leaves) or ("tracked",
        index) of a tracked slot."""
        if any(getattr(o, "order1", None) for o in origs):
            stacked = any(o is not ops2[0] for o in ops2[1:])
            tracked = _TrackedSlot(ops2, origs, var_idx, stacked, self.nb)
            if tracked.tracked:
                self.slots.append(tracked)
                return ("tracked", len(self.slots) - 1)
        if slot[0] == "const":
            op = slot[1]
            return ("pd", op) if isinstance(op, PD) else ("op", op)
        if isinstance(slot[1], PD):
            return ("stackpd",) + slot[1:]
        return slot

    def _planes(self, lay, states, eq, coords):
        """The planar state: primal plane 0 (the initial state), zero
        tangent planes; the equilibrium likewise, the coordinate table
        shared (a plane axis of 1)."""
        nb, P = self.nb, lay.P

        def planar(x):
            x = x.reshape(x.shape[:-2] + (1,) * (nb - (x.ndim - 2))
                          + x.shape[-2:]).unsqueeze(-3)
            if P == 1:
                return x
            zeros = x.new_zeros(x.shape[:-3] + (P - 1,) + x.shape[-2:])
            return torch.cat([x, zeros], dim=-3)

        C = None if coords is None else coords.reshape(
            coords.shape[:-2] + (1,) * (nb - (coords.ndim - 2))
            + coords.shape[-2:]).unsqueeze(-3)
        return self.sm.update(states=planar(states), equilibrium=planar(eq),
                              coords=C)

    def run(self, lay, U1, U2, states, eq, coords, max_reps=None):
        """One chunk: returns (regular probe values, per diff attribute
        the (N, ..., P) planes of its readout).  ``max_reps`` runs at most
        that many repetitions of each block (the warm-up of a capture)."""
        from .engine import _acquire, _own, _stack_values

        dirs = U1 if U2 is None else torch.cat([U1, U2])
        coefs = [slot.derivatives(lay, dirs, U1, U2) for slot in self.slots]
        sm = self._planes(lay, states, eq, coords)
        nb = self.nb
        reg, dvals = [], [[] for _ in self.attrs]

        def view0(sm):
            return sm.update(
                states=sm.states[..., 0, :, :],
                equilibrium=sm.equilibrium[..., 0, :, :],
                coords=None if sm.coords is None
                else sm.coords[..., 0, :, :])

        def apply(op, sm):
            # the ops that read the plane axis get it here: a shift on a
            # coordinate table merges every plane as the primal one, D
            # attenuates every plane by the primal view's b-matrices
            if isinstance(op, shift_mod.S) and (op._kint is None
                                                or sm.coords is not None):
                return shiftnd.apply_shift(op, sm.expand(op.ndim),
                                           planes=lay.P)
            if isinstance(op, diffusion.D):
                return op._attenuate(sm, *_bmatrices(op, view0(sm)))
            return op(sm)

        def step(item, sm, k):
            tag = item[0]
            if tag == "op":
                return apply(item[1], sm)
            if tag in ("stack", "stackpd"):
                op = item[1].with_leaves(
                    [None if x is None else x[k] for x in item[2]])
                return apply(op, sm) if tag == "stack" \
                    else _step_pd(op, sm, lay)
            if tag == "pd":
                return _step_pd(item[1], sm, lay)
            slot = self.slots[item[1]]
            kk = k if slot.stacked else None
            if slot.form == "D":
                return _step_diffusion(slot, sm, coefs[item[1]], kk, lay,
                                       view0(sm))
            if slot.form == "xchg":
                return _step_exchange(slot, sm, coefs[item[1]], kk, lay,
                                      view0(sm))
            return _step_coeffs(slot, sm, coefs[item[1]], kk, lay)

        def acquire(op, sm):
            if self.regular:
                reg.append(_acquire(op, self.regular, view0(sm)))
            for vals, pb in zip(dvals, self.eval_probes):
                vals.append(_own(pb.acquire(sm, post=op.post)).movedim(
                    nb, -1))

        for kind, items, probe_slots in self.segments:
            if kind[0] == "unroll":
                for item in items:
                    sm = step(item, sm, None)
                    op = item[1] if item[0] != "tracked" else None
                    if isinstance(op, probe_mod.Probe):
                        acquire(op, sm)
                continue
            reps = kind[1] if max_reps is None else min(kind[1], max_reps)
            for k in range(reps):
                for j, item in enumerate(items):
                    sm = step(item, sm, k)
                    if j in probe_slots:
                        op = item[1] if item[0] == "op" else \
                            item[1].with_leaves([None if x is None else x[k]
                                                 for x in item[2]])
                        acquire(op, sm)
        regular = _stack_values(reg) if reg else ()
        return regular, tuple(torch.stack(v) for v in dvals)


def _clone(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(x) for x in tree)
    return tree.clone()


class _PassGraph:
    """One chunk program ``fn(*inputs)`` captured as a CUDA graph, after an
    eager warm-up of one repetition per block (``fn(..., max_reps=1)``)
    on a side stream, where lazy loading and memoized constants happen:
    each call copies its inputs (the chunk's directions and the initial
    state) into the static ones, replays, and clones the outputs out (a
    nested tuple of tensors).  A capture failure raises: there is no
    eager fallback.  ``nbytes``: the device memory the graph holds."""

    def __init__(self, fn, inputs):
        from .engine import _tensor_bytes

        self.inputs = [x.clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.inputs, max_reps=1)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)
        except Exception as exc:
            raise RuntimeError(f"simulate: CUDA graph capture of a diff "
                               f"chunk program failed ({exc}); a planned "
                               f"diff program does not fall back to eager "
                               f"execution") from exc
        self.nbytes = max(torch.cuda.memory_reserved() - before, 0) \
            + _tensor_bytes(self.inputs)
        GRAPH_COUNTS["captures"] += 1

    def __call__(self, *inputs):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        GRAPH_COUNTS["replays"] += 1
        return _clone(self.outputs)


def _graph_passes():
    """Whether the chunk programs replay CUDA graphs: on the card (a
    module function, so a test can force it)."""
    return config.device().type == "cuda"


class _DiffEntry:
    """A cached planned diff program: the pinned operators and probes, the
    plan, the stage layouts and their CUDA graphs, the device bytes held
    (counted against the plan cache's budget)."""

    __slots__ = ("ops", "probes", "plan", "layouts", "graphs", "nbytes")


def _stage_inputs(basis, names, var_idx, chunk):
    """The direction rows of a stage's chunks: one-hot rows of `names`,
    `chunk` at a time, the last chunk padded with zero rows to one shape
    (the padded columns are cropped from the outputs)."""
    rows = basis[[var_idx[v] for v in names]]
    out = []
    for i in range(0, len(names), chunk):
        part = rows[i:i + chunk]
        if part.shape[0] < chunk:
            part = torch.cat([part, part.new_zeros(
                (chunk - part.shape[0],) + part.shape[1:])])
        out.append(part)
    return out


def _run_stage(entry, stage, chunks, sm):
    """Every chunk of a stage through its program: on the card one CUDA
    graph per stage, captured on first use and replayed per chunk; eager
    on the CPU, and where a probe calls user code (logged, as the primal
    planner does: ``engine._host_work``)."""
    from . import engine

    plan, lay = entry.plan, entry.layouts[stage]
    coords = sm.coords
    state_in = [sm.states, sm.equilibrium] + ([] if coords is None
                                              else [coords])
    ndir = 1 if lay.n2 == 0 else 2

    def fn(*args, max_reps=None):
        dirs = list(args[:ndir]) + [None] * (2 - ndir)
        states, eq = args[ndir], args[ndir + 1]
        co = args[ndir + 2] if coords is not None else None
        return plan.run(lay, dirs[0], dirs[1], states, eq, co,
                        max_reps=max_reps)

    reason = engine._host_work(None, False, entry.probes, entry.ops)
    if reason is not None and sm.states.is_cuda:
        logging.getLogger(__name__).info(
            "simulate: planned diff program runs eagerly: %s", reason)
    if not _graph_passes() or reason is not None:
        return [fn(*ch, *state_in) for ch in chunks]
    graph = entry.graphs.get(stage)
    if graph is None:
        graph = _PassGraph(fn, list(chunks[0]) + state_in)
        entry.graphs[stage] = graph
        entry.nbytes += getattr(graph, "nbytes", 0)
        engine._evict(keep=next((k for k, e in engine._PLAN_CACHE.items()
                                 if e is entry), None))
    return [graph(*ch, *state_in) for ch in chunks]


def simulate_diff(sequence, probes, sm, *,
                  jacobian_chunk: Optional[int] = None):
    """Run simulate with Jacobian/Hessian probes through the planner (JAX
    ``diff.simulate_diff`` with ``engine._plan_and_payload`` /
    ``_execute_plan``).

    The tracked ops are substituted at eps = 0 with a value-signature memo
    (:func:`_substituted`) and the train is planned as the primal general
    path plans it.  Tangents are planes on a batch axis of the state: the
    primal, the chunk's first-order directions and, for a Hessian block,
    the mixed (u, w) planes.  Each tracked slot's coefficients and their
    derivatives along the chunk's directions are computed once over the
    whole repetition axis (``torch.func`` on the slot's coefficient
    function); the step loop is plain tensor ops (every op is affine in
    the state: ``Y_u = A X_u + dA_u X_0 (+ db_u)``; shifts, merges and
    probes act on every plane alike, a table merge weighted by the primal
    plane).  Jacobian columns go ``jacobian_chunk`` at a time (all at once
    by default), Hessians -- over the restricted sets vars1 x vars2 of
    the Hessian probes -- in ``jacobian_chunk`` x ``jacobian_chunk``
    blocks, the last chunk padded with zero directions so one program
    serves a stage.  Programs are cached across calls (keyed on the
    operator and probe ids, the variable sets, the chunk sizes, the state
    structure, device and precision; entries pin their ops and share the
    plan cache's budget); on the card each stage's program is one CUDA
    graph, captured once and replayed per chunk.

    Args:
        sequence: flat op list (with order1/order2 specs attached).
        probes: tuple of probe objects (plain probes, Jacobians, Hessians).
        sm: initial StateMatrix, broadcast to the sequence's batch shape.
        jacobian_chunk: max tangent columns pushed at once (None = all).

    Returns a tuple over probes of tensors with the ADC axis leading:
    plain probes (N, *batch), Jacobians (N, *batch, len(variables)),
    Hessians (N, *batch, len(variables1), len(variables2)).
    """
    from . import engine

    variables = tracked_variables(sequence)
    var_idx = {v: i for i, v in enumerate(variables)}
    jac_vars, vars1, vars2, attrs, regular = _diff_sets(probes, variables,
                                                        var_idx)
    need_hessian = bool(vars1) and bool(vars2)
    cj = min(int(jacobian_chunk), len(jac_vars)) if jacobian_chunk \
        else len(jac_vars)
    c1 = min(int(jacobian_chunk), len(vars1)) if jacobian_chunk \
        else len(vars1)
    c2 = min(int(jacobian_chunk), len(vars2)) if jacobian_chunk \
        else len(vars2)
    key = ("diff", tuple(id(op) for op in sequence),
           tuple(id(pb) for pb in probes), tuple(variables), tuple(jac_vars),
           tuple(vars1), tuple(vars2), cj, c1, c2,
           engine._graph_key(sm, None), str(config.device()),
           config.precision())
    entry = engine._PLAN_CACHE.get(key)
    if entry is None:
        PROGRAM_COUNTS["plans"] += 1
        entry = _DiffEntry()
        entry.ops, entry.probes = list(sequence), tuple(probes)
        entry.plan = _DiffPlan(sequence, variables, var_idx, regular, attrs,
                               sm)
        entry.layouts = {"jac": _Layout(cj, 0),
                         "hess": _Layout(c1, c2) if need_hessian else None,
                         "value": _Layout(0, 0)}
        entry.graphs = {}
        entry.nbytes = entry.plan.nbytes
        engine._PLAN_CACHE[key] = entry
        engine._evict(keep=key)
    else:
        PROGRAM_COUNTS["hits"] += 1

    basis = torch.eye(max(len(variables), 1), dtype=config.real_dtype(),
                      device=config.device())
    jac_runs = hess_runs = []
    if jac_vars:
        jac_chunks = [(u,) for u in _stage_inputs(basis, jac_vars, var_idx,
                                                  cj)]
        jac_runs = _run_stage(entry, "jac", jac_chunks, sm)
    if need_hessian:
        U1s = _stage_inputs(basis, vars1, var_idx, c1)
        U2s = _stage_inputs(basis, vars2, var_idx, c2)
        hess_runs = _run_stage(entry, "hess",
                               [(a, b) for a in U1s for b in U2s], sm)
    first = (jac_runs or hess_runs or _run_stage(entry, "value", [(
        basis[:0],)], sm))[0]
    regular_vals, planes = first
    value = [p[..., 0] for p in planes]
    cols = [{} for _ in attrs]           # per attribute: var -> column

    def put(k, names, part):
        for n, var in enumerate(names):
            cols[k][var] = part[..., n]

    for i, (_, pl) in zip(range(0, len(jac_vars), max(cj, 1)), jac_runs):
        for k, p in enumerate(pl):
            put(k, jac_vars[i:i + cj], p[..., 1:1 + cj])
    hess = None
    if need_hessian:
        lay = entry.layouts["hess"]
        nj = -(-len(vars2) // c2)
        rows = [[] for _ in attrs]
        for bi, i in enumerate(range(0, len(vars1), c1)):
            row = hess_runs[bi * nj:(bi + 1) * nj]
            names1 = vars1[i:i + c1]
            blocks = [[] for _ in attrs]
            for j, (_, pl) in zip(range(0, len(vars2), c2), row):
                names2 = vars2[j:j + c2]
                for k, p in enumerate(pl):
                    put(k, names1, p[..., 1:1 + c1])
                    put(k, names2, p[..., 1 + c1:1 + c1 + len(names2)])
                    mix = p[..., 1 + lay.nd:].reshape(p.shape[:-1]
                                                      + (c1, c2))
                    blocks[k].append(mix[..., :len(names1), :len(names2)])
            for k in range(len(attrs)):
                rows[k].append(torch.cat(blocks[k], dim=-1))
        hess = [torch.cat(r, dim=-2) for r in rows]
    return _assemble(probes, regular, attrs, regular_vals, value, cols, hess,
                     vars1, vars2)


def _diff_sets(probes, variables, var_idx):
    """(jac_vars, vars1, vars2, attrs, regular): the Jacobian columns the
    outputs read that no Hessian block pushes (a block also pushes its
    vars1 and vars2 columns), the Hessian's restricted variable sets, the
    state attributes the diff probes read and the plain probes."""
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
    return jac_vars, vars1, vars2, attrs, regular


def _assemble(probes, regular, attrs, regular_vals, value, cols, hess,
              vars1, vars2):
    """The outputs per probe: a Jacobian's columns (its "magnitude"
    column the signal), a Hessian's (v1, v2) entries (magnitude rows and
    columns from the Jacobian columns), the plain probes' values."""
    row1 = {v: k for k, v in enumerate(vars1)}
    col2 = {v: k for k, v in enumerate(vars2)}
    out = []
    for pb in probes:
        if isinstance(pb, Jacobian):
            k = attrs.index(pb.probe_attr)
            out.append(torch.stack([value[k] if var == "magnitude"
                                    else cols[k][var]
                                    for var in pb.variables], dim=-1))
        elif isinstance(pb, Hessian):
            k = attrs.index(pb.probe_attr)
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
            out.append(regular_vals[regular.index(pb)])
    return tuple(out)


def simulate_diff_eager(sequence, probes, sm, *, max_nstate=None,
                        jacobian_chunk: Optional[int] = None):
    """The plain eager form of :func:`simulate_diff` (the test oracle and
    the card's A/B baseline; nothing on ``simulate()``'s path calls it):
    ``torch.func.jvp`` pushes the tangent basis through the eager operator
    loop ``engine.simulate_simple``, batched by ``torch.func.vmap``,
    ``jacobian_chunk`` columns at a time; a Hessian is a jvp of that jvp
    over the restricted tangent sets vars1 x vars2, in ``jacobian_chunk``
    x ``jacobian_chunk`` blocks.  Same arguments (and ``max_nstate``, the
    loop's ladder cap) and outputs."""
    from .engine import simulate_simple

    variables = tracked_variables(sequence)
    nvars = len(variables)
    var_idx = {v: i for i, v in enumerate(variables)}
    jac_vars, vars1, vars2, attrs, regular = _diff_sets(probes, variables,
                                                        var_idx)
    need_hessian = bool(vars1) and bool(vars2)
    eval_probes = regular + [probe_mod.Adc(attr=a, name=f"_d_{a}")
                             for a in attrs]
    nreg = len(regular)

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
    value = run(zero)
    cols = [{} for _ in attrs]

    def put(names, tangents):
        for k in range(len(attrs)):
            for n, var in enumerate(names):
                cols[k][var] = tangents[nreg + k][n]

    chunk = max(len(jac_vars), 1) if not jacobian_chunk \
        else int(jacobian_chunk)
    BJ = basis[[var_idx[v] for v in jac_vars]]
    for i in range(0, len(jac_vars), chunk):
        put(jac_vars[i:i + chunk], torch.func.vmap(
            lambda u: torch.func.jvp(run, (zero,), (u,))[1])(
                BJ[i:i + chunk]))
    hess = None
    if need_hessian:
        B1 = basis[[var_idx[v] for v in vars1]]
        B2 = basis[[var_idx[v] for v in vars2]]
        c1 = len(vars1) if not jacobian_chunk else int(jacobian_chunk)
        c2 = len(vars2) if not jacobian_chunk else int(jacobian_chunk)

        def d2(u, w):
            (_, ju), (jw, h) = torch.func.jvp(
                lambda x: torch.func.jvp(run, (x,), (u,)), (zero,), (w,))
            return ju, jw, h

        rows = []
        for i in range(0, len(vars1), c1):
            row = []
            for j in range(0, len(vars2), c2):
                # inner vmap over vars2 tangents, outer over vars1: H
                # leaves (c1, c2, N, ...)
                ju, jw, h = torch.func.vmap(lambda u: torch.func.vmap(
                    lambda w: d2(u, w))(B2[j:j + c2]))(B1[i:i + c1])
                put(vars1[i:i + c1], tuple(t[:, 0] for t in ju))
                put(vars2[j:j + c2], tuple(t[0] for t in jw))
                row.append(h)
            rows.append(tuple(torch.cat([b[nreg + k] for b in row], dim=1)
                              for k in range(len(attrs))))
        hess = [torch.cat([r[k] for r in rows]).movedim(0, -1)
                .movedim(0, -1) for k in range(len(attrs))]
    return _assemble(probes, regular, attrs, value[:nreg],
                     list(value[nreg:]), cols, hess, vars1, vars2)


def _check_tracked(names, var_idx, kind):
    """A probe variable that no operator tracks raises: a zero column
    would silently poison downstream CRLB / Gauss-Newton fits (the
    reference raises KeyError)."""
    for var in names:
        if var != "magnitude" and var not in var_idx:
            raise ValueError(
                f"{kind} probe variable {var!r} is not tracked by any "
                f"operator (tracked: {sorted(var_idx)})")
