"""Differentiation layer: Jacobian probes by forward-mode autodiff.

Counterpart of ``epgpy_tpu/diff.py:47-560``.  The reference hand-derives
per-operator derivative matrices (reference epgpy/diff.py:20-378); here,
as in the JAX package, derivatives come from autodiff through the whole
sequence:

* every operator keeps its physical parameters, so the derivative of its
  coefficients w.r.t. any parameter is exact autodiff;
* variable aliases and chain-rule coefficients (order1 specs) become an
  epsilon substitution: each tracked parameter is replaced by
  ``p(eps) = p + sum_v c1[v] eps_v``, and the Jacobian is the derivative
  of the signal w.r.t. eps at 0;
* the forward pass is the port's eager operator loop
  (``engine.simulate_simple``); ``torch.func.jvp`` pushes the tangent
  basis through it, batched by ``torch.func.vmap`` (the primal does not
  depend on the tangent, so it runs once per call).

Outputs match the reference probes: Jacobian -> (nADC, ..., nvars); the
pseudo-variable "magnitude" maps to the signal itself.  Order 2 (the
``Hessian`` probe) is not ported yet: it comes with the fused Hessian
kernel (ROADMAP queue 1, item 7) and raises NotImplementedError here.
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

_NO_ORDER2 = ("Hessian probes (order-2 derivatives) are not ported to "
              "epgpy_torch yet: they come with the fused Hessian kernel "
              "(ROADMAP queue 1, item 7; queue 2, row 4)")


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
    """Probe returning d2(signal)/d(vars1)d(vars2) at each ADC (order 2:
    accepted here, computed only by a later slice; simulate() raises)."""

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
    """Copy `op` with tracked parameters shifted by the linear eps
    expansion ``sum_v c1 eps_v``.  The order2 curvature terms are
    quadratic in eps, so they do not reach first derivatives at eps = 0;
    they come with the Hessian.  Ops without specs are returned as
    they are."""
    order1 = getattr(op, "order1", {}) or {}
    if not order1:
        return op
    delta: Dict[str, object] = {}
    for var, coeffs in order1.items():
        if var in eps:
            for param, c in coeffs.items():
                term = _param_tensor(c) * eps[var]
                delta[param] = term if param not in delta else (
                    delta[param] + term)
    new = copy.copy(op)
    new.order1, new.order2 = {}, {}
    for param, d in delta.items():
        old = getattr(new, param, None)
        if param not in op.PARAMETERS_ORDER1 or old is None:
            raise ValueError(f"Cannot substitute parameter {param!r} on "
                             f"{type(op).__name__}")
        setattr(new, param, d + _param_tensor(old))
    return new


# -- diff simulation path --


def simulate_diff(sequence, probes, sm, *, max_nstate=None,
                  jacobian_chunk: Optional[int] = None):
    """Run simulate with Jacobian probes by forward-mode autodiff.

    Tangents are seeded on an epsilon vector with one slot per tracked
    variable and pushed through the eager operator loop with
    ``torch.func.jvp``, ``jacobian_chunk`` columns at a time (all at once
    by default) under ``torch.func.vmap``.

    Args:
        sequence: flat op list (with order1 specs attached).
        probes: tuple of probe objects (plain probes and Jacobians).
        sm: initial StateMatrix, broadcast to the sequence's batch shape.
        max_nstate: ladder cap of the operator loop.
        jacobian_chunk: max tangent columns pushed at once (None = all).

    Returns a tuple over probes of tensors with the ADC axis leading:
    plain probes (N, *batch), Jacobians (N, *batch, len(variables)).
    """
    from .engine import simulate_simple
    from .ops.probe import Adc

    if any(isinstance(pb, Hessian) for pb in probes):
        raise NotImplementedError(_NO_ORDER2)
    variables = tracked_variables(sequence)
    nvars = len(variables)
    var_idx = {v: i for i, v in enumerate(variables)}
    for pb in probes:
        for var in getattr(pb, "variables", ()):
            if var != "magnitude" and var not in var_idx:
                # a zero column would silently poison downstream CRLB /
                # Gauss-Newton fits (the reference raises KeyError)
                raise ValueError(
                    f"Jacobian probe variable {var!r} is not tracked by any "
                    f"operator (tracked: {sorted(var_idx)})")

    attrs = list(dict.fromkeys(pb.probe_attr for pb in probes
                               if isinstance(pb, Jacobian)))
    regular = [pb for pb in probes if not isinstance(pb, Jacobian)]
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
    value = run(zero)
    jac = None
    if nvars:
        def push(tangent):
            return torch.func.jvp(run, (zero,), (tangent,))[1]

        chunk = nvars if not jacobian_chunk else min(int(jacobian_chunk),
                                                     nvars)
        basis = torch.eye(nvars, dtype=zero.dtype, device=zero.device)
        parts = [torch.func.vmap(push)(basis[i:i + chunk])
                 for i in range(0, nvars, chunk)]
        jac = tuple(torch.cat([p[k] for p in parts]).movedim(0, -1)
                    for k in range(len(eval_probes)))

    out = []
    for pb in probes:
        if isinstance(pb, Jacobian):
            k = len(regular) + attrs.index(pb.probe_attr)
            cols = [value[k] if var == "magnitude"
                    else jac[k][..., var_idx[var]] for var in pb.variables]
            out.append(torch.stack(cols, dim=-1))
        else:
            out.append(value[regular.index(pb)])
    return tuple(out)
