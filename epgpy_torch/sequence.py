"""Sequence DSL: symbolic variables, virtual operators, signal/CRLB closures.

Counterpart of ``epgpy_tpu/sequence.py`` (API parity with reference
epgpy/sequence.py: Sequence, Variable, Constant, Expression,
VirtualOperator, repeat, the ``operators`` namespace and string ops).  As
in JAX, expressions are small trees evaluated on demand, and
``Expression.derive`` is forward-mode autodiff over the tree
(``torch.func.jvp``, in float64 on the CPU) instead of the reference's
symbolic algebra (epgpy/sequence.py:610-956).  It feeds the order1/order2
coefficient dicts of the diff layer (diff.py).

A function node stores its function's name (``"mul"``, ``"exp"``) and
resolves it when evaluated -- Python's ``operator`` module for the
arithmetic, ``torch`` for the ``functions``/``math`` namespace (numpy
names such as ``power`` map to torch's) -- so a sequence pickles.
``VirtualOperator.build`` gives the concrete operator host values: its
parameters as evaluated (a math-namespace result comes back to numpy) and
its derivative coefficients as numpy arrays of the shapes JAX gives them
(per atom where a variable is), so every kernel family takes or declines
a DSL train as the JAX matchers do.  The ``signal``,
``jacobian``, ``hessian``, ``crlb`` and ``confint`` closures return
tensors on the working device.
"""

from __future__ import annotations

import operator as _py_operator
import re
from typing import Dict, List

import numpy as np
import torch

from . import diff as _diff
from . import engine as _engine
from . import ops as _ops
from . import stats

__all__ = [
    "Sequence", "Variable", "Constant", "Expression", "VirtualOperator",
    "repeat", "operators", "functions", "math",
]


# -- expressions --


def as_expression(obj):
    if isinstance(obj, Expression):
        return obj
    if isinstance(obj, str):
        # a bare string argument names a variable: operators.T("alpha", 90)
        # (reference epgpy/sequence.py:598-606)
        return Variable(obj)
    return Constant(obj)


#: arithmetic of the operator overloads, by name
_PY_OPS = {name: getattr(_py_operator, name)
           for name in ("add", "sub", "mul", "truediv", "pow", "neg")}
#: numpy names of the math namespace that torch spells otherwise
_TORCH_NAMES = {"power": "pow", "absolute": "abs", "fabs": "abs",
                "conjugate": "conj", "mod": "remainder", "around": "round",
                "amax": "max", "amin": "min"}


def _torch_function(name):
    """The torch function behind a math-namespace name, or None."""
    if name.startswith("_"):
        return None
    fn = getattr(torch, _TORCH_NAMES.get(name, name), None)
    return fn if callable(fn) else None


def _tensor(x):
    """A value as a tensor: tensors as they are, host numbers as float64
    (complex128) tensors on the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind not in "fc":
        arr = arr.astype(np.float64)
    return torch.as_tensor(arr)


def _host(x, coefficient=False):
    """An evaluated parameter as the operator takes it: CPU tensors (the
    math namespace's results) become numpy arrays, tensors the caller gave
    on the card stay there.  A derivative coefficient always comes to the
    host (JAX's ``np.asarray``), the dispatch reads it there."""
    if isinstance(x, torch.Tensor) and (coefficient or not x.is_cuda):
        # force: a jvp tangent may be a ZeroTensor (a constant's derivative)
        return x.detach().cpu().numpy(force=True)
    return x


def _apply(fn, args):
    """Evaluate a function node: a callable as given, an arithmetic name
    from ``operator``, any other name from torch on tensor arguments."""
    if callable(fn):
        return fn(*args)
    if fn in _PY_OPS:
        return _PY_OPS[fn](*args)
    tfn = _torch_function(fn)
    if tfn is None:
        raise AttributeError(f"no function {fn!r} in the math namespace")
    return tfn(*(_tensor(a) for a in args))


class Expression:
    """Lazy numeric expression over named variables."""

    # -- evaluation --

    @property
    def variables(self) -> set:
        return set()

    def __call__(self, /, **values):
        resolved = self.map(values)
        missing = resolved.variables
        if missing:
            raise ValueError(f"Missing value(s) for variable(s): {missing}")
        return resolved.evaluate({})

    def evaluate(self, values: Dict[str, object]):
        raise NotImplementedError

    def map(self, values=None, **kwargs) -> "Expression":
        """Substitute variables with values/expressions/new names."""
        raise NotImplementedError

    def derive(self, var, /, **values) -> "Expression":
        """Partial derivative w.r.t. variable `var` (forward-mode autodiff)."""
        var = str(var)
        if var not in {str(v) for v in self.variables}:
            d = Constant(0.0)
        else:
            d = Derivative(self, var)
        return d(**values) if values else d

    # -- operator overloading --

    def __add__(self, other):
        return Function("add", self, as_expression(other))

    def __radd__(self, other):
        return Function("add", as_expression(other), self)

    def __sub__(self, other):
        return Function("sub", self, as_expression(other))

    def __rsub__(self, other):
        return Function("sub", as_expression(other), self)

    def __mul__(self, other):
        return Function("mul", self, as_expression(other))

    def __rmul__(self, other):
        return Function("mul", as_expression(other), self)

    def __truediv__(self, other):
        return Function("truediv", self, as_expression(other))

    def __rtruediv__(self, other):
        return Function("truediv", as_expression(other), self)

    def __pow__(self, other):
        return Function("pow", self, as_expression(other))

    def __rpow__(self, other):
        return Function("pow", as_expression(other), self)

    def __neg__(self):
        return Function("neg", self)

    def __abs__(self):
        return Function("abs", self)


class Variable(Expression):
    """Named free variable."""

    def __init__(self, name: str):
        if not isinstance(name, str) or not name:
            raise ValueError(f"Invalid variable name: {name!r}")
        self.name = name

    @property
    def variables(self):
        return {self}

    def evaluate(self, values):
        return values[self.name]

    def map(self, values=None, **kwargs):
        values = {**(values or {}), **kwargs}
        if self.name not in values:
            return self
        sub = values[self.name]
        if isinstance(sub, str):
            return Variable(sub)
        return as_expression(sub)

    def __str__(self):
        return self.name

    def __repr__(self):
        return f"Variable({self.name})"

    def __eq__(self, other):
        if isinstance(other, Variable):
            return self.name == other.name
        return self.name == other

    def __hash__(self):
        return hash(self.name)


class Constant(Expression):
    def __init__(self, value):
        if isinstance(value, Expression):
            raise TypeError("Constant cannot wrap an expression")
        self.value = value

    def evaluate(self, values):
        return self.value

    def map(self, values=None, **kwargs):
        return self

    def __repr__(self):
        return f"Constant({self.value})"


class Function(Expression):
    """Applied function node (n-ary): `fn` is a function name (resolved
    when evaluated) or a callable."""

    def __init__(self, fn, *args):
        self.fn = fn
        self.args = tuple(as_expression(a) for a in args)

    @property
    def variables(self):
        return {v for a in self.args for v in a.variables}

    def evaluate(self, values):
        return _apply(self.fn, [a.evaluate(values) for a in self.args])

    def map(self, values=None, **kwargs):
        values = {**(values or {}), **kwargs}
        return Function(self.fn, *(a.map(values) for a in self.args))

    def __repr__(self):
        name = self.fn if isinstance(self.fn, str) else getattr(
            self.fn, "__name__", str(self.fn))
        return f"{name}({', '.join(map(repr, self.args))})"


class Derivative(Expression):
    """d(expr)/d(var) by forward-mode autodiff (elementwise), float64."""

    def __init__(self, expr: Expression, var: str):
        self.expr = expr
        self.var = var

    @property
    def variables(self):
        return self.expr.variables

    def evaluate(self, values):
        values = {k: _tensor(v) for k, v in values.items()}
        v0 = values[self.var]
        if not v0.is_complex():
            v0 = v0.to(torch.float64)
        if isinstance(self.expr, Variable) and self.expr.name == self.var:
            # d(var)/d(var): the unit tangent the jvp below would return,
            # without its dispatch or a fill of the variable's shape (a DSL
            # train's T1/T2 on every E op): a broadcast view of one 1
            return torch.ones((), dtype=v0.dtype,
                              device=v0.device).expand(v0.shape)

        def f(v):
            return _tensor(self.expr.evaluate({**values, self.var: v}))

        _, tangent = torch.func.jvp(f, (v0,), (torch.ones_like(v0),))
        return tangent

    def map(self, values=None, **kwargs):
        values = {**(values or {}), **kwargs}
        sub = {k: v for k, v in values.items() if k != self.var}
        mapped = self.expr.map(sub) if sub else self.expr
        if self.var in values:
            # evaluate at the provided point: keep var free in expr
            out = Derivative(mapped, self.var)
            vset = {str(v) for v in out.variables}
            if vset <= {self.var}:
                return Constant(out.evaluate({self.var: values[self.var]}))
            return _Bound(out, {self.var: values[self.var]})
        return Derivative(mapped, self.var)


class _Bound(Expression):
    """Expression with some variable values pre-bound."""

    def __init__(self, expr, bound):
        self.expr = expr
        self.bound = dict(bound)

    @property
    def variables(self):
        return {v for v in self.expr.variables if str(v) not in self.bound}

    def evaluate(self, values):
        return self.expr.evaluate({**self.bound, **values})

    def map(self, values=None, **kwargs):
        values = {**(values or {}), **kwargs}
        values = {k: v for k, v in values.items() if k not in self.bound}
        return _Bound(self.expr.map(values) if values else self.expr,
                      self.bound)


class _Functions:
    """Math functions namespace producing expression nodes (torch
    functions under their numpy names)."""

    def __getattr__(self, name):
        if _torch_function(name) is None:
            raise AttributeError(name)

        def wrapper(*args):
            return Function(name, *args)
        wrapper.__name__ = name
        return wrapper


functions = _Functions()
#: reference-compatible alias (reference epgpy/sequence.py exposes `math`)
math = functions


# -- virtual operators --


class VirtualOperator:
    """Deferred operator whose arguments may be expressions.

    `build(values, order1, order2)` resolves the expressions and fills the
    concrete op's order1/order2 coefficient dicts with dp/dv and d2p/dv dw
    (reference epgpy/sequence.py:458-504).
    """

    OPERATOR = None
    POSITIONALS: List[str] = []
    KEYWORDS: List[str] = []
    OPTIONS: List[str] = []

    def __init__(self, *args, **kwargs):
        cls = type(self)
        if len(args) > len(cls.POSITIONALS):
            raise TypeError(f"Too many positional arguments for {cls.__name__}")
        self.positionals = [as_expression(a) for a in args]
        self.keywords = {
            k: as_expression(kwargs.pop(k)) for k in list(kwargs)
            if k in cls.KEYWORDS
        }
        self.options = kwargs  # anything else passes through (name, axes...)

    @property
    def variables(self):
        exprs = list(self.positionals) + list(self.keywords.values())
        return {v for e in exprs for v in e.variables}

    def __getattr__(self, attr):
        # guard the instance fields themselves (pickle creates instances
        # without __init__, and a miss here must not recurse)
        if attr.startswith("__") or attr in ("positionals", "keywords",
                                             "options"):
            raise AttributeError(attr)
        cls = type(self)
        if attr in cls.POSITIONALS:
            i = cls.POSITIONALS.index(attr)
            if i < len(self.positionals):
                return self.positionals[i]
            raise AttributeError(attr)
        if attr in self.keywords:
            return self.keywords[attr]
        if attr in self.options:
            return self.options[attr]
        raise AttributeError(attr)

    def map(self, values=None, **kwargs):
        values = {**(values or {}), **kwargs}
        new = object.__new__(type(self))
        new.positionals = [a.map(values) for a in self.positionals]
        new.keywords = {k: v.map(values) for k, v in self.keywords.items()}
        new.options = dict(self.options)
        return new

    def __call__(self, /, **values):
        return self.map(values)

    def build(self, values=None, *, order1=None, order2=None):
        values = {str(k): v for k, v in (values or {}).items()}
        args = [_host(a(**values)) for a in self.positionals]
        kwargs = {k: _host(v(**values)) for k, v in self.keywords.items()}
        kwargs.update(self.options)

        if not (order1 or order2) or not type(self).OPERATOR.PARAMETERS_ORDER1:
            return type(self).OPERATOR(*args, **kwargs)

        order1 = set(order1 or [])
        order2 = {tuple(sorted(p)) for p in (order2 or [])}
        hesvars = {v for p in order2 for v in p}

        exprs = list(zip(type(self).POSITIONALS, self.positionals))
        exprs += [(k, self.keywords[k]) for k in self.keywords]

        _o1, _o2 = {}, {}
        for param, expr in exprs:
            if param not in type(self).OPERATOR.PARAMETERS_ORDER1:
                continue
            varnames = {str(v) for v in expr.variables}
            for var in varnames & (order1 | hesvars):
                c1 = np.asarray(_host(expr.derive(var)(**values), True))
                _o1.setdefault(var, {})[param] = c1
            for pair in order2:
                if pair[0] in varnames and pair[1] in varnames:
                    _o2.setdefault(pair, {})
                    c2 = np.asarray(_host(
                        expr.derive(pair[0]).derive(pair[1])(**values), True))
                    if not np.allclose(c2, 0):
                        _o2[pair][param] = c2
                elif pair[0] in varnames or pair[1] in varnames:
                    _o2.setdefault(pair, {})
        if _o1:
            kwargs["order1"] = _o1
        if _o2:
            kwargs["order2"] = _o2
        return type(self).OPERATOR(*args, **kwargs)

    def __repr__(self):
        args = ", ".join(repr(a) for a in self.positionals)
        return f"{type(self).OPERATOR.__name__}({args})"


def _virtual(op_cls, positionals, keywords=()):
    name = op_cls.__name__
    return type(name, (VirtualOperator,), {
        "OPERATOR": op_cls,
        "POSITIONALS": list(positionals),
        "KEYWORDS": list(keywords),
        "__module__": __name__,
    })


class _PrebuiltOperator(VirtualOperator):
    """Wrap an already-concrete operator as a virtual one."""

    OPERATOR = _ops.Operator

    def __init__(self, op):
        self.op = op
        self.positionals = []
        self.keywords = {}
        self.options = {}

    @property
    def variables(self):
        return set()

    def map(self, values=None, **kwargs):
        return self

    def build(self, values=None, *, order1=None, order2=None):
        return self.op


class _OperatorNamespace:
    """Virtual-operator factory namespace (reference sequence.py operators)."""

    T = _virtual(_ops.T, ["alpha", "phi"])
    Tx = None  # set below
    Ty = None
    Phi = _virtual(_ops.Phi, ["phi"])
    E = _virtual(_ops.E, ["tau", "T1", "T2", "g"])
    P = _virtual(_ops.P, ["tau", "g"])
    R = _virtual(_ops.R, ["rT", "rL"], keywords=["r0"])

    @staticmethod
    def S(k, **kwargs):
        return _PrebuiltOperator(_ops.S(k, **kwargs))

    @staticmethod
    def G(tau, gradient, **kwargs):
        return _PrebuiltOperator(_ops.G(tau, gradient, **kwargs))

    @staticmethod
    def C(tau, R2=1, **kwargs):
        return _PrebuiltOperator(_ops.C(tau, R2, **kwargs))

    @staticmethod
    def D(tau, D, k=None, **kwargs):
        return _PrebuiltOperator(_ops.D(tau, D, k, **kwargs))

    @staticmethod
    def X(tau, khi, **kwargs):
        return _PrebuiltOperator(_ops.X(tau, khi, **kwargs))

    @staticmethod
    def RFPulse(values, duration, **kwargs):
        return _PrebuiltOperator(_ops.RFPulse(values, duration, **kwargs))

    @staticmethod
    def Adc(*args, **kwargs):
        return _PrebuiltOperator(_ops.Adc(*args, **kwargs))

    @staticmethod
    def Probe(*args, **kwargs):
        return _PrebuiltOperator(_ops.Probe(*args, **kwargs))

    @staticmethod
    def Wait(duration, **kwargs):
        return _PrebuiltOperator(_ops.Wait(duration, **kwargs))

    @staticmethod
    def Offset(duration, **kwargs):
        return _PrebuiltOperator(_ops.Offset(duration, **kwargs))

    @staticmethod
    def Null(**kwargs):
        # reference sequence.py:578 virtual EmptyOperator factory
        return _PrebuiltOperator(_ops.EmptyOperator(**kwargs))

    ADC = None  # set below
    SPOILER = None
    RESET = None
    NULL = None


def _tx(alpha, **kwargs):
    return _OperatorNamespace.T(alpha, 0, **kwargs)


def _ty(alpha, **kwargs):
    return _OperatorNamespace.T(alpha, 90, **kwargs)


operators = _OperatorNamespace()
_OperatorNamespace.Tx = staticmethod(_tx)
_OperatorNamespace.Ty = staticmethod(_ty)

# module-level aliases so pickle can resolve the generated classes
T = _OperatorNamespace.T
Phi = _OperatorNamespace.Phi
E = _OperatorNamespace.E
P = _OperatorNamespace.P
R = _OperatorNamespace.R
_OperatorNamespace.ADC = _PrebuiltOperator(_ops.ADC)
_OperatorNamespace.SPOILER = _PrebuiltOperator(_ops.SPOILER)
_OperatorNamespace.RESET = _PrebuiltOperator(_ops.RESET)
_OperatorNamespace.NULL = _PrebuiltOperator(_ops.NULL)

STR_OPERATORS = {
    "ADC": _OperatorNamespace.ADC,
    "SPOILER": _OperatorNamespace.SPOILER,
    "RESET": _OperatorNamespace.RESET,
    "NULL": _OperatorNamespace.NULL,
}


def _flatten(ops):
    out = []
    for item in ops:
        if isinstance(item, (list, tuple)):
            out.extend(_flatten(item))
        elif isinstance(item, Sequence):
            out.extend(item.operators)
        else:
            out.append(item)
    return out


# -- Sequence --


class Sequence:
    """Symbolic sequence: build/simulate/jacobian/hessian/crlb/confint."""

    def __init__(self, ops=(), *, name=None, options=None):
        ops = _flatten(list(ops))
        self.operators = self.check(ops)
        self.name = name
        self.options = options or {}

    def check(self, ops):
        ops = [STR_OPERATORS.get(op, op) for op in ops]
        converted = []
        for op in ops:
            if isinstance(op, VirtualOperator):
                converted.append(op)
            elif isinstance(op, _ops.Operator):
                converted.append(_PrebuiltOperator(op))
            else:
                raise ValueError(f"Invalid operator: {op!r}")
        return converted

    def __len__(self):
        return len(self.operators)

    def __iter__(self):
        return iter(self.operators)

    def __getitem__(self, item):
        return self.operators[item]

    def __setitem__(self, item, op):
        if isinstance(op, Sequence):
            ops = op.operators
        elif isinstance(op, list):
            ops = self.check(op)
        else:
            ops = self.check([op])
        if isinstance(item, (int, np.integer)):
            # replace exactly one element (a raw slice(item, item+1)
            # would be EMPTY for item=-1 and insert instead of replace)
            n = len(self.operators)
            idx = int(item) + n if item < 0 else int(item)
            if not 0 <= idx < n:
                raise IndexError(item)
            item = slice(idx, idx + 1)
        self.operators[item] = ops

    def __delitem__(self, item):
        del self.operators[item]

    def __add__(self, other):
        if not isinstance(other, Sequence):
            raise ValueError(f"Expecting Sequence, not {type(other)}")
        return self.copy(self.operators + other.operators)

    def __call__(self, *args, **kwargs):
        return self.signal(*args, **kwargs)

    def __repr__(self):
        return self.name if self.name else f"Sequence({len(self)})"

    def copy(self, ops=None, **kwargs):
        return Sequence(ops if ops is not None else self.operators,
                        name=kwargs.get("name", self.name),
                        options=self.options)

    @property
    def variables(self):
        return {v for op in self.operators for v in op.variables}

    def build(self, values=None, *, order1=None, order2=None):
        variables = {str(v) for v in self.variables}
        if order1:
            order1 = [v for v in order1 if v != "magnitude"]
            invalid = set(order1) - variables
            if invalid:
                raise ValueError(f"Unknown variable(s) in order1: {invalid}")
        if order2:
            order2 = [p for p in order2 if "magnitude" not in p]
            hessvars = {v for p in order2 for v in p}
            invalid = hessvars - variables
            if invalid:
                raise ValueError(f"Unknown variable(s) in order2: {invalid}")
            if not order1:
                order1 = list(hessvars)
        unique = {}
        out = []
        for op in self.operators:
            # one build per distinct virtual operator: a repeated block
            # shares its ops, and each build evaluates derivatives
            if id(op) not in unique:
                unique[id(op)] = op.build(values or {}, order1=order1,
                                          order2=order2)
            out.append(unique[id(op)])
        return out

    def simulate(self, values=None, *, order1=None, order2=None, probe=None,
                 **kwargs):
        options = {**self.options, **kwargs}
        ops = self.build(values, order1=order1, order2=order2)
        return _engine.simulate(ops, probe=probe, **options)

    def adc_times(self, **values):
        return _engine.get_adc_times(self.build(values=values))

    def signal(self, *, options={}, **values):
        def signal(valuesdict=None, **vals):
            vals.update(valuesdict or {})
            sim = self.simulate(vals, asarray=False, **options)
            return torch.movedim(sim, 0, -1)
        return signal(**values) if values else signal

    def jacobian(self, variables, *, options={}, **values):
        if isinstance(variables, str):
            variables = [variables]
        probe = [_ops.ADC, _diff.Jacobian(list(variables))]

        def jacobian(valuesdict=None, **vals):
            vals.update(valuesdict or {})
            sim, jac = self.simulate(vals, order1=[v for v in variables
                                                   if v != "magnitude"],
                                     probe=probe, asarray=False, **options)
            return torch.movedim(sim, 0, -1), torch.movedim(jac, 0, -2)
        return jacobian(**values) if values else jacobian

    def hessian(self, variables1, variables2=None, *, options={}, **values):
        if isinstance(variables1, str):
            variables1 = [variables1]
        if variables2 is None:
            variables2 = variables1
        elif isinstance(variables2, str):
            variables2 = [variables2]
        probe = [_ops.ADC, _diff.Jacobian(list(variables1)),
                 _diff.Hessian(list(variables1), list(variables2))]
        # normalize pairs by sorting (a `v1 <= v2` filter, as in the
        # reference, silently drops cross pairs like ("T2", "B1"))
        pairs = sorted({tuple(sorted((v1, v2)))
                        for v1 in variables1 for v2 in variables2
                        if "magnitude" not in (v1, v2)})
        o1 = [v for v in set(variables1) | set(variables2) if v != "magnitude"]

        def hessian(valuesdict=None, **vals):
            vals.update(valuesdict or {})
            sim, jac, hes = self.simulate(vals, order1=o1, order2=pairs,
                                          probe=probe, asarray=False,
                                          **options)
            return (torch.movedim(sim, 0, -1), torch.movedim(jac, 0, -2),
                    torch.movedim(hes, 0, -3))
        return hessian(**values) if values else hessian

    def crlb(self, variables, *, gradient=None, weights=None, log=False,
             sigma2=1, options={}):
        def crlb(valuesdict=None, **vals):
            vals.update(valuesdict or {})
            hess = None
            if not gradient:
                _, jac = self.jacobian(variables, options=options)(vals)
            else:
                variables2 = variables if gradient is True else list(gradient)
                _, jac, hess = self.hessian(variables, variables2,
                                            options=options)(vals)
            return stats.crlb(jac, H=hess, W=weights, log=log, sigma2=sigma2)
        return crlb

    def confint(self, obs, variables, *, conflevel=0.95, return_cband=False):
        def confint(valuesdict=None, **vals):
            vals.update(valuesdict or {})
            pred, jac = self.jacobian(variables)(vals)
            obs_ = torch.as_tensor(obs, device=pred.device)
            if obs_.shape != pred.shape:
                raise ValueError("Mismatch between observation and "
                                 "prediction shapes")
            cints, cband = stats.confint(obs_, pred, jac, conflevel=conflevel)
            if return_cband:
                return cints, cband
            return cints
        return confint


_FORMAT_FIELD = re.compile(r"\{[^{}]*\}")


def _fill_first_field(template: str, index: int) -> str:
    """Fill only the FIRST format field of `template` with a 1-based index.

    Later fields are left verbatim so each nesting level of `repeat`
    consumes exactly one field: ``"a{:02d}_{}"`` becomes ``"a01_{}"`` at
    the outer level and ``"a01_03"`` one level deeper.
    """
    match = _FORMAT_FIELD.search(template)
    if match is None:
        return template
    return (template[:match.start()]
            + match.group(0).format(index)
            + template[match.end():])


def _per_repetition(value, n: int):
    """Value of one mapping entry at repetition `n` (0-based)."""
    if isinstance(value, list):
        return value[n]
    if isinstance(value, str):
        return _fill_first_field(value, n + 1)
    return value


def repeat(ops, nrep=None, **mapping):
    """Clone a block of virtual operators, remapping variables per repetition.

    `mapping` renames/assigns each listed variable per repetition: a string
    value is a name template (one format field consumed per nesting level),
    a list supplies one entry per repetition (and determines the count when
    `nrep` is omitted).  Nested repetition comes from `nrep` as a list of
    counts, or implicitly from nested list values.  Returns a nested list
    of operators -- the MRF train builder (semantics parity with reference
    epgpy/sequence.py:343-385, docs/sequence.md:183-205).
    """
    if isinstance(ops, Sequence):
        ops = ops.operators
    if not isinstance(ops, list):
        raise ValueError(f"Expecting operator list, got {type(ops)}")

    inferred = nrep is None
    if inferred:
        lengths = {len(v) for v in mapping.values() if isinstance(v, list)}
        if len(lengths) > 1:
            raise ValueError(
                f"Inconsistent lengths in mapping values: {lengths}")
        if not lengths:
            raise ValueError("Unknown number of repetitions")
        counts = [lengths.pop()]
    else:
        counts = [nrep] if isinstance(nrep, int) else list(nrep)

    deeper = counts[1:]
    blocks = []
    for n in range(counts[0]):
        level = {name: _per_repetition(value, n)
                 for name, value in mapping.items()}
        unresolved = any(isinstance(v, list) for v in level.values())
        if deeper or (inferred and unresolved):
            blocks.append(repeat(ops, deeper or None, **level))
            continue
        block = []
        for op in ops:
            op = STR_OPERATORS.get(op, op)
            block.append(op.map(level) if isinstance(op, VirtualOperator)
                         else op)
        blocks.append(block)
    return blocks
