"""Operator algebra core.

Counterpart of ``epgpy_tpu/ops/base.py``.  An operator is a small object
holding its parameters as host values (numpy arrays or python scalars, as
the user gave them); applying it is a function ``sm -> sm`` that moves the
parameters to the working device only then.  Host parameters are what the
kernel dispatch reads to recognize a whole-sequence pattern
(fisp_dispatch.py).

``PARAMS`` names an operator's numeric parameters; everything else is
static configuration.  Two operators with the same :meth:`Operator.signature`
(class, static configuration, each parameter's shape and dtype) are
structurally identical, so the engine's scan planner can stack their
parameters over the repetitions of a periodic block (engine.py).
"""

from __future__ import annotations

import copy as _copy
from typing import Optional, Sequence

import numpy as np
import torch

from .. import common
from ..statematrix import StateMatrix

__all__ = ["Operator", "EmptyOperator", "MultiOperator", "DiffOperator",
           "CombinableOperator", "Wait", "Offset", "Spoiler", "Reset", "PD",
           "System", "NULL", "SPOILER", "RESET"]


class Operator:
    """Base linear operator acting on a StateMatrix."""

    #: names of the numeric parameters (stacked by the scan planner)
    PARAMS: tuple = ()
    #: device dtypes of parameters that do not take the working precision
    #: (the engine's planned copies)
    LEAF_DTYPES: dict = {}
    #: parameters with defined first/second derivatives (diff layer)
    PARAMETERS_ORDER1: frozenset = frozenset()
    #: attributes ignored by :meth:`signature` (cosmetic / timing / diff
    #: specs: the diff path never plans)
    SIGNATURE_IGNORE = frozenset({"name", "duration", "order1", "order2"})
    #: whether applying the operator keeps F-(k) == conj(F+(-k)) (the
    #: dense table engines need it throughout a train)
    preserves_ladder_symmetry: bool = True

    def __init__(self, *, name: Optional[str] = None, duration=None,
                 order1=False, order2=False):
        self.name = name if name is not None else type(self).__name__
        self.duration = 0.0 if duration is None else duration
        if order1 or order2:
            from .. import diff
            # an order2-only bool/str spec implies the same order1 spec
            # (reference epgpy/diff.py:160-162)
            o1 = order1 if order1 else (
                order2 if isinstance(order2, (bool, str)) else False)
            self.order1 = diff.parse_order1(o1, self.PARAMETERS_ORDER1)
            self.order2 = diff.parse_order2(order2, self.order1,
                                            self.PARAMETERS_ORDER1)
        else:
            self.order1 = {}
            self.order2 = {}

    @property
    def shape(self) -> tuple:
        """Operator batch shape (parameter-sweep axes)."""
        return (1,)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nshift(self) -> int:
        """Ladder growth caused by this operator (0 for non-shift ops)."""
        return 0

    @property
    def kdim(self) -> int:
        return 1

    # -- structure (scan planning) --

    def leaves(self) -> list:
        """The numeric parameters, in ``PARAMS`` order."""
        return [getattr(self, p) for p in self.PARAMS]

    def with_leaves(self, values) -> "Operator":
        """A copy whose parameters (``PARAMS`` order) are `values`."""
        return self.copy(**dict(zip(self.PARAMS, values)))

    def leaf_dtypes(self) -> list:
        """The device dtype of each leaf (None: the working precision)."""
        return [self.LEAF_DTYPES.get(p) for p in self.PARAMS]

    def signature(self):
        """Structural identity used for scan grouping: the class, the
        static configuration and each parameter's shape and dtype (JAX
        ``Operator.signature``: equal treedefs and leaf shapes)."""
        static = tuple(sorted(
            (k, _freeze(v)) for k, v in vars(self).items()
            if k not in self.PARAMS and k not in self.SIGNATURE_IGNORE))
        return (type(self), static, tuple(_leaf_sig(x)
                                          for x in self.leaves()))

    def copy(self, **kwargs) -> "Operator":
        new = _copy.copy(self)
        for k, v in kwargs.items():
            setattr(new, k, v)
        return new

    def strip_meta(self) -> "Operator":
        """Copy with cosmetic metadata and diff specs cleared."""
        return self.copy(name=type(self).__name__, duration=0.0, order1={},
                         order2={})

    def apply(self, sm: StateMatrix) -> StateMatrix:
        raise NotImplementedError

    def __call__(self, sm: StateMatrix) -> StateMatrix:
        return self.apply(sm.expand(self.ndim))

    def __mul__(self, other):
        ops = self.operators if isinstance(self, MultiOperator) else [self]
        ops = ops + (other.operators if isinstance(other, MultiOperator)
                     else [other])
        return MultiOperator(ops)

    def __repr__(self):
        return self.name


class EmptyOperator(Operator):
    """Does nothing (timing/probe placeholder)."""

    def apply(self, sm):
        return sm


class Wait(EmptyOperator):
    def __init__(self, duration, name=None):
        super().__init__(name=name or f"Wait({duration})", duration=duration)


class MultiOperator(Operator):
    """A sequence of operators applied as one."""

    def __init__(self, operators: Sequence[Operator], *, name=None,
                 duration=None):
        operators = list(operators)
        if duration is None:
            duration = sum(op.duration for op in operators)
        super().__init__(name=name or "*".join(op.name for op in operators),
                         duration=duration)
        self.operators = operators

    @property
    def shape(self):
        return common.broadcast_shapes(*[op.shape for op in self.operators])

    @property
    def nshift(self):
        return sum(op.nshift for op in self.operators)

    def apply(self, sm):
        for op in self.operators:
            sm = op(sm)
        return sm

    def __getitem__(self, i):
        return self.operators[i]

    def __len__(self):
        return len(self.operators)


class DiffOperator(Operator):
    """Marker base of the physics operators (T, E, P, R, S), as in the
    reference hierarchy (epgpy/diff.py:20): probes and Wait are not
    DiffOperators.  The order1/order2 parsing itself lives in
    Operator.__init__; this class adds no behavior."""


class CombinableOperator(Operator):
    """Mixin: linear operators mergeable into one operator.

    Pipeline convention (reference epgpy/operator.py:206-241): ``A @ B``
    applies A first, then B."""

    def combinable(self, other) -> bool:
        return isinstance(other, CombinableOperator)

    def combine(self, other, *, name=None, duration=None, **kwargs):
        """A single operator applying `self` then `other`."""
        raise NotImplementedError

    def __matmul__(self, other):
        return self.combine(other)

    def __rmatmul__(self, other):
        return other.combine(self)


# -- utility operators (reference epgpy/operator.py:248-361) --


class Offset(EmptyOperator):
    """Empty operator with a possibly negative duration (timing)."""

    def __init__(self, duration, name=None):
        super().__init__(name=name or f"Offset({duration})",
                         duration=duration)


class Spoiler(Operator):
    """Perfect spoiler: destroys all transverse magnetization."""

    def apply(self, sm):
        s = sm.states
        return sm.update(states=torch.cat(
            [torch.zeros_like(s[..., :2]), s[..., 2:]], dim=-1))


class Reset(Operator):
    """Reset the magnetization to equilibrium.  An equilibrium with batch
    axes wider than the states (``PD(batch, reset=False)`` then RESET)
    grows the states to the common shape (reference
    epgpy/statematrix.py set(..., resize=True))."""

    def apply(self, sm):
        eq = sm.equilibrium.to(sm.states.dtype)
        shape = np.broadcast_shapes(tuple(eq.shape), tuple(sm.states.shape))
        return sm.update(states=eq.expand(shape))


class PD(Operator):
    """Set the proton density (a new equilibrium), resetting the states
    to it unless ``reset=False``."""

    PARAMS = ("pd",)

    def __init__(self, pd, *, reset=True, name=None, **kwargs):
        self.pd = pd if isinstance(pd, torch.Tensor) else np.asarray(
            pd, dtype=float)
        self.reset = bool(reset)
        super().__init__(name=name or _repr("PD", pd), **kwargs)

    @property
    def shape(self):
        return common.get_shape(self.pd) or (1,)

    def apply(self, sm):
        n = sm.nstate
        pd = torch.as_tensor(self.pd, dtype=sm.states.real.dtype,
                             device=sm.states.device)
        if pd.ndim < sm.ndim:
            pd = pd.reshape(pd.shape + (1,) * (sm.ndim - pd.ndim))
        eq = torch.zeros(pd.shape + (2 * n + 1, 3), dtype=sm.states.dtype,
                         device=pd.device)
        eq[..., n, 2] = pd
        sm = sm.update(equilibrium=eq)
        if self.reset:
            shape = common.broadcast_shapes(sm.shape, tuple(pd.shape))
            sm = sm.update(states=eq.expand(shape + eq.shape[-2:]))
        return sm


class System(Operator):
    """Write named system properties (``kvalue``/``tvalue`` into the
    StateMatrix's fields, anything else into ``sm.system``)."""

    def __init__(self, name=None, **properties):
        self.keys = tuple(sorted(k for k in properties
                                 if k not in ("kvalue", "tvalue")))
        self.scalars = {k: properties[k] for k in ("kvalue", "tvalue")
                        if k in properties}
        self.values = tuple(properties[k] for k in self.keys)
        super().__init__(name=name or "System")

    def apply(self, sm):
        system = dict(sm.system)
        system.update(zip(self.keys, self.values))
        return sm.update(system=system, **self.scalars)


NULL = EmptyOperator(name="NULL")
SPOILER = Spoiler(name="Spoiler")
RESET = Reset(name="Reset")


def _repr(name, *values):
    """Cosmetic operator name: scalars printed, arrays as their shape."""
    def fmt(v):
        shape = common.get_shape(v)
        return "array" + str(shape) if shape else f"{float(v):.1f}"
    return f"{name}({', '.join(fmt(v) for v in values)})"


def _leaf_sig(x):
    """(shape, dtype) of a parameter, None for an absent one."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    arr = np.asarray(x)
    return (arr.shape, arr.dtype.name)


def _freeze(v):
    """A hashable, comparable stand-in of a static attribute: values by
    value (small host arrays by their bytes), anything else (callables,
    tensors, operators) by identity."""
    if v is None or isinstance(v, (bool, int, float, complex, str)):
        return v
    if isinstance(v, (np.generic,)):
        return v.item()
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((str(k), _freeze(x)) for k, x in v.items()))
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(map(str, v)))
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, v.dtype.str, v.tobytes())
    return ("id", id(v))
