"""Operator algebra core.

Counterpart of ``epgpy_tpu/ops/base.py``.  An operator is a small object
holding its parameters as host values (numpy arrays or python scalars, as
the user gave them); applying it is a function ``sm -> sm`` that moves the
parameters to the working device only then.  Host parameters are what the
kernel dispatch reads to recognize a whole-sequence pattern
(fisp_dispatch.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

from .. import common
from ..statematrix import StateMatrix

__all__ = ["Operator", "EmptyOperator", "MultiOperator", "DiffOperator",
           "Wait"]


class Operator:
    """Base linear operator acting on a StateMatrix."""

    #: parameters with defined first/second derivatives (diff layer)
    PARAMETERS_ORDER1: frozenset = frozenset()

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


class DiffOperator(Operator):
    """Marker base of the physics operators (T, E, P, R, S), as in the
    reference hierarchy (epgpy/diff.py:20): probes and Wait are not
    DiffOperators.  The order1/order2 parsing itself lives in
    Operator.__init__; this class adds no behavior."""
