"""Combined (pre-merged) linear operators.

Counterpart of ``epgpy_tpu/ops/combined.py``.  ``A @ B`` gives one
operator applying A then B (pipeline order, reference
epgpy/operator.py:206-241): the constituents' coefficients (all diagonal)
or matrices fold into one product, so the merged op costs one
application.
"""

from __future__ import annotations

from .. import common
from . import base
from .matrixop import apply_matrices, matrix_combine
from .scalarop import apply_coefficients, scalar_combine

__all__ = ["CombinedOp", "combine"]


def combine(*ops, name=None, duration=None):
    """Merge combinable operators into one (reference
    epgpy/operator.py:236): ``combine(a, b, c)`` applies a, then b, then c,
    as ``a @ b @ c`` does."""
    if not ops:
        raise ValueError("combine() requires at least one operator")
    merged = ops[0]
    for op in ops[1:]:
        merged = merged @ op
    if name or duration is not None:
        if isinstance(merged, CombinedOp):
            merged = CombinedOp(merged.ops, name=name, duration=duration)
        else:
            # a single operator: apply the overrides on a copy
            kw = {"name": name} if name else {}
            if duration is not None:
                kw["duration"] = duration
            merged = merged.copy(**kw)
    return merged


def _sum_durations(ops):
    durs = [getattr(op, "duration", None) for op in ops]
    if not any(d is not None for d in durs):
        return 0.0
    return sum(d for d in durs if d is not None)


class CombinedOp(base.CombinableOperator):
    """Product of combinable operators, applied as one."""

    def __init__(self, ops, *, name=None, duration=None):
        self.ops = list(ops)
        if duration is None:
            duration = _sum_durations(self.ops)
        base.Operator.__init__(
            self, name=name or "|".join(op.name for op in self.ops),
            duration=duration)
        # the union of the constituents' tracked variables, so the diff
        # layer sees them (diff.substitute descends into self.ops)
        merged1, merged2 = {}, {}
        for op in self.ops:
            for var in getattr(op, "order1", {}) or {}:
                merged1.setdefault(var, {})
            for pair in getattr(op, "order2", {}) or {}:
                merged2.setdefault(pair, {})
        self.order1, self.order2 = merged1, merged2
        # an asymmetric (check=False) constituent breaks the ladder
        # symmetry of the whole product: the dense table engines stay off
        self.preserves_ladder_symmetry = all(
            getattr(op, "preserves_ladder_symmetry", True) for op in self.ops)

    @classmethod
    def of(cls, first, second, *, name=None, duration=None):
        if not isinstance(second, base.CombinableOperator):
            raise TypeError(f"Non-combinable operator: {second!r}")
        ops = first.ops if isinstance(first, CombinedOp) else [first]
        ops = ops + (second.ops if isinstance(second, CombinedOp)
                     else [second])
        if name is None:
            name = f"{first.name}|{second.name}"
        if duration is None:
            d1 = getattr(first, "duration", None)
            d2 = getattr(second, "duration", None)
            duration = (0.0 if d1 is None else d1) + (0.0 if d2 is None
                                                       else d2)
        return cls(ops, name=name, duration=duration)

    @property
    def diagonal(self) -> bool:
        return all(getattr(op, "diagonal", False) for op in self.ops)

    @property
    def shape(self):
        return common.broadcast_shapes(*[op.shape for op in self.ops])

    @property
    def nshift(self):
        return sum(op.nshift for op in self.ops)

    # -- structure: the constituents' parameters, in order --

    def leaves(self):
        return [x for op in self.ops for x in op.leaves()]

    def leaf_dtypes(self):
        return [d for op in self.ops for d in op.leaf_dtypes()]

    def with_leaves(self, values):
        values, ops = list(values), []
        for op in self.ops:
            n = len(op.leaves())
            ops.append(op.with_leaves(values[:n]))
            values = values[n:]
        return self.copy(ops=ops)

    def signature(self):
        return (CombinedOp, tuple(op.signature() for op in self.ops))

    def strip_meta(self):
        return CombinedOp([op.strip_meta() for op in self.ops],
                          name="Combined", duration=0.0)

    def coefficients(self):
        arr, arr0 = self.ops[0].coefficients()
        for op in self.ops[1:]:
            a2, a02 = op.coefficients()
            arr, arr0 = scalar_combine(arr, a2, arr0, a02)
        return arr, arr0

    def matrices(self):
        mat, mat0 = self.ops[0].matrices()
        for op in self.ops[1:]:
            m2, m02 = op.matrices()
            mat, mat0 = matrix_combine(mat, m2, mat0, m02)
        return mat, mat0

    def apply(self, sm):
        if self.diagonal:
            return apply_coefficients(sm, *self.coefficients())
        return apply_matrices(sm, *self.matrices())

    def combine(self, other, *, name=None, duration=None, **kwargs):
        return CombinedOp.of(self, other, name=name, duration=duration)
