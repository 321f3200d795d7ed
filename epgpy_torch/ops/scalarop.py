"""Diagonal (per-component) operators.

Counterpart of ``epgpy_tpu/ops/scalarop.py``.  A diagonal op multiplies
each k-state's ``(F+, F-, Z)`` vector elementwise by a coefficient
triplet ``arr`` and adds a recovery term ``arr0 * equilibrium`` (reference
epgpy/opscalar.py:213-232).  The triplet must satisfy the ladder symmetry
``arr == conj(arr[..., (1, 0, 2)])`` so that the state matrix's conjugate
symmetry is preserved.

* :class:`ScalarOp` is the user class (``arr``, ``arr0``, custom
  derivative arrays ``darrs``/``d2arrs``); the physics ops E/P/R
  (evolution.py) subclass it and build their coefficients from their
  parameters;
* :class:`PrecomputedDiagonal` holds coefficients evaluated once: the scan
  planner (engine.py) turns E/P/R slots of a periodic block into it, over
  the whole repetition axis when they vary (:func:`precompute_diagonal`),
  so a step reads coefficients instead of evaluating ``exp``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import common, config
from . import base

__all__ = ["ScalarOp", "PrecomputedDiagonal", "precompute_diagonal",
           "scalar_combine", "align_batch", "apply_coefficients",
           "apply_coefficient_elements", "complex_tensor"]


def align_batch(arr, sm_batch_ndim: int, core_ndim: int):
    """Left-align operator batch dims with state batch dims: insert
    singleton axes between the operator's batch and core axes, so that
    ordinary broadcasting implements the append rule."""
    nbatch = arr.ndim - core_ndim
    missing = sm_batch_ndim - nbatch
    if missing <= 0:
        return arr
    return arr.reshape(arr.shape[:nbatch] + (1,) * missing
                       + arr.shape[nbatch:])


def extend_operators(core_ndim: int, *arrs):
    """Align operator arrays' batch axes (left-aligned), keeping their
    ``core_ndim`` trailing axes (JAX ``common.extend_operators``)."""
    nbatch = max((a.ndim - core_ndim for a in arrs if a is not None),
                 default=0)
    return tuple(None if a is None else align_batch(a, nbatch, core_ndim)
                 for a in arrs)


def complex_tensor(x):
    """A host value or tensor as a complex tensor of the working precision
    on the working device (None passes; tensors keep autodiff state)."""
    if x is None:
        return None
    return torch.as_tensor(x, dtype=config.complex_dtype(),
                           device=config.device())


def apply_coefficients(sm, arr, arr0=None):
    """states = arr * states [+ arr0 * equilibrium]; arr/arr0 are
    (*batch, 3) complex triplets (one product over the whole ladder, the
    recovery as one fused multiply-add)."""
    states = sm.states * align_batch(arr, sm.ndim, 1)[..., None, :]
    if arr0 is not None:
        states = torch.addcmul(states, align_batch(arr0, sm.ndim, 1)[
            ..., None, :], sm.equilibrium)
    return sm.update(states=states)


def apply_coefficient_elements(sm, elems, elems0=None):
    """Element form of :func:`apply_coefficients`: ``elems`` holds the
    three (batch-shaped) coefficients (aFp, aFm, aZ); ``elems0`` the
    recovery coefficients, any of which may be None."""
    if elems0 is not None and all(e is None for e in elems0):
        elems0 = None
    return apply_coefficients(sm, *stack_elements(elems, elems0))


def stack_elements(elems, elems0):
    """(arr, arr0) (*batch, 3) triplets from element-form coefficients
    (absent recovery elements are 0)."""
    def stack(es):
        es = [torch.atleast_1d(e) for e in es]
        arr = torch.stack(torch.broadcast_tensors(*es), dim=-1)
        return arr

    arr = stack(elems)
    if elems0 is None:
        return arr, None
    ref = next(e for e in elems0 if e is not None)
    arr0 = stack([torch.zeros_like(ref) if e is None else e for e in elems0])
    return extend_operators(1, arr, arr0)


def _format_triplet(arr, check=True):
    """Host-side validation of a (..., 3) coefficient array."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim < 2 or arr.shape[-1] != 3:
        raise ValueError(f"Expected (..., 3) coefficient array, got "
                         f"{arr.shape}")
    if check and not np.allclose(arr, np.conj(arr[..., (1, 0, 2)])):
        raise ValueError("Coefficients break ladder conjugate symmetry")
    return arr


def pack_diff_arrays(darrs, d2arrs):
    """User derivative arrays as ``{"d1": {param: (d, d0)}, "d2": {pair:
    (d, d0)}}`` (reference epgpy/opscalar.py darrs/d2arrs), or None."""
    def norm(entry):
        return tuple(entry) if isinstance(entry, (tuple, list)) \
            else (entry, None)

    out = {}
    if darrs:
        out["d1"] = {p: norm(v) for p, v in darrs.items()}
    if d2arrs:
        out["d2"] = {tuple(sorted(p)): norm(v) for p, v in d2arrs.items()}
    return out or None


def apply_diff_arrays_to(new, lin, quad, fields=("arr", "arr0")):
    """Shift ``new``'s coefficient fields by its user derivative arrays;
    returns the parameters handled:

        arr(eps) = arr + sum_p delta_p darr_p
                 + sum_{p1<=p2} lin_p1 lin_p2 d2arr (x 1/2 if p1 == p2)
    """
    da = new.diff_arrays or {}
    d1, d2 = da.get("d1", {}), da.get("d2", {})
    main, rec = fields
    arr = complex_tensor(getattr(new, main))
    arr0 = complex_tensor(getattr(new, rec))
    add, add0 = 0.0, 0.0
    handled = set()
    for p, (d, d0) in d1.items():
        if p not in lin and p not in quad:
            continue
        delta = lin.get(p, 0.0) + quad.get(p, 0.0)
        add = add + delta * complex_tensor(d)
        if d0 is not None:
            add0 = add0 + delta * complex_tensor(d0)
        handled.add(p)
    for (p1, p2), (d, d0) in d2.items():
        if p1 not in lin or p2 not in lin:
            continue
        dd = (0.5 if p1 == p2 else 1.0) * lin[p1] * lin[p2]
        add = add + dd * complex_tensor(d)
        if d0 is not None:
            add0 = add0 + dd * complex_tensor(d0)
        handled.update((p1, p2))
    if handled or d2:
        setattr(new, main, arr + add)
        if arr0 is None and not isinstance(add0, float):
            arr0 = add0
        elif arr0 is not None:
            arr0 = arr0 + add0
        setattr(new, rec, arr0)
    return handled


class ScalarOp(base.DiffOperator, base.CombinableOperator):
    """Diagonal operator: ``states = arr * states [+ arr0 * equilibrium]``.

    `arr`/`arr0` are (..., 3) complex triplets.  `darrs`/`d2arrs` supply
    custom first/second derivative arrays keyed by parameter name
    (reference epgpy/opscalar.py API); with an `order1`/`order2` spec the
    diff layer shifts `arr` by them.  ``check=False`` skips the symmetry
    check of host coefficients.
    """

    PARAMS = ("arr", "arr0")
    diagonal = True
    diff_arrays = None
    #: ``axes=`` pinning of the parameter batch axes (common.set_axes)
    axes = None

    def __init__(self, arr, arr0=None, *, darrs=None, d2arrs=None,
                 axes=None, name=None, duration=None, check=True, **kwargs):
        if isinstance(arr, torch.Tensor):
            arr = arr[None] if arr.ndim == 1 else arr
            # device coefficients are unverified: the dense table engines
            # (which assume F-(k) = conj(F+(-k))) stay off
            self.preserves_ladder_symmetry = False
        else:
            arr = _format_triplet(arr, check=check)
            if arr0 is not None:
                arr0 = _format_triplet(arr0, check=check)
                arr, arr0 = np.broadcast_arrays(arr, arr0)
            if not check:
                sym = np.allclose(arr, np.conj(arr[..., (1, 0, 2)]))
                if arr0 is not None:
                    sym = sym and np.allclose(
                        arr0, np.conj(arr0[..., (1, 0, 2)]))
                self.preserves_ladder_symmetry = bool(sym)
        self.arr, self.arr0 = arr, arr0
        self.axes = axes
        self.diff_arrays = pack_diff_arrays(darrs, d2arrs)
        if darrs or d2arrs:
            self.PARAMETERS_ORDER1 = frozenset(darrs or ()) | {
                p for pair in (d2arrs or ()) for p in pair}
        super().__init__(name=name or "ScalarOp", duration=duration,
                         **kwargs)

    def apply_diff_arrays(self, lin, quad):
        return apply_diff_arrays_to(self, lin, quad, ("arr", "arr0"))

    @property
    def shape(self):
        return common.shape_with_axes(tuple(self.arr.shape[:-1]), self.axes)

    def coefficients(self):
        """(arr, arr0) complex (*batch, 3) triplets on the device."""
        arr, arr0 = complex_tensor(self.arr), complex_tensor(self.arr0)
        if self.axes is not None:
            arr = common.set_axes(1, arr, self.axes)
            arr0 = None if arr0 is None else common.set_axes(1, arr0,
                                                             self.axes)
        return arr, arr0

    def coefficient_elements(self):
        """((aFp, aFm, aZ), (a0Fp, a0Fm, a0Z) | None): batch arrays."""
        arr, arr0 = self.coefficients()
        elems = (arr[..., 0], arr[..., 1], arr[..., 2])
        elems0 = None if arr0 is None else (
            arr0[..., 0], arr0[..., 1], arr0[..., 2])
        return elems, elems0

    def _pin_elements(self, elems, elems0):
        """``axes=`` pinning of element-form coefficients (JAX
        ``ScalarOp._pin_elements``)."""
        if self.axes is None:
            return elems, elems0

        def pin(e):
            return None if e is None else common.set_axes(
                0, torch.atleast_1d(e), self.axes)

        return (tuple(pin(e) for e in elems),
                None if elems0 is None else tuple(pin(e) for e in elems0))

    def matrices(self):
        """The diagonal promoted to (mat, mat0) 3x3 matrices."""
        arr, arr0 = self.coefficients()
        eye = torch.eye(3, dtype=arr.dtype, device=arr.device)
        return (arr[..., None] * eye,
                None if arr0 is None else arr0[..., None] * eye)

    def apply(self, sm):
        return apply_coefficients(sm, *self.coefficients())

    # -- combination (reference epgpy/opscalar.py:101-147) --

    def combine(self, other, *, name=None, duration=None, **kwargs):
        from .combined import CombinedOp
        return CombinedOp.of(self, other, name=name, duration=duration)


def scalar_combine(arr1, arr2, arr01=None, arr02=None):
    """Compose two diagonal ops: first arr1, then arr2."""
    arr1, arr2, arr01, arr02 = extend_operators(1, arr1, arr2, arr01, arr02)
    arr = arr2 * arr1
    if arr01 is None and arr02 is None:
        arr0 = None
    elif arr01 is None:
        arr0 = arr02
    else:
        arr0 = arr2 * arr01
        if arr02 is not None:
            arr0 = arr0 + arr02
    return arr, arr0


class PrecomputedDiagonal(base.Operator):
    """Diagonal op with precomputed element coefficients (engine-internal):
    ``aFp`` (F- takes its conjugate), ``aZ`` and the Z recovery ``rec``
    (None without recovery), complex tensors on the working device.  In a
    scan block's stacked slot they carry a leading repetition axis."""

    PARAMS = ("aFp", "aZ", "rec")

    def __init__(self, aFp, aZ, rec=None, name=None, **kwargs):
        self.aFp, self.aZ, self.rec = aFp, aZ, rec
        super().__init__(name=name or "PrecomputedDiagonal", **kwargs)

    @property
    def shape(self):
        return common.broadcast_shapes(tuple(self.aFp.shape),
                                       tuple(self.aZ.shape), (1,))

    def apply(self, sm):
        elems0 = None if self.rec is None else (None, None, self.rec)
        return apply_coefficient_elements(
            sm, (self.aFp, torch.conj(self.aFp), self.aZ), elems0)


#: memory guard of :func:`precompute_diagonal`: keep the parameter form
#: when the coefficients would claim more than this many bytes
PRECOMPUTE_MAX_BYTES = 1_500_000_000


def precompute_diagonal(op, reps=None):
    """A PrecomputedDiagonal of an E/P/R op (None past the memory guard).

    With ``reps`` the op is a stacked scan slot (a leading repetition axis
    on its parameters) and constant elements get that axis; without, it
    is one scan-constant op.  Coefficients are evaluated here, once.  A
    pinned op (``axes=``) keeps its parameter form (JAX
    ``scalarop.py:263``): its elements are pinned, and a stacked
    repetition axis would be pinned with them."""
    if op.axes is not None:
        return None
    nelem = max([int(np.prod(common.get_shape(x))) for x in op.leaves()
                 if x is not None] + [1])
    itemsize = torch.empty((), dtype=config.complex_dtype()).element_size()
    if 3 * itemsize * nelem > PRECOMPUTE_MAX_BYTES:
        return None
    elems, elems0 = op.coefficient_elements()

    def fix(e):
        if e is None:
            return None
        e = e.to(config.complex_dtype())
        if reps is not None and e.ndim == 0:
            e = e.expand(reps)
        return e

    return PrecomputedDiagonal(fix(elems[0]), fix(elems[2]),
                               None if elems0 is None else fix(elems0[2]))
