"""n-dimensional and float-wavenumber shifts on a coordinate table.

Counterpart of ``epgpy_tpu/ops/shiftnd.py`` (the reference's shift-nd,
shift-merge and shift-prune, epgpy/shift.py:297-542; Gao 2021's
three-dimensional spatially resolved phase graph).  The table has a
*fixed* number of rows C.  A shift makes 3C candidate rows (Z stays, F+
moves by +delta, F- by -delta), merges the candidates that fall into one
cell and keeps the C most energetic cells symmetrically around k = 0:

* the cells: a stable ``torch.sort`` of int64 keys, segment ids from the
  sorted keys' heads (a ``cumsum``), and ``index_put_(accumulate=True)``
  of the payloads into 3C fixed rows -- a sort-based accumulation that
  sums a cell's candidates in row order, the same on every run;
* the selection ranks only cells with key > 0 (``key(-q) == -key(q)`` by
  construction), keeps the top ``(C-1)//2`` and mirrors them, so the kept
  set is exactly symmetric and the k = 0 cell sits at row ``(C-1)//2``;
* empty rows carry zero states and coordinate 0: they merge into their
  cells as exact no-ops, no validity mask;
* every shape is fixed and nothing is read back on the host, so a table
  train replays inside the engine's CUDA graph.

The float variant (shift-merge) tracks magnitude-weighted mean
wavenumbers per cell (reference epgpy/shift.py:419-438).  A batch-varying
shift (shift-prune, per-atom tables) runs the same merge over an atom
axis: one batched sort over (B, 3C) keys, the payloads accumulated with
batch offsets.

Not ported, on purpose: the JAX package's one-hot "matmul" engine (an MXU
workaround for the TPU's slow sorts, equal by construction), the
power-of-two padding of the sorted rows and the re/im split of the
payloads (TPU compile-time workarounds), and int32 keys (the keys are
int64 everywhere, so the int32 key-space overflow cannot happen).  The
wavenumber bookkeeping (cells, weights, means) runs in float64 at either
precision (``COORD_DTYPE``), the states in the working one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import common
from ..statematrix import COORD_DTYPE

__all__ = ["apply_shift", "shiftnd_table", "shiftmerge_table",
           "shiftmerge_table_batched"]

_INT = torch.int64


def _encode_keys(q):
    """Antisymmetric lexicographic keys, ``key(-q) == -key(q)``, without
    collisions: q (A, R, d) int64 -> (A, R), the strides from each atom's
    own extent (reference epgpy/shift.py:600-607)."""
    span = 2 * q.abs().amax(dim=-2) + 1                         # (A, d)
    strides = torch.cumprod(torch.cat(
        [torch.ones_like(span[:, :1]), span[:, :-1]], dim=-1), dim=-1)
    return (q * strides[:, None, :]).sum(dim=-1)


def _segments(keys):
    """Cells of the candidate keys (A, R): each candidate's cell id
    (A, R), the cells' keys in ascending order (A, R; the int64 maximum
    past the last cell) and the number of cells (A, 1)."""
    keys_s, order = torch.sort(keys, dim=-1, stable=True)
    head = torch.cat([torch.ones_like(keys_s[:, :1], dtype=torch.bool),
                      keys_s[:, 1:] != keys_s[:, :-1]], dim=-1)
    seg_s = torch.cumsum(head, dim=-1) - 1
    seg = torch.empty_like(seg_s).scatter_(-1, order, seg_s)
    ukeys = torch.full_like(keys_s, torch.iinfo(_INT).max).scatter_(
        -1, seg_s, keys_s)
    return seg, ukeys, seg_s[:, -1:] + 1


def _select_symmetric(ukeys, mag, nseg, C):
    """Cell indices (A, C) of the kept table, mirror-symmetric around
    k = 0: the top ``h = (C-1)//2`` cells of positive key by magnitude
    (ties: the lower key first), the k = 0 cell at row h, each kept
    cell's mirror (cell ``nseg-1-i``: the key set is symmetric) at the
    mirrored row; unused rows point at an empty cell."""
    R = ukeys.shape[-1]
    idx = torch.arange(R, device=ukeys.device)
    valid = idx < nseg
    h = (C - 1) // 2
    score = torch.where(valid & (ukeys > 0), mag,
                        torch.full_like(mag, -math.inf))
    top = torch.argsort(-score, dim=-1, stable=True)[:, :h]
    has = torch.isfinite(torch.gather(score, -1, top))
    # an empty cell: nseg == R only when every candidate is its own cell,
    # and then `has` is all true
    filler = nseg.clamp(max=R - 1).expand_as(top)
    mirror = torch.where(has, nseg - 1 - top, filler)
    top = torch.where(has, top, filler)
    search = torch.where(valid, ukeys,
                         torch.full_like(ukeys, torch.iinfo(_INT).max))
    center = torch.searchsorted(search, torch.zeros_like(nseg))
    return torch.cat([mirror.flip(-1), center, top], dim=-1)


def _table_merge(cols, cand_q, extra, C, wstep=1):
    """The shared merge core.

    cols: (Fp, Fm, Z), each (A, C, Bc) complex -- A tables of C rows,
    each with Bc state columns; cand_q: (A, 3C, d) int64 candidate cells
    in [Z stays | F+ by +delta | F- by -delta] block order; extra:
    (A, 3C, e) real per-candidate columns summed per cell.  The cells are
    ranked by the magnitudes of every `wstep`-th column (1: all; on the
    diff path's planar state the primal plane's, so that the tangent
    planes follow the primal's merge).  Returns the kept (Fp, Fm, Z),
    each (A, C, Bc), and the kept cells' extra (A, C, e)."""
    A, R = cand_q.shape[:2]
    dev = cand_q.device
    seg, ukeys, nseg = _segments(_encode_keys(cand_q))
    offset = torch.arange(A, device=dev)[:, None] * R
    flat = seg + offset                                      # (A, R)
    Bc = cols[0].shape[-1]
    rdt = cols[0].real.dtype
    # each component comes from its own block: Fp from +delta, Fm from
    # -delta, Z from the rows that stay
    merged = torch.zeros((3, A * R, Bc, 2), dtype=rdt, device=dev)
    for j, blk in ((0, 1), (1, 2), (2, 0)):
        idx = flat[:, blk * C:(blk + 1) * C].reshape(-1)
        merged[j].index_put_(
            (idx,), torch.view_as_real(cols[j]).reshape(A * C, Bc, 2),
            accumulate=True)
    mw = merged[:, :, ::wstep]
    mag = (mw * mw).sum(dim=(0, 2, 3)).reshape(A, R)
    e = extra.shape[-1]
    mex = torch.zeros((A * R, e), dtype=extra.dtype, device=dev).index_put_(
        (flat.reshape(-1),), extra.reshape(A * R, e), accumulate=True)
    kept = (_select_symmetric(ukeys, mag, nseg, C) + offset).reshape(-1)
    out = torch.view_as_complex(merged.index_select(1, kept)).reshape(
        3, A, C, Bc)
    return (out[0], out[1], out[2]), mex.index_select(0, kept).reshape(
        A, C, e)


def _shared_cols(states):
    """A shared table's (*batch, C, 3) states as (Fp, Fm, Z) columns,
    each (1, C, Bflat)."""
    C = states.shape[-2]
    flat = states.reshape(-1, C, 3)
    return tuple(flat[..., j].transpose(0, 1)[None] for j in range(3))


def _shared_states(cols, bshape):
    """The inverse of :func:`_shared_cols`."""
    C = cols[0].shape[1]
    return torch.stack([c[0].transpose(0, 1).reshape(bshape + (C,))
                        for c in cols], dim=-1)


def _merge_int(cols, coords, delta, C, wstep=1):
    """Integer merge: coords (A, C, d) int64, delta (A, d) int64."""
    cand_q = torch.cat([coords, coords + delta[:, None],
                        coords - delta[:, None]], dim=-2)
    extra = torch.cat([cand_q.to(COORD_DTYPE), torch.ones_like(
        cand_q[..., :1], dtype=COORD_DTYPE)], dim=-1)
    cols, ex = _table_merge(cols, cand_q, extra, C, wstep)
    cnt = ex[..., -1:].clamp(min=1.0)
    return cols, torch.round(ex[..., :-1] / cnt).to(_INT)


def _merge_float(cols, wavenums, delta, grid, C, tol, wstep=1):
    """Float merge (shift-merge): wavenums (A, C, d), delta (A, d) real;
    the kept cells' magnitude-weighted mean wavenumbers (the weights from
    every `wstep`-th column, as :func:`_table_merge` ranks)."""
    kL = torch.round(wavenums, decimals=8)
    k1 = kL + delta[:, None]
    k2 = kL - delta[:, None]
    # quantize; qL symmetrized as in the reference (epgpy/shift.py:404-406)
    qL = torch.round(0.5 * (kL - kL.flip(-2)) / grid).to(_INT)
    q1 = torch.round(k1 / grid).to(_INT)
    cand_q = torch.cat([qL, q1, -q1.flip(-2)], dim=-2)
    # weights: the state magnitudes summed over the columns (reference
    # epgpy/shift.py:420)
    w = torch.cat([cols[2][..., ::wstep].abs().sum(-1),
                   cols[0][..., ::wstep].abs().sum(-1),
                   cols[1][..., ::wstep].abs().sum(-1)],
                  dim=-1).to(kL.dtype)                         # (A, 3C)
    kcand = torch.cat([kL, k1, k2], dim=-2)
    extra = torch.cat([kcand * w[..., None], w[..., None]], dim=-1)
    cols, ex = _table_merge(cols, cand_q, extra, C, wstep)
    wk = ex[..., -1:]
    return cols, ex[..., :-1] / torch.where(wk > tol, wk,
                                             torch.ones_like(wk))


def _grid(grid, d, ref):
    """The merge grid: a host scalar as it is, per-axis cells as a
    memoized (d,) tensor."""
    if isinstance(grid, torch.Tensor):
        return grid.to(ref.dtype)
    if np.ndim(grid) == 0:
        return float(grid)
    return common.const_tensor(np.broadcast_to(grid, (d,)), ref.dtype,
                               ref.device)


def shiftnd_table(states, coords, delta, C=None, wstep=1):
    """Integer n-D shift on a shared coordinate table.

    states: (..., C, 3) complex; coords: (C, d) int; delta: (d,) int.
    Returns (states', coords') of the same shapes (rows in the kept
    order, the k = 0 cell at row (C-1)//2)."""
    C = states.shape[-2] if C is None else C
    coords = torch.as_tensor(coords, device=states.device).to(_INT)
    delta = torch.as_tensor(delta, device=states.device).to(_INT)
    cols, new = _merge_int(_shared_cols(states), coords.reshape(1, C, -1),
                           delta.reshape(1, -1), C, wstep)
    return _shared_states(cols, tuple(states.shape[:-2])), new[0]


def shiftmerge_table(states, wavenums, delta, grid, C=None, tol=1e-8,
                     wstep=1):
    """Float wavenumber shift with gridded merging (Gao 2021).

    states: (..., C, 3); wavenums: (C, d) float, shared; delta: (d,)
    float; grid: a scalar or (d,) cell size.  Returns (states',
    wavenums')."""
    C = states.shape[-2] if C is None else C
    wavenums = torch.as_tensor(wavenums, device=states.device).to(
        COORD_DTYPE)
    delta = torch.as_tensor(delta, device=states.device).to(COORD_DTYPE)
    d = wavenums.shape[-1]
    cols, new = _merge_float(_shared_cols(states), wavenums.reshape(1, C, d),
                             delta.reshape(1, d), _grid(grid, d, wavenums),
                             C, tol, wstep)
    return _shared_states(cols, tuple(states.shape[:-2])), new[0]


def shiftmerge_table_batched(states, wavenums, delta, grid, tol=1e-8):
    """The shift-prune merge: every atom its own table and its own shift.

    states: (B, C, 3), or (B, P, C, 3) with P planes merged as one table
    (weighted by plane 0); wavenums: (B, C, d); delta: (B, d).  One
    batched sort over the (B, 3C) keys; the per-atom weights are each
    atom's own magnitudes.  Returns (states' of the input's shape,
    wavenums' (B, C, d))."""
    planar = states.ndim == 4
    C = states.shape[-2]
    d = wavenums.shape[-1]
    st = states if planar else states[:, None]
    cols = tuple(st[..., j].transpose(-1, -2) for j in range(3))
    cols, new = _merge_float(cols, wavenums.to(COORD_DTYPE),
                             delta.to(COORD_DTYPE),
                             _grid(grid, d, wavenums), C, tol,
                             st.shape[1])
    out = torch.stack([c.transpose(-1, -2) for c in cols], dim=-1)
    return (out if planar else out[:, 0]), new


def _shift_vector(op, sm, kdim):
    """The shift of `op` as a (*kbatch, kdim) tensor on the state's
    device: int64 for integer shifts, else float64.  A host value is
    copied, a planned (device) leaf used as it is; the static integer
    shift is filled in without a copy."""
    dev = sm.states.device
    if op._kint is not None:
        karr = torch.zeros((1, kdim), dtype=_INT, device=dev)
        karr[0, 0] = op._kint
        return karr
    karr = torch.as_tensor(op.kleaf, device=dev)
    if karr.ndim < 2:
        karr = karr.reshape((1,) * (2 - karr.ndim) + tuple(karr.shape))
    if op._int_table:
        return (torch.round(karr) if karr.is_floating_point()
                else karr).to(_INT)
    return karr.to(COORD_DTYPE)


def apply_shift(op, sm, planes=None):
    """S.apply on a coordinate table (JAX ``shiftnd.apply_shift``).
    ``planes``: the states carry the diff path's P planes on their last
    batch axis, with one table; every plane moves as the primal plane 0,
    whose magnitudes alone weigh and rank the merged cells.

    Picks, as the reference does (epgpy/shift.py:213-254):
      * an integer shift on an integer shared table -> ``shiftnd_table``;
      * the dense rows-are-cells merge where the engine found the train
        eligible (``_dense_grid``: 1-D, shared, no trim possible);
      * a float shift on a shared table -> ``shiftmerge_table``;
      * a batch-varying shift or per-atom tables -> the batch-varying
        dense merge where eligible (``_dense_grid_varying``), else
        ``shiftmerge_table_batched``.
    """
    from . import shiftdense

    kdim = max(op.kdim, sm.kdim if sm.coords is not None else 1)
    is_int = op._int_table
    if sm.coords is None:
        sm = sm.setup_coords(kdim)
        if is_int:
            sm = sm.update(coords=sm.coords.to(_INT))
    elif sm.kdim < kdim:
        sm = sm.setup_coords(kdim)
    karr = _shift_vector(op, sm, sm.kdim)
    if karr.shape[-1] < sm.kdim:
        karr = torch.nn.functional.pad(karr, (0, sm.kdim - karr.shape[-1]))

    coords = sm.coords
    batch_varying = math.prod(karr.shape[:-1]) > 1
    shared = coords.ndim == 2 or all(s == 1 for s in coords.shape[:-2])
    coords_shape = tuple(coords.shape)
    if coords.ndim > 2 and shared:
        coords = coords.reshape(coords.shape[-2:])
    int_path = is_int and not coords.is_floating_point()

    def restore(c):
        # the table keeps its shape: a CUDA graph's carried state
        return c.reshape(coords_shape[:-2] + tuple(c.shape))

    states = sm.states
    wstep = planes or 1
    if int_path and not batch_varying and shared:
        new_states, new_coords = shiftnd_table(states, coords,
                                               karr.reshape(-1),
                                               wstep=wstep)
        return sm.update(states=new_states, coords=restore(new_coords))

    kgrid = sm.options.get("kgrid") or op.kgrid
    if int_path or sm.options.get("_int_grid"):
        # integer data (an integer table, or a float table that only ever
        # takes integer shifts) quantizes exactly on the unit grid
        kgrid = 1.0
    elif kgrid is None:
        raise AttributeError("kgrid not set")
    ktvalue = sm.ktvalue

    if not batch_varying and shared:
        delta = karr.reshape(-1).to(COORD_DTYPE) * ktvalue
        if (sm.options.get("_dense_grid") and sm.kdim == 1
                and not int_path):
            args = (states, (coords * ktvalue).reshape(-1),
                    delta.reshape(()), kgrid)
            new_states, new_k = (
                shiftdense._shiftmerge_dense(*args, planes=planes)
                if planes else shiftdense.shiftmerge_dense(*args))
        else:
            new_states, new_k = shiftmerge_table(states, coords * ktvalue,
                                                 delta, kgrid, wstep=wstep)
        return sm.update(states=new_states, coords=restore(new_k / ktvalue))

    bshape = tuple(states.shape[:-2])
    if planes:
        # per-atom tables: the atoms are the batch without the plane axis
        bshape = bshape[:-1]
    B, C = math.prod(bshape), states.shape[-2]
    delta = karr.to(COORD_DTYPE) * ktvalue
    dshape = tuple(delta.shape[:-1])
    if len(dshape) < len(bshape):       # the append rule
        delta = delta.reshape(dshape + (1,) * (len(bshape) - len(dshape))
                              + tuple(delta.shape[-1:]))
    delta = torch.broadcast_to(delta, bshape + tuple(delta.shape[-1:]))
    cshape = tuple(coords.shape[-2:])
    if planes:
        # the table's plane axis (of 1) and the shift's broadcast one
        coords = coords.reshape(coords.shape[:-3] + cshape)
    wav = torch.broadcast_to(coords * ktvalue, bshape + cshape)
    lead = (B, planes) if planes else (B,)
    # a per-atom table keeps the state's batch shape (with the planar
    # state's plane axis of 1)
    tshape = bshape + ((1,) if planes else ())
    if (sm.options.get("_dense_grid_varying") and sm.kdim == 1
            and not int_path):
        Fp, Z, new_k = shiftdense.shiftmerge_dense_varying(
            states[..., 0].reshape(lead + (C,)),
            states[..., 2].reshape(lead + (C,)),
            wav.reshape(B, C), delta.reshape(B), kgrid)
        new_states = torch.stack([Fp, torch.conj(Fp.flip(-1)), Z],
                                 dim=-1).reshape(states.shape)
        return sm.update(states=new_states, coords=(
            new_k[..., None] / ktvalue).reshape(tshape + (C, 1)))
    new_states, new_k = shiftmerge_table_batched(
        states.reshape(lead + (C, 3)), wav.reshape(B, C, -1),
        delta.reshape(B, -1), kgrid)
    return sm.update(states=new_states.reshape(states.shape),
                     coords=(new_k / ktvalue).reshape(
                         tshape + tuple(new_k.shape[-2:])))
