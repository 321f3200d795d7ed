"""Dense-grid float-shift merges: rows are grid cells.

Counterpart of ``epgpy_tpu/ops/shiftdense.py``.  For 1-D float shifts
whose capacity covers the train's whole wavenumber range (the engine
decides: ``engine._dense_bound`` / ``_dense_varying_bound``), the table
merge of ``shiftnd.py`` needs no sort:

* grid cell q sits at ladder row ``q + D//2``, so rows ARE cells;
* a shift by delta moves a row by ``round(delta/grid)`` plus a per-row
  correction in {-1, 0, +1} (a row's magnitude-weighted mean wavenumber
  lies within half a cell of its cell's center), so each component moves
  by three zero-filled row gathers with masks -- index gathers times a
  validity mask, never a wrap-around roll;
* candidates landing on one row add, in a fixed order: the cell merge;
* the mean-wavenumber bookkeeping (reference epgpy/shift.py:419-438)
  rides along as two columns, ``w`` and ``w * k``.

Under those conditions the cells hold exactly what the table engines
compute.  The wavenumber bookkeeping runs in the table's float64, the
states in the working precision.  The batch-varying form (the reference's shift-prune, per-atom
shifts and per-atom means) gathers each atom's rows from its own base
offset once, then applies the three corrections as static row steps (the
cells of JAX's "gather" and masked-roll kernels alike) and keeps the F-
column as the mirror of F+.
"""

from __future__ import annotations

import torch

__all__ = ["shiftmerge_dense", "shiftmerge_dense_varying"]

_INT = torch.int64


def _targets(kL, delta, grid, D):
    """Per-row corrections (eZ, e1) and the base move m0: Z goes to row
    + eZ, F+ to row + m0 + e1 (cells quantized as the table merge does)."""
    cells = torch.arange(D, device=kL.device) - D // 2
    qL = torch.round(0.5 * (kL - kL.flip(0)) / grid).to(_INT)
    m0 = torch.round(delta / grid).to(_INT)
    q1 = torch.round((kL + delta) / grid).to(_INT)
    return qL - cells, q1 - cells - m0, m0


def shiftmerge_dense(states, wavenums, delta, grid, tol=1e-8):
    """1-D gridded float-shift merge on a dense cell ladder (see
    :func:`_shiftmerge_dense`)."""
    return _shiftmerge_dense(states, wavenums, delta, grid, tol)


def _shiftmerge_dense(states, wavenums, delta, grid, tol=1e-8,
                      planes=None):
    """1-D gridded float-shift merge on a dense cell ladder.

    states: (*batch, D, 3) complex, row r holding cell ``r - D//2``;
    wavenums: (D,) mean wavenumbers; delta: a 0-d tensor; grid: the cell
    size.  Returns (states', wavenums' (D, 1)): the cells of
    ``shiftnd.shiftmerge_table`` where no trim happens, placed by cell.

    Row r of component c moves to ``r + base[c] + extra[r, c]`` (F+ by
    m0 + e1, F- by -m0 + e2 with e2 its mirror, Z by eZ), extra in {-1,
    0, 1}: for each e one gather of the flattened (B, 3D) ladder (rows
    whose correction is not e read a zero column), the three added in the
    order -1, 0, +1.  ``planes``: the states carry the diff path's P
    planes on their last batch axis, the weights read the primal plane.
    """
    D = states.shape[-2]
    dev = states.device
    kL = torch.round(wavenums.reshape(D), decimals=8)
    eZ, e1, m0 = _targets(kL, delta, grid, D)
    extra = torch.stack([e1, -e1.flip(0), eZ], dim=-1)          # (D, 3)
    base = torch.stack([m0, -m0, torch.zeros_like(m0)])         # (3,)
    vals = torch.stack([kL + delta, kL - delta, kL], dim=-1)    # (D, 3)
    # the flattened (B, 3D) ladder and a zero column (3D) that masked-out
    # entries read
    flat = states.reshape(-1, 3 * D)
    flat = torch.cat([flat, torch.zeros_like(flat[:, :1])], dim=-1)
    # the magnitude weights, summed over the batch (reference
    # epgpy/shift.py:420), and the weighted wavenumbers
    prim = states if not planes else states[..., 0, :, :]
    w = prim.abs().reshape(-1, D, 3).sum(dim=0).to(kL.dtype)
    wk = torch.stack([w, w * vals])                             # (2, D, 3)
    rows = torch.arange(D, device=dev)[:, None]
    cols = torch.arange(3, device=dev)
    out = wk_out = None
    for e in (-1, 0, 1):
        src = rows - base - e
        srcc = src.clamp(0, D - 1)
        sel = ((src >= 0) & (src < D)
               & (torch.gather(extra, 0, srcc) == e))
        g = flat.index_select(-1, torch.where(
            sel, srcc * 3 + cols, 3 * D).reshape(-1))
        out = g if out is None else out.add_(g)
        gw = torch.gather(wk, 1, srcc.expand(2, D, 3)) * sel.to(wk.dtype)
        wk_out = gw if wk_out is None else wk_out + gw
    w_out, kw_out = wk_out[..., 2] + wk_out[..., 0] + wk_out[..., 1]
    new_k = kw_out / torch.where(w_out > tol, w_out, torch.ones_like(w_out))
    return out.reshape(states.shape), new_k[:, None]


def _step(x, e):
    """The rows of x (..., D) moved by a static e in {-1, 0, 1}:
    ``out[..., r] = x[..., r - e]``, zero-filled."""
    if e == 0:
        return x
    zero = torch.zeros_like(x[..., :1])
    if e > 0:
        return torch.cat([zero, x[..., :-1]], dim=-1)
    return torch.cat([x[..., 1:], zero], dim=-1)


def _move_rows(arrs, shifts, base=None):
    """Per-atom row moves: row r of atom b goes to ``r + shifts[b, r]``
    where that is ``base[b] + e``, e in {-1, 0, 1}; arrs and shifts
    (B, D), base (B, 1) or None (0).  One row gather per array by the
    atom's base (into rows -1..D: a row the base moves one past an edge
    may step back in), then the three corrections as static row steps of
    the masked rows, added in the order -1, 0, +1."""
    D = shifts.shape[-1]
    if base is not None:
        src = torch.arange(-1, D + 1, device=shifts.device)[None] - base
        valid = (src >= 0) & (src < D)
        srcc = src.clamp(0, D - 1)
        arrs = [torch.gather(a, -1, srcc) * valid for a in arrs]
        shifts = torch.where(valid, torch.gather(shifts, -1, srcc) - base,
                             torch.full_like(srcc, 2))
    outs = None
    for e in (-1, 0, 1):
        m = shifts == e
        terms = [_step(a * m, e) for a in arrs]
        outs = terms if outs is None else [o + t for o, t in zip(outs, terms)]
    return outs if base is None else [o[..., 1:-1] for o in outs]


def shiftmerge_dense_varying(Fp, Z, wavenums, delta, grid, tol=1e-8):
    """Batch-varying dense merge (the reference's shift-prune,
    epgpy/shift.py:478-542): every atom its own shift and its own mean
    wavenumbers, per-atom weights.

    Fp, Z: (B, D) complex, row r holding cell ``r - D//2``, or (B, P, D)
    with the diff path's P planes (moved as the primal plane 0, whose
    magnitudes weigh); wavenums: (B, D); delta: (B,) real.  The F- column is the mirror of F+ (the
    reference's prune path assumes the ladder symmetry too).  Returns
    (Fp', Z', wavenums' (B, D))."""
    D = Fp.shape[-1]
    planar = Fp.ndim == 3
    if planar:
        # every plane moves as the primal's rows: one (B * P) batch of
        # rows with per-atom moves and weights repeated over the planes
        P = Fp.shape[1]
        wZ1 = Z[:, :1].abs().expand(Z.shape).reshape(-1, D)
        wFp1 = Fp[:, :1].abs().expand(Fp.shape).reshape(-1, D)
        Fp, Z = Fp.reshape(-1, D), Z.reshape(-1, D)
        wavenums = wavenums.repeat_interleave(P, dim=0)
        delta = delta.repeat_interleave(P, dim=0)
    kL = torch.round(wavenums, decimals=8)
    cells = (torch.arange(D, device=Fp.device) - D // 2)[None]
    qL = torch.round(0.5 * (kL - kL.flip(-1)) / grid).to(_INT)
    eZ = qL - cells                                # in {-1, 0, 1}
    k1 = kL + delta[:, None]
    t1 = torch.round(k1 / grid).to(_INT) - cells
    m0 = torch.round(delta / grid).to(_INT)[:, None]
    wZ = (wZ1 if planar else Z.abs()).to(kL.dtype)
    Z2, wZ2, kwZ2 = _move_rows([Z, wZ, wZ * kL], eZ)
    wFp = (wFp1 if planar else Fp.abs()).to(kL.dtype)
    Fp2, wFp2, kwFp2 = _move_rows([Fp, wFp, wFp * k1], t1, m0)
    w_out = wZ2 + wFp2 + wFp2.flip(-1)
    kw_out = kwZ2 + kwFp2 - kwFp2.flip(-1)
    new_k = kw_out / torch.where(w_out > tol, w_out, torch.ones_like(w_out))
    if planar:
        return (Fp2.reshape(-1, P, D), Z2.reshape(-1, P, D),
                new_k.reshape(-1, P, D)[:, 0])
    return Fp2, Z2, new_k
