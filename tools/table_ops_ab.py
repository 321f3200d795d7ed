#!/usr/bin/env python3
"""Device time of the coordinate-table merges on the card, by piece.

Each piece runs 10 times inside one CUDA graph (the way a memoized
table-train ``simulate()`` replays it), best of 10 replays by CUDA
events, float32 states, at the full widths of ``chip_smoke.phase_table``:

* the shift-prune train's per-atom dense merge (16,384 atoms, 951 rows):
  ``shiftdense.shiftmerge_dense_varying`` beside the three-gathers form
  it replaced (equal results), and its pieces (one per-atom row gather of
  a complex and a float64 plane, a float64 product);
* the float-shift train's shared dense merge (16,384 atoms, 1,245 rows):
  ``shiftdense.shiftmerge_dense`` beside the masked-product form it
  replaced (equal results);
* the 3-D diffusion train's sort merge (4,096 atoms, 1,025 rows, d = 3):
  ``shiftnd.shiftmerge_table`` and its pieces (the sort and cell ids, the
  state accumulation, the magnitudes, the selection, the copy back to the
  (B, C, 3) layout);
* a ladder copy of each state, for scale.

    python3 tools/table_ops_ab.py        # on the GPU machine
"""

import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import epgpy_torch as epg  # noqa: E402
from epgpy_torch.ops import shiftdense, shiftnd  # noqa: E402

F64 = torch.float64


def graph_ms(fn, reps=10, inner=10):
    """Device ms of one fn() inside a CUDA graph of `inner` calls."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / inner)
    return best


def ladder(B, D, gen):
    """A (B, D, 3) complex64 ladder with F-(k) = conj(F+(-k))."""
    fp = torch.randn(B, D, dtype=torch.complex64, device="cuda",
                     generator=gen)
    z = torch.randn(B, D, dtype=torch.complex64, device="cuda",
                    generator=gen)
    z = 0.5 * (z + z.flip(-1).conj())
    return torch.stack([fp, fp.flip(-1).conj(), z], dim=-1)


def cell_means(shape, D, grid, gen):
    """Mean wavenumbers within half a cell of their cells' centers,
    antisymmetric along the rows."""
    k = (torch.arange(D, device="cuda", dtype=F64) - D // 2) * grid
    k = k + (torch.rand(shape + (D,), device="cuda", dtype=F64,
                        generator=gen) - 0.5) * 0.6 * grid
    return 0.5 * (k - k.flip(-1))


def move_rows_gathers(arrs, shifts, base=None):
    """The per-atom moves as three row gathers per array (one per
    correction e), the form ``shiftdense._move_rows`` replaced."""
    D = shifts.shape[-1]
    base = torch.zeros_like(shifts[:, :1]) if base is None else base
    rows = torch.arange(D, device=shifts.device)[None]
    outs = [torch.zeros_like(a) for a in arrs]
    for e in (-1, 0, 1):
        src = rows - base - e
        srcc = src.clamp(0, D - 1)
        sel = ((src >= 0) & (src < D)
               & (torch.gather(shifts, -1, srcc) == base + e))
        for i, a in enumerate(arrs):
            outs[i] = outs[i] + torch.gather(a, -1, srcc) * sel.to(
                a.real.dtype)
    return outs


def varying(gen, out):
    B, D, grid = 16384, 951, 0.5
    st = ladder(B, D, gen)
    wav = cell_means((B,), D, grid, gen)
    delta = (torch.rand(B, device="cuda", dtype=F64, generator=gen) * 2.5
             + 0.5)
    Fp, Z = st[..., 0].contiguous(), st[..., 2].contiguous()
    out["varying merge"] = graph_ms(lambda: shiftdense.shiftmerge_dense_varying(
        Fp, Z, wav, delta, grid))
    steps = shiftdense.shiftmerge_dense_varying(Fp, Z, wav, delta, grid)
    form = shiftdense._move_rows
    shiftdense._move_rows = move_rows_gathers
    try:
        out["varying merge, three gathers per array (replaced)"] = graph_ms(
            lambda: shiftdense.shiftmerge_dense_varying(Fp, Z, wav, delta,
                                                        grid))
        gathers = shiftdense.shiftmerge_dense_varying(Fp, Z, wav, delta,
                                                      grid)
    finally:
        shiftdense._move_rows = form
    diff = max(float((a - b).abs().max()) for a, b in zip(steps, gathers))
    print(f"[table-ops] varying merge: max|steps - gathers| = {diff:.3e}")
    if diff != 0.0:
        raise AssertionError("the two forms of the per-atom merge differ")
    idx = (torch.arange(D, device="cuda")[None] - torch.round(
        delta / grid).long()[:, None]).clamp(0, D - 1)
    out["varying: one (B, D) complex64 row gather"] = graph_ms(
        lambda: torch.gather(Fp, -1, idx))
    out["varying: one (B, D) float64 row gather"] = graph_ms(
        lambda: torch.gather(wav, -1, idx))
    out["varying: one (B, D) float64 product"] = graph_ms(lambda: wav * wav)
    out["varying: ladder copy (B, D, 3)"] = graph_ms(lambda: st.clone())


def dense_masked_product(states, wavenums, delta, grid, tol=1e-8):
    """``shiftdense.shiftmerge_dense`` as first ported: each of the three
    gathers of the flattened ladder multiplied by its row mask, the form
    the zero-column gathers replaced."""
    D = states.shape[-2]
    rdt = states.real.dtype
    dev = states.device
    kL = torch.round(wavenums.reshape(D), decimals=8)
    eZ, e1, m0 = shiftdense._targets(kL, delta, grid, D)
    extra = torch.stack([e1, -e1.flip(0), eZ], dim=-1)
    base = torch.stack([m0, -m0, torch.zeros_like(m0)])
    vals = torch.stack([kL + delta, kL - delta, kL], dim=-1)
    flat = states.reshape(-1, 3 * D)
    w = states.abs().reshape(-1, D, 3).sum(dim=0).to(kL.dtype)
    wk = torch.stack([w, w * vals])
    rows = torch.arange(D, device=dev)[:, None]
    cols = torch.arange(3, device=dev)
    out = wk_out = None
    for e in (-1, 0, 1):
        src = rows - base - e
        srcc = src.clamp(0, D - 1)
        sel = ((src >= 0) & (src < D)
               & (torch.gather(extra, 0, srcc) == e))
        g = flat.index_select(-1, (srcc * 3 + cols).reshape(-1))
        g = g * sel.reshape(-1).to(rdt)
        out = g if out is None else out + g
        gw = torch.gather(wk, 1, srcc.expand(2, D, 3)) * sel.to(wk.dtype)
        wk_out = gw if wk_out is None else wk_out + gw
    w_out, kw_out = wk_out[..., 2] + wk_out[..., 0] + wk_out[..., 1]
    new_k = kw_out / torch.where(w_out > tol, w_out, torch.ones_like(w_out))
    return out.reshape(states.shape), new_k[:, None]


def shared_dense(gen, out):
    B, D, grid = 16384, 1245, 0.5
    st = ladder(B, D, gen)
    wav = cell_means((), D, grid, gen)
    delta = torch.tensor(3.7, dtype=F64, device="cuda")
    out["shared dense merge"] = graph_ms(lambda: shiftdense.shiftmerge_dense(
        st, wav, delta, grid))
    out["shared dense merge, masked products (replaced)"] = graph_ms(
        lambda: dense_masked_product(st, wav, delta, grid))
    a = shiftdense.shiftmerge_dense(st, wav, delta, grid)
    b = dense_masked_product(st, wav, delta, grid)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("the two forms of the shared merge differ")
    out["shared dense: ladder copy"] = graph_ms(lambda: st.clone())


def sort_merge(gen, out):
    B, C, d, grid = 4096, 1025, 3, 1.0
    st = ladder(B, C, gen)
    wav = torch.randn(C, d, dtype=F64, device="cuda", generator=gen) * 20
    wav = 0.5 * (wav - wav.flip(0))
    delta = torch.tensor([1.3, -2.1, 0.4], dtype=F64, device="cuda")
    out["sort merge"] = graph_ms(lambda: shiftnd.shiftmerge_table(
        st, wav, delta, grid))
    cols = shiftnd._shared_cols(st)
    q = torch.round(torch.cat([wav, wav + delta, wav - delta]) / grid).long()
    out["sort: keys, sort, cell ids"] = graph_ms(
        lambda: shiftnd._segments(shiftnd._encode_keys(q[None])))
    seg, ukeys, nseg = shiftnd._segments(shiftnd._encode_keys(q[None]))
    flat = seg[0]
    R = 3 * C

    vals = [torch.view_as_real(c).reshape(C, B, 2) for c in cols]

    def accumulate():
        merged = torch.zeros((3, R, B, 2), device="cuda")
        for j, blk in ((0, 1), (1, 2), (2, 0)):
            merged[j].index_put_((flat[blk * C:(blk + 1) * C],), vals[j],
                                 accumulate=True)
        return merged

    out["sort: zeros + index_put_ accumulation"] = graph_ms(accumulate)
    merged = accumulate()
    out["sort: magnitudes"] = graph_ms(
        lambda: (merged * merged).sum(dim=(0, 2, 3)))
    mag = (merged * merged).sum(dim=(0, 2, 3)).reshape(1, R)
    out["sort: selection"] = graph_ms(
        lambda: shiftnd._select_symmetric(ukeys, mag, nseg, C))
    kept = shiftnd._select_symmetric(ukeys, mag, nseg, C).reshape(-1)
    out["sort: kept rows gather"] = graph_ms(
        lambda: merged.index_select(1, kept))
    sel = torch.view_as_complex(merged.index_select(1, kept)).reshape(
        3, 1, C, B)
    out["sort: back to (B, C, 3)"] = graph_ms(
        lambda: shiftnd._shared_states((sel[0], sel[1], sel[2]), (B,)))
    out["sort: ladder copy"] = graph_ms(lambda: st.clone())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("table_ops_ab: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    epg.config.set_device("cuda")
    epg.config.set_precision("float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for part in (varying, shared_dense, sort_merge):
        part(gen, out)
    for k, v in out.items():
        print(f"[table-ops] {k}: {v:.4f} ms")
    print(card)


if __name__ == "__main__":
    main()
