#!/usr/bin/env python3
"""The serving match's score precision on the GPU, A/B in one process.

The serving phase's 8,192 voxels (``chip_smoke.phase_mesh``'s: seeded
truth, random complex PD, noise 0.002) against the headline dictionary
(102,400 atoms x 1000 pulses, nstate 10, normalized in float64), matched
by ``dictionary_match`` whole and over a mesh of four shards on one card
(``[cuda:0] * 4``), in atom chunks of 16,384: on the float32 dictionary
and signals (float32 scores, true float32 products) and on float64 copies
of them made before the timing (float64 scores).  Prints, for each form,
how many voxels the sharded match gives the whole one's atom and map, the
correlations' gap at a differing voxel, and the match times (host clock
ending in a sync, best of 3), in turns: float32, float64, float64,
float32.  With the card's name and power limit.

    python3 tools/match_precision_ab.py          # on the GPU machine
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

CHUNK, SHARDS = 16384, 4


def timed(fn, reps=3):
    best, out = float("inf"), None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return out, best


def main():
    card = chip_smoke.phase_environment(torch)
    import epgpy_torch as epg
    from epgpy_torch.models.mrf import fisp_mrf_dictionary
    from epgpy_torch.parallel import dictionary_match, make_mesh
    from epgpy_torch.parallel.match import _normalize_rows

    epg.config.set_device("cuda")
    epg.config.set_precision("float32")
    chip_smoke._timed(chip_smoke.phase_build)
    cs = chip_smoke

    def cuda32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device="cuda")

    FA = cs.make_train(cs.NPULSE)
    T1, T2, B1 = cs.make_atoms(cs.NATOMS)
    re, im = fisp_mrf_dictionary(FA, cs.TR, cs.TE, cuda32(T1), cuda32(T2),
                                 cuda32(B1), nstate=cs.NSTATE)
    dre, dim = _normalize_rows(re, im)[:2]
    del re, im
    rng = np.random.default_rng(cs.SEED)
    T1t = rng.uniform(300.0, 2500.0, cs.NVOX)
    T2t = np.minimum(rng.uniform(30.0, 200.0, cs.NVOX), 0.5 * T1t)
    B1t = rng.uniform(0.75, 1.25, cs.NVOX)
    pd = rng.uniform(0.5, 2.0, cs.NVOX) * np.exp(2j * np.pi
                                                 * rng.random(cs.NVOX))
    noise = cs.NOISE * (rng.standard_normal((cs.NPULSE, cs.NVOX))
                        + 1j * rng.standard_normal((cs.NPULSE, cs.NVOX)))
    cre, cim = fisp_mrf_dictionary(FA, cs.TR, cs.TE, cuda32(T1t),
                                   cuda32(T2t), cuda32(B1t),
                                   nstate=cs.NSTATE)
    meas = (torch.complex(cre, cim)
            * torch.as_tensor(pd.astype(np.complex64), device="cuda")[:, None]
            + torch.as_tensor(noise.T.astype(np.complex64), device="cuda"))
    sre, sim = meas.real.contiguous(), meas.imag.contiguous()
    grid = torch.as_tensor(np.stack([T1, T2, B1], -1), device="cuda")
    mesh = make_mesh([torch.device("cuda", 0)] * SHARDS)

    inputs = {"float32": (dre, dim, sre, sim),
              "float64": tuple(x.double() for x in (dre, dim, sre, sim))}
    forms = {k: (lambda a=a: dictionary_match(*a, atom_chunk=CHUNK),
                 lambda a=a: dictionary_match(*a, mesh, atom_chunk=CHUNK))
             for k, a in inputs.items()}
    times = {k: [] for k in forms}
    for name in ("float32", "float64", "float64", "float32"):
        whole, sharded = forms[name]
        (i0, v0), t0 = timed(whole)
        (i1, v1), t1 = timed(sharded)
        times[name].append((t0, t1))
        same_map = (grid[i0] == grid[i1]).all(dim=-1)
        differ = int((~same_map).sum())
        gap = (float((v0 - v1)[~same_map].abs().max() / v0.abs().max())
               if differ else 0.0)
        print(f"[match-ab] {name} scores: sharded over {mesh} picks the "
              f"whole match's atom for {int((i0 == i1).sum())} of "
              f"{cs.NVOX} voxels, its map for {cs.NVOX - differ} "
              f"({differ} differ, correlations {gap:.3e} apart); match "
              f"{t0 * 1e3:.1f} ms whole, {t1 * 1e3:.1f} ms sharded ({card})")
    print(f"[match-ab] times (whole, sharded) s: {times}")
    print(card)


if __name__ == "__main__":
    main()
