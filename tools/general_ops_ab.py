#!/usr/bin/env python3
"""Device time of the general path's op applications on the card.

Each form runs 20 times inside one CUDA graph (the way a memoized
general-path ``simulate()`` replays it), best of 10 replays by CUDA
events, on the FISP headline's state: 102,400 atoms, nstate 10, float32.
The port's forms (``T.apply``, the precomputed diagonal apply, ``S``)
run beside the forms they replaced (one complex product per rotation
coefficient on strided (F+, F-, Z) views, per-component diagonal
products, slice copies into a zeroed ladder) and two others (a batched
matmul, a broadcast product summed over the last axis), each checked
against the replaced form.

    python3 tools/general_ops_ab.py        # on the GPU machine
"""

import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import epgpy_torch as epg  # noqa: E402
from epgpy_torch.ops.scalarop import align_batch, precompute_diagonal  # noqa: E402,E501
from epgpy_torch.ops.transition import rotation_elements  # noqa: E402

NATOMS, NSTATE = 102400, 10


def graph_ms(fn, reps=10, inner=20):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("general_ops_ab: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    epg.config.set_device("cuda")
    epg.config.set_precision("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    T1 = torch.linspace(100.0, 3000.0, NATOMS, device="cuda")
    T2 = torch.linspace(10.0, 300.0, NATOMS, device="cuda")
    sm = epg.StateMatrix(nstate=NSTATE).broadcast((NATOMS,))
    sm = epg.E(5.0, T1, T2)(epg.S(1)(epg.T(30.0, 90.0)(sm)))
    alpha = torch.linspace(10.0, 60.0, NATOMS, device="cuda")
    phi = torch.tensor(90.0, device="cuda")
    rot = epg.T(alpha, phi)
    pre = precompute_diagonal(epg.E(5.0, T1, T2))
    s = sm.states

    def matrix():
        m = rotation_elements(alpha, phi)
        return torch.stack(torch.broadcast_tensors(*m), -1).reshape(
            m[0].shape + (3, 3))

    def t_replaced():
        m = [align_batch(torch.atleast_1d(e), sm.ndim, 0)[..., None]
             for e in rotation_elements(alpha, phi)]
        return torch.stack([m[3 * i] * s[..., 0] + m[3 * i + 1] * s[..., 1]
                            + m[3 * i + 2] * s[..., 2] for i in range(3)],
                           dim=-1)

    forms = {
        "T replaced (9 products on strided views)": t_replaced,
        "T port (3 whole-ladder multiply-adds)": lambda: rot.apply(sm).states,
        "T batched matmul": lambda: torch.matmul(s, matrix().transpose(
            -1, -2)),
        "T broadcast product, sum": lambda: (s[..., None, :] * matrix()[
            :, None]).sum(-1),
    }

    def e_replaced():
        a = [pre.aFp[:, None], torch.conj(pre.aFp)[:, None],
             pre.aZ[:, None]]
        comps = [s[..., i] * a[i] for i in range(3)]
        comps[2] = comps[2] + pre.rec[:, None] * sm.equilibrium[..., 2]
        return torch.stack(torch.broadcast_tensors(*comps), dim=-1)

    forms["E replaced (per-component products)"] = e_replaced
    forms["E port (product + fused recovery)"] = \
        lambda: pre.apply(sm).states

    def s_replaced():
        out = torch.zeros_like(s)
        out[..., 1:, 0] = s[..., :-1, 0]
        out[..., :-1, 1] = s[..., 1:, 1]
        out[..., 2] = s[..., 2]
        return out

    shift = epg.S(1)
    forms["S replaced (slice copies)"] = s_replaced
    forms["S port (one gather, masked)"] = lambda: shift(sm).states
    forms["copy of the ladder (51.6 MB)"] = lambda: s.clone()

    refs = {"T": t_replaced(), "E": e_replaced(), "S": s_replaced()}
    print(f"[ops] {card}; state {tuple(s.shape)} {s.dtype}")
    for name, fn in forms.items():
        ref = refs.get(name[0])
        err = "" if ref is None else \
            f", max|form - replaced| {float((fn() - ref).abs().max()):.3e}"
        print(f"[ops] {name}: {graph_ms(fn):.4f} ms{err}")


if __name__ == "__main__":
    main()
