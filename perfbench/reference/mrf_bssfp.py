"""Plain reference of the bSSFP MRF configuration (Ma et al. 2013).

A frozen, independent copy of the balanced-SSFP recurrence: the train
``T(180, 0), E(TI), [T(FA_i, phase_i), E(TR_i / 2), ADC(-phase_i),
E(TR_i / 2)] x P`` with off-resonance df (kHz) precessing F+ by
e^{2 pi i df t}.  A balanced train never leaves k = 0, so an atom's state
is F+(0), F-(0) = conj F+(0) and a real Z(0).  Vectorised over atoms in
real arithmetic of plain PyTorch; it imports nothing of the program.  The
benchmark builds the train and the atom grid here too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

AXES = ("T1", "T2", "df")


def train(cfg):
    """Per-pulse flips, RF phases (deg), TRs and TEs (ms), and the prep."""
    t = cfg["train"]
    P = int(t["npulse"])
    i = np.arange(P)
    fa = t["fa_base_deg"] + t["fa_amp_deg"] * np.abs(
        np.sin(i * 2 * np.pi / t["fa_period"]))
    tr = t["tr_base_ms"] + t["tr_amp_ms"] * np.sin(i / t["tr_period"])
    phase = np.cumsum(np.full(P, t["phase_step_deg"])) % 360.0
    return {"FA": fa, "phase": phase, "TR": tr, "TE": tr * t["te_over_tr"],
            "TI": float(t["inversion_ms"]),
            "demodulate": bool(t["demodulate"])}


def grid_axes(cfg):
    g = cfg["grid"]
    return [np.linspace(g[a][0], g[a][1], int(g[a][2])) for a in AXES]


def constrain(cfg, params):
    """Nothing to keep: the grid's T2 stays below its T1 throughout."""
    return params


def grid(cfg):
    """(B, 3) float64 atoms (T1, T2, df), T1 slowest."""
    g = np.stack(np.meshgrid(*grid_axes(cfg), indexing="ij"), -1)
    return g.reshape(-1, 3)


def steps(cfg):
    return np.array([a[1] - a[0] for a in grid_axes(cfg)])


def fingerprints(cfg, params, *, dtype=torch.float64, normalize=False):
    """(B, P) fingerprints of atoms `params` (B, 3) = (T1, T2, df) on
    params' device, computed in `dtype`; with `normalize`, unit rows.
    Returns complex128 for float64, else complex64."""
    tr = train(cfg)
    p = params.to(torch.float64)
    re, im = _echoes(tr, p[:, 0], p[:, 1], p[:, 2], dtype)
    if normalize:
        n = torch.sqrt(torch.sum(re * re + im * im, dim=0, keepdim=True))
        n = torch.where(n > 0, n, torch.ones_like(n))
        re, im = re / n, im / n
    out = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.complex(re.T.to(out), im.T.to(out))


def _relax(fr, fi, z, t, T1, T2, df, dtype):
    """E(t): F+ decays by e^{-t/T2} and precesses by 2 pi df t; Z recovers."""
    e1, e2 = torch.exp(-t / T1), torch.exp(-t / T2)
    th = 2 * math.pi * df * t
    c, s = (e2 * torch.cos(th)).to(dtype), (e2 * torch.sin(th)).to(dtype)
    e1 = e1.to(dtype)
    return c * fr - s * fi, s * fr + c * fi, e1 * z + (1 - e1)


def _echoes(tr, T1, T2, df, dtype):
    P, B = len(tr["FA"]), T1.shape[0]
    dev = T1.device
    fr = torch.zeros(B, dtype=dtype, device=dev)
    fi = torch.zeros_like(fr)
    z = torch.ones_like(fr)
    # the 180 inversion about x (phase 0): F+ -> conj F+, Z -> -Z
    fi, z = -fi, -z
    fr, fi, z = _relax(fr, fi, z, tr["TI"], T1, T2, df, dtype)
    out_re = torch.empty((P, B), dtype=dtype, device=dev)
    out_im = torch.empty_like(out_re)
    for i in range(P):
        a, ph = math.radians(tr["FA"][i]), math.radians(tr["phase"][i])
        c, s = math.cos(a), math.sin(a)
        c2, s2 = (1 + c) / 2, (1 - c) / 2
        cp, sp, c2p, s2p = (math.cos(ph), math.sin(ph), math.cos(2 * ph),
                            math.sin(2 * ph))
        # F+' = c2 F+ + e^{2i ph} s2 conj(F+) - i e^{i ph} s Z
        nfr = c2 * fr + s2 * (c2p * fr + s2p * fi) + s * sp * z
        nfi = c2 * fi + s2 * (s2p * fr - c2p * fi) - s * cp * z
        # Z' = s Im(e^{-i ph} F+) + c Z
        nz = s * (cp * fi - sp * fr) + c * z
        er, ei, _ = _relax(nfr, nfi, nz, tr["TE"][i], T1, T2, df, dtype)
        if tr["demodulate"]:
            er, ei = cp * er + sp * ei, cp * ei - sp * er
        out_re[i], out_im[i] = er, ei
        fr, fi, z = _relax(nfr, nfi, nz, tr["TR"][i], T1, T2, df, dtype)
    return out_re, out_im
