"""Plain reference of the MRF-FISP configuration (Jiang et al. 2015).

A frozen, independent copy of the extended phase graph recurrence of the
train ``[T(FA_i * B1, phase), E(TE), ADC, E(TR - TE), S(1)] x P`` with the
ladder cut at ``nstate``: the Weigel states F+(k), F-(k), Z(k) for
k = 0..nstate, vectorised over atoms, in real arithmetic of plain
PyTorch.  It imports nothing of the program.  The benchmark builds the
train and the atom grid here too, and hands the same inputs to the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

AXES = ("T1", "T2", "B1")


def train(cfg):
    """The flip-angle train (P,) in degrees and the scalar timings."""
    t = cfg["train"]
    P = int(t["npulse"])
    rng = np.random.default_rng(int(t["train_seed"]))
    fa = t["fa_base_deg"] + t["fa_amp_deg"] * np.abs(
        np.sin(np.arange(P) * 2 * np.pi / t["fa_period"]))
    fa = fa + rng.uniform(0, t["fa_jitter_deg"], P)
    return {"FA": fa.astype(np.float64), "phase_deg": float(t["phase_deg"]),
            "TE": float(t["te_ms"]), "TR": float(t["tr_ms"]),
            "nstate": int(t["nstate"])}


def grid_axes(cfg):
    """The linspace of each grid axis, in AXES order."""
    g = cfg["grid"]
    return [np.linspace(g[a][0], g[a][1], int(g[a][2])) for a in AXES]


def constrain(cfg, params):
    """Keep atoms physical: T2 <= t2_max_over_t1 * T1 (params (B, 3),
    numpy or torch, changed in place and returned)."""
    cap = cfg["grid"]["t2_max_over_t1"] * params[:, 0]
    if isinstance(params, torch.Tensor):
        params[:, 1] = torch.minimum(params[:, 1], cap)
    else:
        params[:, 1] = np.minimum(params[:, 1], cap)
    return params


def grid(cfg):
    """(B, 3) float64 atoms (T1, T2, B1), T1 slowest."""
    g = np.stack(np.meshgrid(*grid_axes(cfg), indexing="ij"), -1)
    return constrain(cfg, g.reshape(-1, 3))


def steps(cfg):
    """The spacing of each grid axis, (3,)."""
    return np.array([a[1] - a[0] for a in grid_axes(cfg)])


def fingerprints(cfg, params, *, dtype=torch.float64, normalize=False):
    """(B, P) fingerprints of atoms `params` (B, 3) = (T1, T2, B1) on
    params' device, computed in `dtype` (float64, float32 or bfloat16);
    with `normalize`, each row has unit L2 norm (computed in `dtype` too).
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


def _echoes(tr, T1, T2, B1, dtype):
    """Echoes (re, im), each (P, B), in `dtype`: per pulse the Weigel
    rotation of every row's (F+, F-, Z), relaxation over TE, the echo
    F+(0), relaxation over TR - TE, and the shift (F+ up, F- down,
    F+(0) = conj F-(1), the top row dropped)."""
    FA = tr["FA"]
    P, K, B = len(FA), tr["nstate"] + 1, T1.shape[0]
    dev = T1.device
    z = torch.zeros((K, B), dtype=dtype, device=dev)
    ar, ai, br, bi, zr, zi = (z.clone() for _ in range(6))
    zr[0] = 1.0
    te, rem = tr["TE"], tr["TR"] - tr["TE"]
    e1a, e2a, e1b, e2b = (torch.exp(-t / T).to(dtype) for t, T in
                          ((te, T1), (te, T2), (rem, T1), (rem, T2)))
    ph = math.radians(tr["phase_deg"])
    cp, sp, c2p, s2p = (math.cos(ph), math.sin(ph), math.cos(2 * ph),
                        math.sin(2 * ph))
    out_re = torch.empty((P, B), dtype=dtype, device=dev)
    out_im = torch.empty_like(out_re)
    zero = torch.zeros((1, B), dtype=dtype, device=dev)
    for i in range(P):
        a = math.radians(float(FA[i])) * B1
        c, s = torch.cos(a).to(dtype), torch.sin(a).to(dtype)
        c2, s2, hs = (1 + c) / 2, (1 - c) / 2, s / 2
        # F+' = c2 F+ + e^{2i phi} s2 F- - i e^{i phi} s Z
        nar = c2 * ar + s2 * (c2p * br - s2p * bi) + s * (cp * zi + sp * zr)
        nai = c2 * ai + s2 * (c2p * bi + s2p * br) - s * (cp * zr - sp * zi)
        # F-' = e^{-2i phi} s2 F+ + c2 F- + i e^{-i phi} s Z
        nbr = s2 * (c2p * ar + s2p * ai) + c2 * br + s * (sp * zr - cp * zi)
        nbi = s2 * (c2p * ai - s2p * ar) + c2 * bi + s * (cp * zr + sp * zi)
        # Z' = -i/2 e^{-i phi} s F+ + i/2 e^{i phi} s F- + c Z
        nzr = hs * ((cp * ai - sp * ar) - (cp * bi + sp * br)) + c * zr
        nzi = hs * ((cp * br - sp * bi) - (cp * ar + sp * ai)) + c * zi
        # relaxation over TE, echo, relaxation over TR - TE
        ar, ai, br, bi = nar * e2a, nai * e2a, nbr * e2a, nbi * e2a
        zr, zi = nzr * e1a, nzi * e1a
        zr[0] = zr[0] + (1 - e1a)
        out_re[i], out_im[i] = ar[0], ai[0]
        ar, ai, br, bi = ar * e2b, ai * e2b, br * e2b, bi * e2b
        zr, zi = zr * e1b, zi * e1b
        zr[0] = zr[0] + (1 - e1b)
        # the shift by one state
        ar, ai = (torch.cat([br[1:2], ar[:-1]]),
                  torch.cat([-bi[1:2], ai[:-1]]))
        br, bi = torch.cat([br[1:], zero]), torch.cat([bi[1:], zero])
    return out_re, out_im
