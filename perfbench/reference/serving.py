"""Plain reference of MRF serving: the match, the proton-density scale and
damped Gauss-Newton refinement with the closed-form complex scale
(variable projection), in plain PyTorch on a configuration's reference
fingerprints (``reference.<config>.fingerprints``).  Imports nothing of
the program; it reads the program's outputs only to judge them.

Correlations are |<d, s>| / (|d| |s|).  The Jacobian is a central
difference of the reference model in float64, each parameter stepped by
``fd_step`` of its magnitude.
"""

from __future__ import annotations

import numpy as np
import torch


def tf32(x):
    """float32 (or complex64) x with every element rounded to TF32 (10
    mantissa bits, to nearest): a product of such inputs accumulated in
    float32 is what a TF32 matrix product computes, on any device."""
    if x.is_complex():
        return torch.complex(tf32(x.real), tf32(x.imag))
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def correlations(ref, cfg, grid, sig, idx, *, block):
    """For signals sig (S, P) complex128: the best correlation over every
    atom of grid (B, 3) float64, and the correlation of atom idx (S,),
    both (S,) float64, computed in float64 block by block."""
    dev = sig.device
    s = sig / torch.linalg.vector_norm(sig, dim=1, keepdim=True)
    best = torch.zeros(sig.shape[0], dtype=torch.float64, device=dev)
    for b0 in range(0, grid.shape[0], block):
        d = ref.fingerprints(cfg, grid[b0:b0 + block], normalize=True)
        best = torch.maximum(best, (s.conj() @ d.T).abs().amax(dim=1))
    d = ref.fingerprints(cfg, grid[idx], normalize=True)
    at = torch.sum(s.conj() * d, dim=1).abs()
    return best, at


def pd_scale(d, s):
    """Complex PD <d, s> / <d, d> per row pair (d, s (S, P))."""
    return (torch.sum(d.conj() * s, dim=1)
            / torch.sum(d.conj() * d, dim=1).real)


def model_and_jacobian(ref, cfg, theta, fd_step, dtype=torch.float64):
    """Signal (S, P) and Jacobian (S, P, 3) at theta (S, 3): the signal
    computed in `dtype`, the Jacobian by central differences of the model
    in float64, stored in `dtype` (complex128 for float64, else complex64
    holding `dtype` values)."""
    S = theta.shape[0]
    h = fd_step * theta.abs()
    pts = []
    for k in range(3):
        e = torch.zeros_like(theta)
        e[:, k] = h[:, k]
        pts += [theta + e, theta - e]
    f = ref.fingerprints(cfg, torch.cat(pts), normalize=False)
    f = f.reshape(6, S, -1)
    jac = torch.stack([(f[2 * k] - f[2 * k + 1]) / (2 * h[:, k:k + 1])
                       for k in range(3)], dim=-1)
    if dtype == torch.float64:
        return ref.fingerprints(cfg, theta), jac
    return (ref.fingerprints(cfg, theta, dtype=dtype),
            rounded(jac.to(torch.complex64), dtype))


def rounded(x, dtype):
    """complex64 x with its parts rounded to `dtype` (bfloat16 or
    float32)."""
    return torch.complex(x.real.to(dtype).float(), x.imag.to(dtype).float())


def refine(ref, cfg, theta0, sig, *, iters, damping, bounds, fd_step,
           dtype=torch.float64, tf32_products=False):
    """Damped Gauss-Newton from theta0 (S, 3) on signals sig (S, P).

    Each iteration solves the complex scale c = <s, y> / <s, s> in closed
    form, projects the Jacobian orthogonal to the model signal (Kaufman's
    variable projection), scales both by c, solves the normal equations
    Re(J^H J) + damping diag = Re(J^H r) and clips to `bounds`.  In
    float64 throughout by default; with another `dtype` the model is
    computed in it (model_and_jacobian) and the step in float32, with
    `tf32_products` the inputs of its products rounded to TF32.  Returns
    theta (S, 3) float64."""
    lo, hi = (torch.tensor(np.asarray(bounds, float)[:, i], device=sig.device)
              for i in (0, 1))
    theta = theta0.to(torch.float64)
    y = sig.to(torch.complex128 if dtype == torch.float64
               else torch.complex64)
    low = tf32 if tf32_products else (lambda x: x)
    for _ in range(iters):
        s, J = model_and_jacobian(ref, cfg, theta, fd_step, dtype)
        den = torch.sum(s.conj() * s, dim=1).real.clamp(min=1e-30)
        c = torch.sum(s.conj() * y, dim=1) / den
        a = torch.einsum("sp,spk->sk", low(s.conj()), low(J)) / den[:, None]
        J = J - s[..., None] * a[:, None, :]
        s, J = c[:, None] * s, c[:, None, None] * J
        r = y - s
        Jl = low(J)
        A = torch.einsum("spi,spj->sij", Jl.conj(), Jl).real
        g = torch.einsum("spi,sp->si", Jl.conj(), low(r)).real
        diag = torch.diagonal(A, dim1=-2, dim2=-1).clamp(min=1e-12)
        A = A + torch.diag_embed(damping * diag)
        delta = torch.linalg.solve(A, g[..., None])[..., 0]
        theta = torch.clamp(theta + delta.to(torch.float64), lo, hi)
    return theta
