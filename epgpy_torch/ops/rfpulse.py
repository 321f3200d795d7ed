"""Shaped RF pulses (hard-pulse approximation).

Counterpart of ``epgpy_tpu/ops/rfpulse.py`` (semantics: reference
epgpy/rfpulse.py:37-197).  A shaped pulse is a train of small
instantaneous rotations, one per waveform sample: the i-th sub-rotation
has flip ``180 * |v_i| * rf`` degrees and phase ``angle(v_i)``; an
optional constant phase offset wraps the train in ``Phi(-offset) ...
Phi(offset)``.

:class:`RFPulse` is a MultiOperator of identically shaped T operators:
``engine.flatten_sequence`` opens it, and the scan planner stacks the
sub-pulses into one periodic block, replayed on the card in the plan's
CUDA graph like any T train.

RF calibration (``estimate_rf``, ``estimate_alpha``) is pulse design, not
the simulation: it runs in float64 on the CPU by choice, whatever the
working device (a 3x3 rotation fold per step; torch.autograd gives the
gradient of the descent, as ``jax.value_and_grad`` does in JAX):

* constant-phase waveforms: closed form ``rf = alpha / 180 / |sum v|``;
* otherwise: gradient descent on the distance to the ideal pulse's
  end state (the reference uses scipy SLSQP, epgpy/rfpulse.py:225-314).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from . import base
from .evolution import P
from .transition import T, Phi

LOGGER = logging.getLogger(__name__)

__all__ = ["RFPulse", "make_pulse_sequence", "estimate_rf", "estimate_alpha",
           "encode_phase"]


class RFPulse(base.MultiOperator):
    """Realistic shaped RF pulse built from complex waveform samples."""

    def __init__(self, values, duration, *, rf=None, alpha=None, phi=None,
                 name=None, **kwargs):
        values = np.asarray(values, dtype=np.complex128)
        if rf is None and alpha is None:
            raise ValueError('Either "rf" or "alpha" must be provided')
        if rf is None:
            rf = estimate_rf(values, alpha)
        elif alpha is None:
            alpha = estimate_alpha(values, rf)

        seq = make_pulse_sequence(values, duration, rf, offset=phi)

        T1, T2, g = (kwargs.pop("T1", None), kwargs.pop("T2", None),
                     kwargs.pop("g", None))
        if not all(v is None for v in (T1, T2, g)):
            from ..engine import modify
            T1 = 1e10 if T1 is None else T1
            T2 = 1e10 if T2 is None else T2
            g = 0 if g is None else g
            seq = modify(seq, T1=T1, T2=T2, g=g, expand=False)

        self.values = values
        self.rf = rf
        self.alpha = alpha
        self.phi = phi
        super().__init__(seq, name=name or f"RFPulse({len(values)}, "
                                           f"{duration}ms)",
                         duration=duration)


def make_pulse_sequence(values, duration, rf, offset=None):
    """Train of small T rotations from complex waveform samples."""
    values = np.asarray(values)
    if values.ndim > 1:
        raise ValueError("`values` array must be 1-dimensional")
    if np.max(np.abs(values)) > 1:
        raise ValueError("pulse values must have magnitude <= 1")
    nvalue = len(values)

    ndim = len(np.shape(rf))
    if ndim >= 1:
        values = values.reshape((nvalue,) + (1,) * ndim)

    if np.isscalar(duration):
        durations = np.full(nvalue, duration / nvalue)
    elif len(duration) == nvalue:
        durations = np.asarray(duration)
    else:
        raise ValueError("duration and values must have the same length")

    alphas = 180.0 * np.abs(values) * np.asarray(rf)
    phis = np.angle(values, deg=True)

    seq = [T(a, p, duration=d) for a, p, d in zip(alphas, phis, durations)]
    if offset:
        seq = [Phi(-offset)] + seq + [Phi(offset)]
    return seq


def _rotations(alphas, phis):
    """(n, 3, 3) Weigel rotations ``Rz(phi) Rx(alpha) Rz(-phi)`` (degrees)
    in complex128 on the CPU (``transition.rotation_operator``'s matrix;
    `alphas` may carry autograd state)."""
    a = torch.deg2rad(torch.as_tensor(alphas, dtype=torch.float64))
    p = torch.deg2rad(torch.as_tensor(phis, dtype=torch.float64))
    a, p = torch.broadcast_tensors(a, p)
    ep = torch.exp(1j * p)
    cos2 = ((1 + torch.cos(a)) / 2).to(torch.complex128)
    sin2 = ((1 - torch.cos(a)) / 2).to(torch.complex128)
    sin = torch.sin(a).to(torch.complex128)
    rows = [[cos2, ep * ep * sin2, -1j * ep * sin],
            [torch.conj(ep * ep) * sin2, cos2, 1j * torch.conj(ep) * sin],
            [-0.5j * torch.conj(ep) * sin, 0.5j * ep * sin,
             torch.cos(a).to(torch.complex128)]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _combined_rotation(alphas, phis):
    """Net 3x3 rotation of a sub-pulse train applied first to last: the
    ordered product ``M_n-1 ... M_1 M_0``, by a pairwise tree of batched
    products (log2(n) levels instead of an n-step loop)."""
    mats = _rotations(alphas, phis)
    while mats.shape[0] > 1:
        if mats.shape[0] % 2:
            eye = torch.eye(3, dtype=mats.dtype)[None]
            mats = torch.cat([mats, eye])
        mats = mats[1::2] @ mats[0::2]
    return mats[0]


def estimate_alpha(values, rf):
    """Effective flip angle of the waveform at RF amplitude `rf` (degrees)."""
    values = np.asarray(values)
    alphas = 180.0 * np.abs(values) * rf
    phis = np.angle(values, deg=True)
    net = _combined_rotation(alphas, phis).numpy()
    z = net @ np.asarray([0.0, 0.0, 1.0])
    absZ = np.mod(np.real(z[2]) + 1, 2) - 1
    return float(np.mod(np.arccos(absZ) / np.pi * 180 + 180, 360) - 180)


def estimate_rf(values, alpha, *, steps=200):
    """RF amplitude (kHz-equivalent scale) achieving flip `alpha` (degrees)."""
    values = np.asarray(values)
    if np.max(np.abs(values)) > 1:
        raise ValueError("pulse values must have magnitude <= 1")

    phase_diffs = np.diff(np.mod(np.angle(values, deg=True), 180))
    if np.all(np.isclose(phase_diffs, 0, atol=1e-5)):
        LOGGER.info("constant-phase pulse: closed-form rf for alpha=%s", alpha)
        return float(alpha / 180.0 / np.abs(np.sum(values)))

    LOGGER.info("optimizing rf for alpha=%s", alpha)
    alphas = torch.as_tensor(180.0 * np.abs(values), dtype=torch.float64)
    phis = np.angle(values, deg=True)
    target = np.abs(_rotations(np.asarray([alpha], float), [90.0])[0].numpy()
                    @ np.asarray([0.0, 0.0, 1.0]))
    target = torch.as_tensor(target)

    def cost(rf):
        z = _combined_rotation(rf * alphas, phis)[:, 2]
        return torch.sum((torch.abs(z) - target) ** 2)

    rf = alpha / 180.0 / np.abs(np.sum(values))
    lr = 0.1 * rf
    best_rf, best_c = float(rf), math.inf
    for _ in range(steps):
        x = torch.tensor(rf, dtype=torch.float64, requires_grad=True)
        c = cost(x)
        (g,) = torch.autograd.grad(c, x)
        c, g = float(c.detach()), float(g)
        if c < best_c:
            best_c, best_rf = c, float(rf)
        rf = max(rf - lr * g, 0.0)
        if abs(g) < 1e-12 or c < 1e-14:
            break
    return best_rf


def encode_phase(pulse, gradient, fov, *, expand=True, rewind=None,
                 npoint=101, gamma=None):
    """Add a slice-select gradient axis to a pulse (off-resonance sweep)."""
    from ..engine import modify
    from ..utils import constants, helpers

    if gamma is None:
        gamma = constants.gamma_1H
    if not isinstance(pulse, RFPulse):
        raise TypeError("Can only use RFPulse operators")
    if np.isscalar(fov):
        fov = helpers.spatial_range(fov, npoint)
    freqs = helpers.space_to_freq(gradient, fov, gamma=gamma)
    if expand:
        dims = tuple(range(len(pulse.shape)))
        freqs = np.expand_dims(freqs, dims)

    modified = modify(pulse, g=freqs, expand=False)
    if not isinstance(modified, base.MultiOperator):
        modified = base.MultiOperator(modified)
    if rewind is not None:
        rewind = 0.5 if rewind is True else float(rewind)
        modified.operators.append(
            P(pulse.duration * rewind, g=-freqs, duration=0))
    return modified
