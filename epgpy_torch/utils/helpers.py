"""Small conversion helpers (counterpart of ``epgpy_tpu/utils/helpers.py``,
reference epgpy/utils.py:134-213)."""

from __future__ import annotations

import enum
import sys

import numpy as np
import torch

from .constants import gamma_1H

__all__ = ["Axes", "get_norm", "get_wavenumber", "spatial_range",
           "space_to_freq", "freq_to_space", "cexp", "progressbar"]


def Axes(*names):
    """An IntEnum mapping axis names to indices (starting at 0)."""
    return enum.IntEnum("Axes", names, start=0)


def get_norm(states):
    """State-matrix norm over the (F-, Z) components."""
    states = torch.as_tensor(states)
    return torch.sqrt(torch.sum(states[..., 1:].abs() ** 2, dim=(-2, -1)))


def cexp(arr):
    """exp(1j * arr) for real arr."""
    arr = torch.as_tensor(arr)
    return torch.complex(torch.cos(arr), torch.sin(arr))


def get_wavenumber(grad, duration, gamma=gamma_1H):
    """Wavenumber (rad/m) from a gradient (mT/m) applied for `duration`
    (ms)."""
    return 2 * np.pi * gamma * np.asarray(grad) * 1e-3 * np.asarray(duration)


def spatial_range(fov, nvalue=100):
    """`nvalue` positions spanning `fov` (mm), centered."""
    return fov * np.linspace(-0.5, 0.5, nvalue)


def space_to_freq(grad, positions, *, gamma=gamma_1H):
    """Positions (mm) under a gradient (mT/m) -> off-resonance (kHz)."""
    if not np.isscalar(positions):
        positions = np.asarray(positions)
    return grad * 1e-6 * gamma * positions


def freq_to_space(grad, frequencies, *, gamma=gamma_1H):
    """Inverse of :func:`space_to_freq`."""
    return frequencies / grad / gamma * 1e6


def progressbar(it, prefix="", size=50, out=None):
    """Textual progress bar over an iterable (``simulate(disp=True)``)."""
    out = out or sys.stdout
    items = list(it)
    count = max(len(items), 1)

    def show(j):
        x = int(size * j / count)
        print(f"{prefix}[{'#' * x}{'.' * (size - x)}] {j}/{count}",
              end="\r", file=out, flush=True)

    show(0)
    for i, item in enumerate(items):
        yield item
        show(i + 1)
    print(file=out, flush=True)
