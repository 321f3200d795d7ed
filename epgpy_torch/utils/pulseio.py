"""Pulse waveform IO: Siemens .pta files.

Counterpart of ``epgpy_tpu/utils/pulseio.py`` (format parity: reference
epgpy/pulseio.py); plain numpy and file IO.  A .pta file contains header
lines ``KEY:<tab>value`` followed by sample lines
``magnitude<tab>phase<tab>; (index)``.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

__all__ = ["load_pulse", "read_pulse", "load_pta", "resample_pulse",
           "PTA_PULSE_KEYS"]

PTA_PULSE_KEYS = [
    "PULSENAME", "COMMENT", "REFGRAD", "MINSLICE", "MAXSLICE",
    "AMPINT", "POWERINT", "ABSINT",
]

_SAMPLE_RE = re.compile(
    r"^\s*([0-9.eE+-]+)\s+([0-9.eE+-]+)\s+;\s*\(?\s*(\d+)\s*\)?\s*$")


def load_pulse(filename, duration, resample=None, **kwargs):
    """Load a pulse file as an RFPulse operator."""
    from ..ops.rfpulse import RFPulse
    _, values = read_pulse(filename, resample=resample)
    return RFPulse(values, duration, **kwargs)


def read_pulse(filename, resample=None):
    """Read a pulse waveform file -> (header dict, complex samples)."""
    path = pathlib.Path(filename)
    if path.suffix == ".pta":
        header, values = load_pta(filename)
    else:
        raise NotImplementedError(f"Unknown pulse extension: {path.suffix}")
    if resample and resample < len(values):
        return header, resample_pulse(values, resample)
    return header, values


def load_pta(filename):
    """Parse a .pta file -> (header, complex sample array)."""
    header = {}
    samples = {}
    with open(filename) as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            # header entry: "KEY:\tvalue"
            key, sep, rest = line.partition(":")
            if sep and key in PTA_PULSE_KEYS:
                header[key] = rest.strip()
                continue
            m = _SAMPLE_RE.match(line.replace("\t", " "))
            if m:
                mag, phase, idx = float(m[1]), float(m[2]), int(m[3])
                if idx in samples:
                    raise IOError(f"Duplicate sample index {idx}")
                samples[idx] = mag * np.exp(1j * phase)
                continue
            raise IOError(f"Could not parse line: {line!r}")
    keys = sorted(samples)
    if keys and keys != list(range(keys[0], keys[0] + len(keys))):
        # a truncated/concatenated file would otherwise silently load
        # as a shorter waveform
        raise IOError("Non-contiguous sample indices in .pta file")
    values = np.asarray([samples[i] for i in keys])
    return header, values


def resample_pulse(values, nsample):
    """Linearly resample a complex waveform to `nsample` points."""
    n = len(values)
    xs = np.linspace(0, n - 1, nsample)
    grid = np.arange(n)
    return np.interp(xs, grid, values.real) + 1j * np.interp(xs, grid, values.imag)
