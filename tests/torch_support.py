"""Shared helpers of the epgpy_torch parity tests (tests/test_torch_*.py).

The port's tests run the same numpy inputs (made from a seed) through the
JAX package and through epgpy_torch.  ``tests/conftest.py`` turns on JAX
x64 and pins JAX to the CPU; these fixtures pin the port to the CPU in
the precision a test asks for and restore the previous setting after it.
"""

import os

import numpy as np
import pytest
import torch

from epgpy_torch import config

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _pinned(precision):
    old = (config.precision(), config.device(), torch.get_num_threads())
    config.set_device("cpu")
    config.set_precision(precision)
    torch.set_num_threads(1)          # six test workers share the cores
    yield
    config.set_precision(old[0])
    config.set_device(old[1])
    torch.set_num_threads(old[2])


@pytest.fixture
def port_f64():
    """epgpy_torch on the CPU in float64 (complex128)."""
    yield from _pinned("float64")


@pytest.fixture
def port_f32():
    """epgpy_torch on the CPU in float32 (complex64)."""
    yield from _pinned("float32")


def random_ladder(rng, batch, nstate):
    """A random complex (*batch, 2n+1, 3) ladder with the EPG conjugate
    symmetry F-(k) = conj(F+(-k)), Z(-k) = conj(Z(k))."""
    K = 2 * nstate + 1
    shape = tuple(batch) + (K,)
    fp = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    z = 0.5 * (z + np.conj(z[..., ::-1]))
    return np.stack([fp, np.conj(fp[..., ::-1]), z], axis=-1)


def cplx(re, im):
    """(re, im) pair of arrays or tensors -> one complex numpy array."""
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return host(re) + 1j * host(im)
