"""Global configuration: working precision and device.

Counterpart of ``epgpy_tpu/config.py``.  JAX picks its precision from the
global x64 flag and its device itself; here both are explicit settings:

* ``set_precision("float32" | "float64")`` selects complex64/float32 (the
  default, what the CUDA kernels compute in) or complex128/float64 (parity
  with the reference semantics);
* ``set_device(...)`` selects where state and operator coefficients live.
  The default is CUDA.  There is no automatic fallback to the CPU: only an
  explicit ``set_device("cpu")`` (the test suite does this) selects it.

``full_precision()`` runs float32 matrix products in true float32 (TF32
off) inside a block: dictionary matching and the Fisher products of
``stats`` need it.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["set_precision", "precision", "real_dtype", "complex_dtype",
           "int_dtype", "set_device", "device", "full_precision"]

_PRECISIONS = {
    "float32": (torch.float32, torch.complex64),
    "float64": (torch.float64, torch.complex128),
}

_state = {"precision": "float32", "device": torch.device("cuda")}


def set_precision(name: str) -> None:
    """Select the working precision: "float32" or "float64"."""
    if name not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, "
                         f"got {name!r}")
    _state["precision"] = name


def precision() -> str:
    """The working precision name ("float32" or "float64")."""
    return _state["precision"]


def real_dtype() -> torch.dtype:
    """float32 or float64, following the working precision."""
    return _PRECISIONS[_state["precision"]][0]


def complex_dtype() -> torch.dtype:
    """complex64 or complex128, following the working precision."""
    return _PRECISIONS[_state["precision"]][1]


def int_dtype() -> torch.dtype:
    """Integer dtype for k-state coordinates: int32 or int64, following the
    working precision."""
    return torch.int64 if _state["precision"] == "float64" else torch.int32


def set_device(dev) -> None:
    """Select the device for states and operator coefficients."""
    _state["device"] = torch.device(dev)


def device() -> torch.device:
    """The selected device (CUDA unless ``set_device`` chose another)."""
    return _state["device"]


@contextlib.contextmanager
def full_precision():
    """Float32 matrix products in full float32 (TF32 off) inside the
    block, restoring the caller's setting after it; raises if TF32 is
    still on (so a product never runs reduced)."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 matmuls are on: this product needs "
                               "full float32 precision")
        yield
    finally:
        torch.set_float32_matmul_precision(old)
