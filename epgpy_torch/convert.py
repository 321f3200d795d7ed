"""Carry parameters and states over from the JAX package.

Both functions take plain numpy values, so this module needs no JAX:

* :func:`from_numpy_params` turns the host dict of
  ``epgpy_tpu.fisp_dispatch.match_fisp`` (keys FA, phi, TR, TE, T1, T2,
  B1, TI, inv_df, vars, b1_scale, d_var, demod, shape, df, diffusion)
  into a match dict of this package, with its kernel tensors already on
  `device`: ready for ``epgpy_torch.fisp_dispatch.run_fisp_kernel`` and,
  for a Jacobian match (``vars``, ``b1_scale``), ``run_fisp_jacobian``;
* :func:`from_numpy_states` builds a :class:`StateMatrix` from the complex
  ``(*batch, K, 3)`` ladder of a JAX ``StateMatrix.states``.
"""

from __future__ import annotations

import numpy as np

from . import fisp_dispatch
from .statematrix import StateMatrix

__all__ = ["from_numpy_params", "from_numpy_states"]

_KEYS = ("FA", "phi", "TR", "TE", "T1", "T2", "B1", "TI", "inv_df", "vars",
         "b1_scale", "d_var", "demod", "shape", "df", "diffusion")


def from_numpy_params(params: dict, device) -> dict:
    """A JAX FISP match dict -> this package's, with device tensors."""
    out = {k: params.get(k) for k in _KEYS}
    for k in ("FA", "phi", "TR", "T1", "T2", "B1", "df"):
        if out[k] is not None:
            out[k] = np.asarray(out[k])
    if np.ndim(out["TE"]) == 0:
        out["TE"] = float(out["TE"])
    else:
        out["TE"] = np.asarray(out["TE"])
    out["shape"] = tuple(out["shape"])
    out["vars"] = tuple(out["vars"] or ())
    if out["b1_scale"] is not None:
        out["b1_scale"] = float(out["b1_scale"])
    fisp_dispatch.device_params(out, device)
    return out


def from_numpy_states(states: np.ndarray) -> StateMatrix:
    """A complex (*batch, K, 3) numpy ladder -> StateMatrix (checked for
    the conjugate ladder symmetry)."""
    return StateMatrix(np.asarray(states, dtype=np.complex128))
