"""Carry parameters and states over from the JAX package.

Both functions take plain numpy values, so this module needs no JAX:

* :func:`from_numpy_params` turns the host dict of
  ``epgpy_tpu.fisp_dispatch.match_fisp`` (keys FA, phi, TR, TE, T1, T2,
  B1, TI, inv_df, vars, b1_scale, d_var, demod, shape, df, diffusion)
  into a match dict of this package, with its kernel tensors already on
  `device`: ready for ``epgpy_torch.fisp_dispatch.run_fisp_kernel`` and,
  for a Jacobian match (``vars``, ``b1_scale``), ``run_fisp_jacobian``;
  it also takes the dict of ``match_fisp_hessian`` (keys FA, phi, TAU,
  T1, T2, TE, TI, amap, shape), ready for ``run_fisp_hessian``, and the
  dict of ``match_mse`` (keys exc, FA, phi, tau1, tau2, T1, T2, B1, shape,
  vars, b1_scale, diffusion), ready for ``run_mse_kernel`` and
  ``run_mse_jacobian``; a ``match_bssfp`` dict has ``match_fisp``'s keys
  and takes the same way, to ``run_bssfp_kernel`` /
  ``run_bssfp_jacobian``; the dict of ``match_dess`` (keys FA, phi, TR,
  TE, T1, T2, B1, TI, vars, b1_scale, demod, shape, df) becomes this
  package's, ready for ``run_dess_kernel`` and ``run_dess_jacobian``; the
  dict of ``match_megre`` (the DESS keys with an (m, N) TE, plus
  ``nechoes``) is ready for ``run_megre_kernel`` and
  ``run_megre_jacobian``, and a ``match_dwfisp`` dict (``match_fisp``'s
  keys, its ``diffusion`` entry holding bT, bL, a numpy Dcoef -- scalar or
  3x3 -- and ramp) for ``run_dwfisp_kernel`` and ``run_dwfisp_jacobian``;
  the dict of ``match_composite`` (keys FA, phi, ta, tb, adci, shift, aph,
  b1u, T1, T2, B1, df, nadc, shape, vars, b1_scale, diffusion -- None or
  btd, rdir and the scalar Dc), recognised by its ``adci``, is ready for
  ``run_composite_kernel`` and ``run_composite_jacobian``;
* :func:`from_numpy_xparams` turns the JAX side's EPG-X values into this
  package's: the dict of ``match_xgre`` (keys alpha, phi, B1, satf_re/im,
  satz_re/im, dens, khiA/B, T1A/B, T2A/B, gA/B, tauA/B, shape, C,
  balanced), ready for ``run_xgre_kernel``; the dict of
  ``match_xcomposite`` (keys alpha, B1, phi, satf_re/im, satz_re/im,
  adci, shift, aph, b1u, mia, mib, taus, dens, khi, T1, T2, g, nadc,
  shape, C, has_sat), ready for ``run_xcomposite_kernel``; and a stage- or
  table-matrix tuple ``(mr, mi, ml)`` of ``exchange_stage_mats`` /
  ``xcomposite_stage_mat_tables`` (or a list of them: the tangents),
  as tensors for the Jacobian entry points;
* :func:`from_numpy_states` builds a :class:`StateMatrix` from the complex
  ``(*batch, K, 3)`` ladder of a JAX ``StateMatrix.states``.
"""

from __future__ import annotations

import numpy as np

from . import fisp_dispatch
from .statematrix import StateMatrix

__all__ = ["from_numpy_params", "from_numpy_xparams", "from_numpy_states"]

_KEYS = ("FA", "phi", "TR", "TE", "T1", "T2", "B1", "TI", "inv_df", "vars",
         "b1_scale", "d_var", "demod", "shape", "df", "diffusion")
_HESS_KEYS = ("FA", "phi", "TAU", "T1", "T2", "TE", "TI", "amap", "shape")
_DESS_KEYS = ("FA", "phi", "TR", "TE", "T1", "T2", "B1", "TI", "vars",
              "b1_scale", "demod", "shape", "df")
_MEGRE_KEYS = _DESS_KEYS + ("nechoes",)
_COMP_KEYS = ("FA", "phi", "ta", "tb", "adci", "shift", "aph", "b1u", "T1",
              "T2", "B1", "df", "nadc", "shape", "vars", "b1_scale",
              "diffusion")
_MSE_KEYS = ("exc", "FA", "phi", "tau1", "tau2", "T1", "T2", "B1", "shape",
             "vars", "b1_scale", "diffusion")


def from_numpy_params(params: dict, device) -> dict:
    """A JAX FISP, DW-FISP or bSSFP (or per-pulse Hessian, CPMG, DESS,
    ME-GRE or composite-GRE) match dict -> this package's, with device
    tensors."""
    if "amap" in params:
        return _hessian_params(params, device)
    if "adci" in params:
        return _composite_params(params, device)
    if "tau1" in params:
        return _mse_params(params, device)
    # the DESS dict is the FISP dict without its inversion, DW and prep
    # precession keys; the ME-GRE dict is the DESS dict with its echo
    # count (and an (m, N) TE)
    if "nechoes" in params:
        keys = _MEGRE_KEYS
    else:
        keys = _KEYS if "inv_df" in params else _DESS_KEYS
    out = {k: params.get(k) for k in keys}
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
    if "nechoes" in out:
        out["nechoes"] = int(out["nechoes"])
    if out.get("diffusion") is not None:
        d = dict(out["diffusion"])
        out["diffusion"] = {"bT": float(d["bT"]), "bL": float(d["bL"]),
                            "Dcoef": np.asarray(d["Dcoef"], dtype=np.float64),
                            "ramp": bool(d["ramp"])}
    fisp_dispatch.device_params(out, device)
    return out


def _hessian_params(params, device):
    out = {k: params.get(k) for k in _HESS_KEYS}
    for k in ("FA", "phi", "TAU", "T1", "T2"):
        out[k] = np.asarray(out[k])
    for k in ("TE", "TI"):
        if out[k] is not None:
            out[k] = float(out[k])
    out["amap"] = {v: (str(tok[0]), int(tok[1]))
                   for v, tok in out["amap"].items()}
    out["shape"] = tuple(out["shape"])
    fisp_dispatch.hess_device_params(out, device)
    return out


def _mse_params(params, device):
    out = {k: params.get(k) for k in _MSE_KEYS}
    for k in ("FA", "phi", "tau1", "tau2", "T1", "T2", "B1"):
        out[k] = np.asarray(out[k])
    out["exc"] = tuple(float(x) for x in out["exc"])
    out["shape"] = tuple(out["shape"])
    out["vars"] = tuple(out["vars"] or ())
    if out["b1_scale"] is not None:
        out["b1_scale"] = float(out["b1_scale"])
    if out["diffusion"] is not None:
        d = dict(out["diffusion"])
        out["diffusion"] = {
            "b1": float(d["b1"]), "ramp1": bool(d["ramp1"]),
            "D1": np.asarray(d["D1"], dtype=np.float64),
            "b2": float(d["b2"]), "ramp2": bool(d["ramp2"]),
            "D2": np.asarray(d["D2"], dtype=np.float64)}
    fisp_dispatch._mse_device_params(out, device)
    return out


def _composite_params(params, device):
    out = {k: params.get(k) for k in _COMP_KEYS}
    for k in ("FA", "phi", "ta", "tb", "adci", "shift", "aph", "b1u", "T1",
              "T2", "B1", "df"):
        if out[k] is not None:
            out[k] = np.asarray(out[k])
    out["nadc"] = int(out["nadc"])
    out["shape"] = tuple(out["shape"])
    out["vars"] = tuple(out["vars"] or ())
    if out["b1_scale"] is not None:
        out["b1_scale"] = float(out["b1_scale"])
    if out["diffusion"] is not None:
        d = dict(out["diffusion"])
        out["diffusion"] = {"btd": np.asarray(d["btd"], dtype=np.float64),
                            "rdir": np.asarray(d["rdir"], dtype=np.float64),
                            "Dc": float(np.asarray(d["Dc"]))}
    fisp_dispatch._comp_device_params(out, device)
    return out


_XGRE_KEYS = ("alpha", "phi", "B1", "satf_re", "satf_im", "satz_re",
              "satz_im", "dens", "khiA", "khiB", "T1A", "T2A", "gA", "tauA",
              "T1B", "T2B", "gB", "tauB", "shape", "C", "balanced")
_XCOMP_KEYS = ("alpha", "B1", "phi", "satf_re", "satf_im", "satz_re",
               "satz_im", "adci", "shift", "aph", "b1u", "mia", "mib", "taus",
               "dens", "khi", "T1", "T2", "g", "nadc", "shape", "C",
               "has_sat")


def from_numpy_xparams(obj, device, dtype=None):
    """A JAX EPG-X value -> this package's: a ``match_xgre`` or
    ``match_xcomposite`` dict (recognised by ``khiA`` / ``taus``) becomes
    a match dict of this package with its kernel tensors on `device`; an
    ``(mr, mi, ml)`` tuple of stage matrices or tables becomes a tuple of
    tensors on `device` (float32 unless `dtype`), and a list of such
    tuples a list."""
    import torch

    if isinstance(obj, dict):
        return _xparams(obj, device, dtype)
    dtype = torch.float32 if dtype is None else dtype
    if isinstance(obj, list):
        return [from_numpy_xparams(o, device, dtype) for o in obj]
    return tuple(torch.as_tensor(np.asarray(m, dtype=np.float64),
                                 dtype=dtype, device=device) for m in obj)


def _xparams(params, device, dtype):
    keys = _XGRE_KEYS if "khiA" in params else _XCOMP_KEYS
    out = {}
    for k in keys:
        v = params.get(k)
        if isinstance(v, (bool, int, float)) or v is None:
            out[k] = v
        elif k == "shape":
            out[k] = tuple(int(d) for d in v)
        else:
            a = np.asarray(v)
            out[k] = float(a) if a.ndim == 0 else a
    out["C"] = int(out["C"])
    if "khiA" in params:
        out["balanced"] = bool(out["balanced"])
        fisp_dispatch._xgre_device_params(out, device, dtype)
    else:
        out["nadc"] = int(out["nadc"])
        out["has_sat"] = bool(out["has_sat"])
        fisp_dispatch._xcomp_device_params(out, device, dtype)
    return out


def from_numpy_states(states: np.ndarray) -> StateMatrix:
    """A complex (*batch, K, 3) numpy ladder -> StateMatrix (checked for
    the conjugate ladder symmetry)."""
    return StateMatrix(np.asarray(states, dtype=np.complex128))
