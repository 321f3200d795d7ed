"""Slice-profile-corrected MRF dictionaries.

Counterpart of ``epgpy_tpu/models/slice_profile.py``.  A real
slice-selective RF pulse does not tip the whole voxel by its nominal flip
angle: across the slice, a position z sees an effective flip
``alpha_eff(z) = alpha_nom * p(z)`` set by the pulse envelope and the
slice-select gradient.  The standard correction (Ma et al., MRM 2017:
"Slice profile and B1 corrections in 2D magnetic resonance
fingerprinting") simulates the train at a handful of z positions with the
ideal pulse scaled by p(z) and sums the signals over the slice.

Because p(z) multiplies every flip of the train exactly as B1 does, the
correction rides the B1 batch axis of the FISP dictionary:

* :func:`slice_profile_scales` simulates the shaped pulse once
  (``ops.rfpulse.encode_phase`` off-resonance sweep) and turns each z end
  state into an effective flip-angle scale and a quadrature weight;
* :func:`fisp_mrf_dictionary_sliced` runs the (atoms x z) batch through
  the FISP dictionary kernel's wrapper (``models/cuda_fisp.fisp_echoes``:
  ``csrc/fisp_half.cu`` on the card in float32, its plain twin on the
  CPU) and contracts z with the weights.  In float64 on the card, or past
  the kernel's shared-memory gate, the batch takes the plain full-ladder
  program (``models/mrf.fisp_mrf_dictionary``), as ``simulate()`` takes
  the general path there.  Atoms run in chunks where one chunk's (P, atoms
  x z) echoes would pass :data:`CHUNK_BYTES`; the sum over z is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import common
from . import cuda_fisp
from .mrf import fisp_mrf_dictionary

__all__ = ["slice_profile_scales", "fisp_mrf_dictionary_sliced",
           "CHUNK_BYTES"]

#: device bytes of one chunk's complex64 echoes, (atoms x z) x pulses x 8
CHUNK_BYTES = 20_000_000_000


def slice_profile_scales(pulse, *, gradient, fov, npoint=64, rewind=True,
                         threshold=0.02, gamma=None):
    """Effective flip-angle scales across the excited slice.

    Simulates the shaped slice-selective ``pulse`` (an
    ``ops.rfpulse.RFPulse``) from equilibrium on an ``npoint`` z grid
    under ``gradient`` (mT/m, via ``encode_phase``), with an optional
    rewinder lobe, and converts each z end state to an effective ideal
    flip angle ``alpha_eff(z) = atan2(|F0(z)|, Re Z0(z))`` -- exact for a
    pure rotation from equilibrium (F0 = sin(a) e^{i phi}, Z0 = cos(a)).

    Args:
        pulse: calibrated RFPulse (its ``.alpha`` is the nominal flip).
        gradient: slice-select gradient (mT/m).
        fov: z extent to simulate (mm), or an explicit position array.
        npoint: z grid size when ``fov`` is scalar.
        rewind: refocus half the slice-select area (True = 0.5, or a
            float fraction), as in ``encode_phase``.
        threshold: drop z points with ``scale < threshold``.
        gamma: gyromagnetic ratio override (kHz/mT).

    Returns:
        ``(scales, weights)`` numpy arrays of equal length: per-z
        effective-flip scales (alpha_eff / alpha_nom) and the uniform
        quadrature weights ``1/npoint`` of the kept points.
    """
    from ..engine import simulate
    from ..ops.probe import ADC
    from ..ops.rfpulse import RFPulse, encode_phase

    if not isinstance(pulse, RFPulse):
        raise TypeError("pulse must be an ops.rfpulse.RFPulse")
    nominal = float(pulse.alpha)
    if not nominal:
        raise ValueError("pulse has zero nominal flip angle")
    prof = encode_phase(pulse, gradient=gradient, fov=fov, npoint=npoint,
                        rewind=rewind, gamma=gamma)
    f0, z0 = simulate([prof, ADC], probe=["F0", "Z0"])
    f0 = np.asarray(f0).reshape(-1)
    z0 = np.asarray(z0).reshape(-1)
    alpha_eff = np.degrees(np.arctan2(np.abs(f0), np.real(z0)))
    scales = alpha_eff / abs(nominal)
    keep = scales >= threshold
    weights = np.full(keep.sum(), 1.0 / len(scales))
    return scales[keep], weights


def _echoes(FA, TR, TE, T1, T2, B1, *, phi, nstate, demodulate, inversion):
    """(re, im), each (P, B): the FISP dictionary kernel's wrapper for a
    CPU batch (its twin) and a float32 batch on the card (which raises past
    the kernel's gate); a float64 batch on the card runs the plain
    full-ladder program, the card's float64 reference."""
    if T1.device.type != "cuda" or T1.dtype == torch.float32:
        return cuda_fisp.fisp_echoes(
            FA, phi, TR, TE, T1, T2, B1, nstate=nstate,
            demodulate=demodulate, inversion=inversion)
    re, im = fisp_mrf_dictionary(FA, TR, TE, T1, T2, B1, phi=phi,
                                 nstate=nstate, demodulate=demodulate,
                                 inversion=inversion)
    return re.T, im.T


def fisp_mrf_dictionary_sliced(FA, TR, TE, T1s, T2s, B1s=None, *, scales,
                               weights=None, phi=90.0, nstate: int = 10,
                               demodulate: bool = False, inversion=None,
                               normalize: bool = False, sharding=None):
    """Slice-profile-corrected FISP MRF dictionary.

    Evaluates the FISP dictionary on the (atoms x z) outer batch
    ``B1_eff[a, z] = B1s[a] * scales[z]`` and contracts the z axis with
    ``weights``:

        D[a, p] = sum_z w_z * S(T1_a, T2_a, B1_a * scales_z)[p]

    Args mirror ``models.mrf.fisp_mrf_dictionary``; ``scales``/``weights``
    come from :func:`slice_profile_scales` (weights default to uniform
    1/nz).  With ``sharding`` (``parallel.atom_sharding(mesh)``) the atoms
    split over the mesh axis, and each shard's (atoms x z) batch is built
    and contracted on its entry's device (JAX shards the (atoms x z)
    batch: the same atoms per shard, each with its z copies).

    Returns:
        ``(re, im)``: (B, P) tensors on the working device (transposed
        views of the (P, B) echoes).
    """
    T1s = common.to_real(T1s).reshape(-1)
    T2s = common.to_real(T2s).reshape(-1)
    B1s = (torch.ones_like(T1s) if B1s is None
           else common.to_real(B1s).reshape(-1))
    if sharding is not None:
        from ..parallel.mesh import shard_map

        def build(t1, t2, b1):
            return fisp_mrf_dictionary_sliced(
                FA, TR, TE, t1, t2, b1, scales=scales, weights=weights,
                phi=phi, nstate=nstate, demodulate=demodulate,
                inversion=inversion, normalize=normalize)

        return shard_map(build, sharding.mesh,
                         [(T1s, 0), (T2s, 0), (B1s, 0)], axis=sharding.axis)
    scales = common.to_real(scales).reshape(-1)
    nz = scales.shape[0]
    if weights is None:
        weights = torch.full((nz,), 1.0 / nz, dtype=scales.dtype,
                             device=scales.device)
    else:
        weights = common.to_real(weights).reshape(-1)
        if weights.shape[0] != nz:
            raise ValueError(f"weights length {weights.shape[0]} != "
                             f"scales length {nz}")
    batch, npulse = T1s.shape[0], len(FA)
    out_re = torch.empty((npulse, batch), dtype=T1s.dtype,
                         device=T1s.device)
    out_im = torch.empty_like(out_re)
    chunk = max(1, int(CHUNK_BYTES // (nz * npulse * 8)))
    for a0 in range(0, batch, chunk):
        a1 = min(a0 + chunk, batch)
        n = a1 - a0
        # atoms-major flattening keeps each atom's z copies adjacent: the
        # contraction is one matrix-vector product over the last axis
        re, im = _echoes(
            FA, TR, TE, T1s[a0:a1].repeat_interleave(nz),
            T2s[a0:a1].repeat_interleave(nz),
            (B1s[a0:a1, None] * scales[None, :]).reshape(-1), phi=phi,
            nstate=nstate, demodulate=demodulate, inversion=inversion)
        out_re[:, a0:a1] = re.reshape(npulse * n, nz).mv(weights).view(
            npulse, n)
        out_im[:, a0:a1] = im.reshape(npulse * n, nz).mv(weights).view(
            npulse, n)
        del re, im
    re, im = out_re.T, out_im.T
    if normalize:
        norm = torch.sqrt(torch.sum(re * re + im * im, dim=-1, keepdim=True))
        norm = torch.where(norm == 0, torch.ones_like(norm), norm)
        re, im = re / norm, im / norm
    return re, im
