"""Shaped RF pulses, pulse files and slice-profile dictionaries of
epgpy_torch against epgpy_tpu.

* ``RFPulse``: the closed-form rf of a constant-phase waveform, the
  estimate round trip (rf -> alpha), the calibration of a complex
  waveform and the explicit-rf form, each equal to JAX's (1e-10);
  ``encode_phase`` and an RFPulse inside a planned train (its sub-pulses
  stacked into a scan block) against JAX and the eager loop;
* ``utils.pulseio``: a .pta round trip, ``load_pulse``, resampling and
  the corrupt-index errors (``tests/test_rfpulse_io.py``);
* ``models.slice_profile``: ``tests/test_slice_profile.py``'s cases, the
  scales and the sliced dictionary against JAX (1e-10), the sliced
  dictionary against its explicit (atoms x z) batch, and in atom chunks.
"""

import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import engine
from epgpy_torch.models import slice_profile as tsp
from epgpy_torch.models import (fisp_mrf_dictionary,
                                fisp_mrf_dictionary_sliced,
                                slice_profile_scales)
from epgpy_torch.ops import rfpulse as trf
from epgpy_torch.utils import pulseio
from epgpy_tpu.models import slice_profile as jsp
from epgpy_tpu.ops import rfpulse as jrf

from torch_support import port_f64  # noqa: F401

TOL = 1e-10


def _sinc_pulse(n=64, width=3):
    x = np.linspace(-width, width, n)
    values = np.sinc(x) * np.hamming(n)
    return values / np.abs(values).max()


def test_rfpulse_constant_phase_rf(port_f64):
    pulse = trf.RFPulse(np.ones(16), 1.0, alpha=90.0)
    assert np.isclose(pulse.rf, 90.0 / 180.0 / 16.0)
    out = pulse(tepg.StateMatrix())
    assert np.isclose(float(out.F0.abs()[0]), 1.0, atol=1e-10)
    jout = jrf.RFPulse(np.ones(16), 1.0, alpha=90.0)(jepg.StateMatrix())
    assert np.abs(out.states.numpy() - np.asarray(jout.states)).max() < TOL


def test_rfpulse_estimate_alpha_roundtrip(port_f64):
    values = _sinc_pulse()
    rf = trf.estimate_rf(values, 42.0)
    alpha = trf.estimate_alpha(values, rf)
    assert np.isclose(alpha, 42.0, atol=0.5)
    assert abs(rf - jrf.estimate_rf(values, 42.0)) < TOL * rf
    assert abs(alpha - jrf.estimate_alpha(values, rf)) < TOL * 42.0


def test_rfpulse_calibrates_complex_waveforms_as_jax(port_f64):
    """A waveform with varying phase takes the gradient descent; the
    calibrated rf and the pulse's end state equal JAX's."""
    values = _sinc_pulse(32) * np.exp(1j * np.linspace(0.0, 2.0, 32))
    pulse = trf.RFPulse(values, 2.0, alpha=60.0)
    jpulse = jrf.RFPulse(values, 2.0, alpha=60.0)
    assert abs(pulse.rf - jpulse.rf) < 1e-8 * jpulse.rf
    got = pulse(tepg.StateMatrix()).states.numpy()
    want = np.asarray(jpulse(jepg.StateMatrix()).states)
    assert np.abs(got - want).max() < 1e-8


def test_rfpulse_explicit_rf_and_relaxation(port_f64):
    """rf given: alpha is estimated; T1/T2/g make the sub-pulses relax."""
    values = _sinc_pulse(24)
    kw = dict(rf=0.05, T1=800.0, T2=60.0, g=0.02, phi=30.0)
    pulse, jpulse = trf.RFPulse(values, 3.0, **kw), jrf.RFPulse(values, 3.0,
                                                                **kw)
    assert abs(pulse.alpha - jpulse.alpha) < TOL * abs(jpulse.alpha)
    got = tepg.simulate([pulse, tepg.ADC], probe=["F0", "Z0"])
    want = jepg.simulate([jpulse, jepg.ADC], probe=["F0", "Z0"])
    for a, b in zip(got, want):
        assert np.abs(a - np.asarray(b)).max() < TOL


def test_encode_phase(port_f64):
    values = _sinc_pulse(32)
    prof = trf.encode_phase(trf.RFPulse(values, 2.0, alpha=90.0), 10.0, 30.0,
                            npoint=11, rewind=True)
    sig = tepg.simulate([prof, tepg.ADC])[0].squeeze()
    assert sig.shape[-1] == 11
    assert np.abs(sig[5]) > 0.9
    assert np.abs(sig[0]) < np.abs(sig[5])
    jprof = jrf.encode_phase(jrf.RFPulse(values, 2.0, alpha=90.0), 10.0,
                             30.0, npoint=11, rewind=True)
    want = np.asarray(jepg.simulate([jprof, jepg.ADC]))[0].squeeze()
    assert np.abs(sig - want).max() < TOL


def _pulse_train(e, rf):
    values = _sinc_pulse(16)
    seq = []
    for fa in (20.0, 35.0, 50.0):
        seq += [rf.RFPulse(values, 1.0, alpha=fa),
                e.E(4.0, 900.0, np.array([50.0, 90.0])), e.ADC,
                e.E(6.0, 900.0, np.array([50.0, 90.0])), e.S(1)]
    return seq


def test_rfpulse_in_a_planned_train(port_f64):
    """An RFPulse flattens into its sub-pulses, which the planner stacks
    into one scan block per pulse; the planned train equals the eager
    loop and JAX."""
    seq = _pulse_train(tepg, trf)
    flat = engine.flatten_sequence(seq)
    assert sum(isinstance(op, tepg.T) for op in flat) == 3 * 16
    kinds = engine._plan_and_payload(flat).kinds
    assert kinds.count(("scan", 16)) == 3
    got = tepg.simulate(seq)
    eager, _ = tepg.simulate_simple(
        tepg.StateMatrix().broadcast(tepg.getshape(seq)), seq,
        probes=[tepg.Probe("F0")])
    assert np.abs(got - np.stack([v[0].numpy() for v in eager])).max() == 0
    want = np.asarray(jepg.simulate(_pulse_train(jepg, jrf)))
    assert np.abs(got - want).max() < TOL


def _write_pta(path, values, start=0):
    mag, phase = np.abs(values), np.angle(values) % (2 * np.pi)
    lines = ["PULSENAME:\ttest.pta", "REFGRAD:\t10.0", ""]
    lines += [f"{m:.9f}\t{p:.9f}\t; ({i + start})"
              for i, (m, p) in enumerate(zip(mag, phase))]
    path.write_text("\n".join(lines))


def test_pta_roundtrip_and_load_pulse(port_f64, tmp_path):
    values = _sinc_pulse(16)
    path = tmp_path / "test.pta"
    _write_pta(path, values)
    header, parsed = pulseio.read_pulse(path)
    assert header["PULSENAME"] == "test.pta"
    mag, phase = np.abs(values), np.angle(values) % (2 * np.pi)
    assert np.allclose(parsed, mag * np.exp(1j * phase), atol=1e-8)
    small = pulseio.resample_pulse(parsed, 8)
    assert len(small) == 8
    from epgpy_tpu.utils import pulseio as jpulseio
    assert np.array_equal(small, jpulseio.resample_pulse(parsed, 8))
    _, resampled = pulseio.read_pulse(path, resample=8)
    assert np.array_equal(resampled, small)
    pulse = tepg.load_pulse(path, 1.0, alpha=30.0)
    assert isinstance(pulse, trf.RFPulse) and len(pulse) == 16
    jpulse = jpulseio.load_pulse(path, 1.0, alpha=30.0)
    assert abs(pulse.rf - jpulse.rf) < TOL * jpulse.rf
    with pytest.raises(NotImplementedError):
        pulseio.read_pulse(tmp_path / "test.txt")


def test_load_pta_rejects_bad_indices(tmp_path):
    head = "PULSENAME:\ttest\nCOMMENT:\tsynthetic\n"
    good = tmp_path / "ok.pta"
    good.write_text(head + "".join(f"{0.5:.6f} {0.0:.6f} ; ({i})\n"
                                   for i in range(3)))
    assert len(pulseio.load_pta(good)[1]) == 3
    dup = tmp_path / "dup.pta"
    dup.write_text(head + "0.5 0.0 ; (0)\n0.5 0.0 ; (1)\n0.7 0.0 ; (1)\n")
    with pytest.raises(IOError, match="Duplicate"):
        pulseio.load_pta(dup)
    gap = tmp_path / "gap.pta"
    gap.write_text(head + "0.5 0.0 ; (0)\n0.5 0.0 ; (2)\n")
    with pytest.raises(IOError, match="contiguous"):
        pulseio.load_pta(gap)


# -- slice-profile dictionaries (tests/test_slice_profile.py) --

NSAMP, DUR, GRAD, FOV, NPOINT, ALPHA0 = 64, 1.0, 10.0, 24.0, 33, 30.0
VALUES = _sinc_pulse(NSAMP, 2)


@pytest.fixture(scope="module")
def profile():
    from epgpy_torch import config

    old = config.precision(), config.device()
    config.set_device("cpu")
    config.set_precision("float64")
    try:
        pulse = trf.RFPulse(VALUES, DUR, alpha=ALPHA0)
        return slice_profile_scales(pulse, gradient=GRAD, fov=FOV,
                                    npoint=NPOINT, threshold=0.02)
    finally:
        config.set_precision(old[0])
        config.set_device(old[1])


def test_scales_sanity_and_jax(port_f64, profile):
    scales, weights = profile
    assert scales.ndim == 1 and scales.shape == weights.shape
    assert abs(scales.max() - 1.0) < 0.05
    assert (scales >= 0.02).all()
    np.testing.assert_allclose(weights, 1.0 / NPOINT)
    assert 3 <= len(scales) < NPOINT
    js, jw = jsp.slice_profile_scales(jrf.RFPulse(VALUES, DUR, alpha=ALPHA0),
                                      gradient=GRAD, fov=FOV, npoint=NPOINT,
                                      threshold=0.02)
    assert np.abs(scales - js).max() < TOL
    assert np.array_equal(weights, jw)


FA30 = 20.0 + 25.0 * np.sin(np.arange(30) * 0.21)


@pytest.mark.parametrize("kw", [
    dict(phi=0.0, nstate=6),
    dict(nstate=10, normalize=True),
    dict(nstate=5, inversion=20.0, demodulate=True),
], ids=["plain", "normalized", "inversion_demod"])
def test_sliced_dictionary_equals_jax(port_f64, profile, kw):
    scales, weights = profile
    T1s, T2s = np.array([700.0, 1200.0, 900.0]), np.array([60.0, 110.0,
                                                           80.0])
    B1s = np.array([0.9, 1.0, 1.1])
    re, im = fisp_mrf_dictionary_sliced(FA30, 12.0, 4.0, T1s, T2s, B1s,
                                        scales=scales, weights=weights, **kw)
    jre, jim = jsp.fisp_mrf_dictionary_sliced(
        FA30, 12.0, 4.0, T1s, T2s, B1s, scales=scales, weights=weights, **kw)
    assert re.shape == (3, 30)
    assert np.abs(re.numpy() - np.asarray(jre)).max() < TOL
    assert np.abs(im.numpy() - np.asarray(jim)).max() < TOL


def test_sliced_dictionary_matches_manual_sum(port_f64, profile):
    scales, weights = profile
    T1s, T2s = np.array([700.0, 1200.0]), np.array([60.0, 110.0])
    re, im = fisp_mrf_dictionary_sliced(FA30, 12.0, 4.0, T1s, T2s,
                                        scales=scales, weights=weights,
                                        phi=0.0, nstate=6)
    acc_re = np.zeros(re.shape)
    acc_im = np.zeros(re.shape)
    for s, w in zip(scales, weights):
        r1, i1 = fisp_mrf_dictionary(FA30, 12.0, 4.0, T1s, T2s,
                                     np.full(2, s), phi=0.0, nstate=6)
        acc_re += w * r1.numpy()
        acc_im += w * i1.numpy()
    np.testing.assert_allclose(re.numpy(), acc_re, atol=1e-12)
    np.testing.assert_allclose(im.numpy(), acc_im, atol=1e-12)


def test_sliced_dictionary_in_atom_chunks(port_f64, profile, monkeypatch):
    """Atoms in chunks (a chunk bound of 2 atoms) give the same sums."""
    scales, weights = profile
    T1s = np.linspace(500.0, 1500.0, 5)
    T2s = np.linspace(40.0, 120.0, 5)
    whole = fisp_mrf_dictionary_sliced(FA30, 12.0, 4.0, T1s, T2s,
                                       scales=scales, weights=weights)
    monkeypatch.setattr(tsp, "CHUNK_BYTES", 2 * len(scales) * len(FA30) * 8)
    chunked = fisp_mrf_dictionary_sliced(FA30, 12.0, 4.0, T1s, T2s,
                                         scales=scales, weights=weights)
    for a, b in zip(whole, chunked):
        assert np.abs(a.numpy() - b.numpy()).max() == 0.0


def test_sliced_dictionary_weight_length_mismatch(port_f64, profile):
    scales, _ = profile
    with pytest.raises(ValueError):
        fisp_mrf_dictionary_sliced(
            np.full(8, 30.0), 12.0, 4.0, np.array([800.0]),
            np.array([80.0]), scales=scales, weights=np.ones(len(scales) + 1))


def _shaped_pulse_oracle(FA, TR, TE, T1, T2, nstate):
    """Sum-over-slice signal of the train excited by the real pulse."""
    seq = []
    for fa in FA:
        pulse = trf.RFPulse(VALUES, DUR, alpha=float(fa))
        enc = trf.encode_phase(pulse, gradient=GRAD, fov=FOV, npoint=NPOINT,
                               rewind=True)
        seq += [enc, tepg.E(TE, T1, T2), tepg.ADC,
                tepg.E(TR - TE, T1, T2), tepg.S(1)]
    sig = tepg.simulate(seq, max_nstate=nstate)
    return sig.reshape(len(FA), NPOINT).sum(axis=1) / NPOINT


def _normalized_corr(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def test_correction_beats_uncorrected_vs_shaped_oracle(port_f64, profile):
    scales, weights = profile
    rng = np.random.default_rng(7)
    P = 40
    FA = 15.0 + 35.0 * np.abs(np.sin(np.arange(P) * 0.17)) \
        + rng.uniform(0, 4, P)
    TR, TE, T1, T2 = 12.0, 4.0, 900.0, 70.0
    oracle = _shaped_pulse_oracle(FA, TR, TE, T1, T2, nstate=8)
    re_c, im_c = fisp_mrf_dictionary_sliced(
        FA, TR, TE, np.array([T1]), np.array([T2]), scales=scales,
        weights=weights, phi=0.0, nstate=8)
    corrected = (re_c.numpy() + 1j * im_c.numpy())[0]
    re_u, im_u = fisp_mrf_dictionary(FA, TR, TE, np.array([T1]),
                                     np.array([T2]), phi=0.0, nstate=8)
    uncorrected = (re_u.numpy() + 1j * im_u.numpy())[0]
    err_c = 1.0 - _normalized_corr(corrected, oracle)
    err_u = 1.0 - _normalized_corr(uncorrected, oracle)
    assert err_c < 0.3 * err_u, (err_c, err_u)
    assert err_c < 5e-3, err_c
    amp_c = np.linalg.norm(corrected) / np.linalg.norm(oracle)
    amp_u = np.linalg.norm(uncorrected) / np.linalg.norm(oracle)
    assert abs(amp_c - 1.0) < 0.1, amp_c
    assert amp_u > 1.5, amp_u
