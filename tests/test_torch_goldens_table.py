"""The reference's float64 goldens of the coordinate-table path through
the port.

``tests/golden/*.npz`` hold the reference epgpy's signals
(``tools/make_golden.py``); ``tests/test_fuzz.py``,
``tests/test_shiftnd.py``, ``tests/test_diffusion.py`` and
``tests/test_rfpulse_io.py`` hold the JAX package to them.  The same
trains, rebuilt with epgpy_torch's operators (the examples' builders
copied below with the port's names), run through ``simulate()`` in
float64 on the CPU at the JAX tests' own limits:

* ``fuzz_shift`` (n-D and float shift-merge trains), ``fuzz_time`` (the C
  operator's accumulated time), ``fuzz_prune`` (batch-varying float
  shifts): 1e-8, one case per train;
* ``shift_merge``, ``shift_prune``, ``t2star``: 1e-8;
  ``shift3d_diffusion``: 1e-10;
* ``rare_diffusion`` (``examples/rare_diffusion.py``): 1e-12;
  ``ssfp_dwi`` (``examples/ssfp_diffusion.py``, DFT probes): 5e-6;
  ``press`` (``examples/press_mrs.py``): 1e-10; ``gre2d``
  (``examples/gradient_echo_2d.py``, Imaging with System weights and
  T2' modulation): 1e-4 of the k-space scale; ``imaging_probe``: 1e-10.

The cheaper trains are also run through the JAX package, and the port
held to it at the same limits.
"""

import json
import os

import numpy as np
import pytest

import epgpy_torch as epg
import epgpy_tpu as jepg

from torch_support import GOLDEN_DIR, port_f64  # noqa: F401


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


def _specs(g):
    return json.loads(bytes(g["specs_json"]).decode())


def _ref(g, i):
    return g[f"sig_re_{i:02d}"] + 1j * g[f"sig_im_{i:02d}"]


_GS = _golden("fuzz_shift")
_GT = _golden("fuzz_time")
_GPR = _golden("fuzz_prune")


def _fuzz_shift_train(e, sp):
    seq = [e.T(90, 90)]
    for it in sp["items"]:
        kv = np.asarray(it["kv"])
        if not sp["float"]:
            kv = kv.astype(int)
        seq += [e.S(kv), e.T(it["alpha"], it["phi"]),
                e.E(it["tau"], 1000.0, it["T2"]), e.ADC]
    return seq


def _fuzz_time_train(e, sp):
    seq = [e.T(90, 90)]
    for it in sp["items"]:
        seq += [e.C(it["tau"], it["r2"])]
        if it["kind"] == "CS":
            seq += [e.S(it["kint"])]
        elif it["kind"] == "CT":
            seq += [e.T(it["alpha"], 0)]
        seq += [e.E(2.0, 1000.0, 80.0), e.ADC]
    return seq


def _fuzz_prune_train(e, sp):
    ks = np.asarray(sp["ks"])
    seq = [e.T(90, 90)]
    for it in sp["items"]:
        seq += [e.S(ks * it["scale"]), e.T(it["alpha"], it["phi"]),
                e.E(it["tau"], 1000.0, it["T2"]), e.ADC]
    return seq


@pytest.mark.parametrize("i", range(len(_specs(_GS))))
def test_fuzz_shift_golden(port_f64, i):
    sp = _specs(_GS)[i]
    sig = epg.simulate(_fuzz_shift_train(epg, sp), max_nstate=200,
                       kgrid=sp["kgrid"], probe=["F0", "Z0"])
    assert np.abs(np.asarray(sig).ravel() - _ref(_GS, i)).max() < 1e-8


@pytest.mark.parametrize("i", range(len(_specs(_GT))))
def test_fuzz_time_golden(port_f64, i):
    sp = _specs(_GT)[i]
    sig = epg.simulate(_fuzz_time_train(epg, sp), max_nstate=40,
                       kgrid=0.05, probe="F0")
    assert np.abs(sig.ravel() - _ref(_GT, i)).max() < 1e-8


@pytest.mark.parametrize("i", range(len(_specs(_GPR))))
def test_fuzz_prune_golden(port_f64, i):
    sp = _specs(_GPR)[i]
    sig = epg.simulate(_fuzz_prune_train(epg, sp), max_nstate=256,
                       kgrid=sp["kgrid"], probe=["F0", "Z0"])
    assert np.abs(np.asarray(sig).ravel() - _ref(_GPR, i)).max() < 1e-8


@pytest.mark.parametrize("i", [0, 7, 13])
def test_fuzz_shift_matches_jax(port_f64, i):
    sp = _specs(_GS)[i]
    kw = dict(max_nstate=200, kgrid=sp["kgrid"], probe=["F0", "Z0"])
    got = np.asarray(epg.simulate(_fuzz_shift_train(epg, sp), **kw))
    want = np.asarray(jepg.simulate(_fuzz_shift_train(jepg, sp), **kw))
    assert np.abs(got - want).max() < 1e-8


def _shift_merge_train(e):
    return [e.T(90, 90),
            e.S(np.array([[1.3]]), kgrid=0.5), e.T(120, 0),
            e.S(np.array([[0.9]]), kgrid=0.5), e.T(45, 90),
            e.S(np.array([[-1.3]]), kgrid=0.5), e.T(30, 0), e.ADC]


def _shift_prune_train(e, ks):
    return [e.T(90, 90), e.S(ks, kgrid=0.25), e.T(120, 0),
            e.S(ks, kgrid=0.25), e.T(60, 45), e.S(-ks, kgrid=0.25), e.ADC]


def _shift3d_train(e):
    Dt = np.diag([2e-3, 1e-3, 0.5e-3])
    k1, k2, tau = np.array([[1, 0, 0]]), np.array([[0, 1, 1]]), 5.0
    return [e.T(90, 90), e.S(k1), e.D(tau, Dt, k=k1), e.T(150, 0),
            e.S(k2), e.D(tau, Dt, k=k2), e.T(60, 30),
            e.S(-k2), e.D(tau, Dt, k=-k2), e.S(-k1), e.D(tau, Dt, k=-k1),
            e.ADC]


@pytest.mark.parametrize("pkg", ["golden", "jax"])
def test_shift_merge_golden(port_f64, pkg):
    sig = np.asarray(epg.simulate(_shift_merge_train(epg), max_nstate=30,
                                  probe=["F0", "Z0"]))
    want = _golden("shift_merge")["signal"] if pkg == "golden" else \
        np.asarray(jepg.simulate(_shift_merge_train(jepg), max_nstate=30,
                                 probe=["F0", "Z0"]))
    assert np.abs(sig - want).max() < 1e-8


@pytest.mark.parametrize("pkg", ["golden", "jax"])
def test_shift_prune_golden(port_f64, pkg):
    g = _golden("shift_prune")
    sig = np.asarray(epg.simulate(_shift_prune_train(epg, g["ks"]),
                                  max_nstate=20, probe=["F0", "Z0"]))
    want = g["signal"] if pkg == "golden" else np.asarray(jepg.simulate(
        _shift_prune_train(jepg, g["ks"]), max_nstate=20,
        probe=["F0", "Z0"]))
    assert np.abs(sig - want).max() < 1e-8


def test_shift_prune_batch_varying(port_f64):
    """Each atom of a batch-varying float-shift train evolves as its own
    single-atom train (JAX ``test_shift_prune_batch_varying``)."""
    ks = np.array([[0.7], [1.3], [2.1]])
    sig = np.asarray(epg.simulate(_shift_prune_train(epg, ks),
                                  max_nstate=20, probe=["F0", "Z0"]))
    for i in range(3):
        sigi = np.asarray(epg.simulate(_shift_prune_train(epg, ks[i:i + 1]),
                                       max_nstate=20, probe=["F0", "Z0"]))
        assert np.abs(sig[:, :, i] - sigi[:, :, 0]).max() < 1e-10


@pytest.mark.parametrize("pkg", ["golden", "jax"])
def test_shift3d_diffusion_golden(port_f64, pkg):
    sig = np.asarray(epg.simulate(_shift3d_train(epg), probe=["F0", "Z0"]))
    want = _golden("shift3d_diffusion")["signal"] if pkg == "golden" else \
        np.asarray(jepg.simulate(_shift3d_train(jepg), probe=["F0", "Z0"]))
    assert np.abs(sig - want).max() < 1e-10


@pytest.mark.parametrize("part", ["fid", "echo"])
def test_t2star_golden(port_f64, part):
    g = _golden("t2star")
    if part == "fid":
        seq = [epg.T(90, 90)] + [epg.C(2.0, 0.3), epg.ADC] * 6
    else:
        seq = [epg.T(90, 90), epg.C(2.0, 0.3), epg.T(150, 0),
               epg.C(2.0, 0.3), epg.ADC]
    sig = epg.simulate(seq, max_nstate=20, kgrid=0.1)
    assert np.abs(sig - g[part]).max() < 1e-8
    if part == "fid":
        expected = np.exp(-0.3 * 2.0 * np.arange(1, 7))
        assert np.allclose(np.abs(sig[:, 0]), expected, atol=1e-8)


# -- the examples' trains (the builders of examples/*.py, with the port) --


def rare_signals(angles, etl, diffusion, kgrid=10.0):
    """examples/rare_diffusion.py: RARE train, last echo per angle."""
    from epgpy_torch.utils import helpers

    taurf = 2.56
    k2 = helpers.get_wavenumber(7.2, 4.0)
    kS = helpers.get_wavenumber(9.9, 0.72)
    k1 = k2 / 2 + kS
    T1, T2, D = 1e3, 1e2, 1e-3
    exc, trf = epg.T(90, 90), epg.T(np.asarray(angles), 0)
    erf = epg.E(taurf / 2, T1, T2)
    e1, e2, eS = epg.E(1.44, T1, T2), epg.E(2.0, T1, T2), epg.E(0.72, T1, T2)
    s1, s2, sS = epg.S(k1), epg.S(k2 / 2), epg.S(kS)
    if diffusion:
        d1, d2 = epg.D(1.44, D, k=k1), epg.D(2.0, D, k=k2 / 2)
        dS = epg.D(0.72, D, k=kS)
        init = [erf, s1, d1, e1]
        pre = [s2, d2, e2, sS, dS, eS, erf]
        post = [erf, sS, dS, eS, s2, d2, e2]
    else:
        init = [erf, s1, e1]
        pre = [s2, e2, sS, eS, erf]
        post = [erf, sS, eS, s2, e2]
    seq = [exc, init, trf, post] + [pre, trf, post] * etl + [epg.ADC]
    return np.asarray(epg.simulate(seq, kgrid=kgrid))[0]


def test_rare_diffusion_golden(port_f64):
    g = _golden("rare_diffusion")
    sig = rare_signals(g["angles"], 6, True)
    sig0 = rare_signals(g["angles"], 6, False)
    assert np.abs(sig - g["signal"]).max() < 1e-12
    assert np.abs(sig0 - g["signal_nodiff"]).max() < 1e-12
    b = -np.log(np.abs(sig / sig0)) / 1e-3
    assert b[0] > b[-1] > 0


def ssfp_dwi_signals(nrf, npos, scheme, kgrid=1.0, max_nstate=384):
    """examples/ssfp_diffusion.py: SSFP DWI profile, (nrf, npos)."""
    from epgpy_torch.utils import constants

    FA, Gdiff, Tdiff, TR = 25.0, 23.5, 5.0, 10.0
    T1, T2 = 1084.0, 68.0
    D = np.diag([1.35, 0.5, 0]) * 1e-3
    FOV, Freq = 0.128, 100.0
    G = Freq / (FOV / 2) / constants.gamma_1H
    pos = np.c_[np.zeros((npos, 2)), np.linspace(-0.5, 0.5, npos) * FOV]
    gradx, grady = [Gdiff, 0, G], [0, Gdiff, G]
    adc = epg.DFT(pos)
    rf1, rf2 = epg.T(FA, 0), epg.T(FA, 180)
    g1x, g1y = epg.G(Tdiff, gradx), epg.G(Tdiff, grady)
    g2 = epg.G(TR - Tdiff, [0, 0, G])
    d1x, d1y = epg.D(Tdiff, D, k=g1x.k), epg.D(Tdiff, D, k=g1y.k)
    d2 = epg.D(TR - Tdiff, D, k=g2.k)
    rx1, rx2 = epg.E(Tdiff, T1, T2), epg.E(TR - Tdiff, T1, T2)
    second = (g1x, d1x) if scheme == "conventional" else (g1y, d1y)
    seq = (nrf // 2) * [
        [rf1, [g1x, d1x, rx1], [g2, d2, rx2], adc],
        [rf2, [second[0], second[1], rx1], [g2, d2, rx2], adc],
    ]
    return np.asarray(epg.simulate(seq, kgrid=kgrid,
                                   max_nstate=max_nstate)).squeeze()


@pytest.mark.parametrize("scheme, key", [
    ("conventional", "conventional"), ("quasi-isotropic", "quasi_isotropic")])
def test_ssfp_dwi_golden(port_f64, scheme, key):
    sig = ssfp_dwi_signals(30, 51, scheme)
    assert np.abs(sig - _golden("ssfp_dwi")[key]).max() < 5e-6


def press_images(crushers, npix=8, max_nstate=64, fov=48.0):
    """examples/press_mrs.py: the 3-D image after each of 4 ADCs."""
    from epgpy_torch.utils import constants, imaging

    gamma = constants.gamma_1H
    grid = fov * 1e-3 * np.stack(
        np.meshgrid(*[np.linspace(-0.5, 0.5, npix)] * 3, indexing="ij"), -1)
    kfilt = 2 * np.pi / (fov * 1e-3 / npix)
    TE1, TE2 = 14.0, 16.0
    Gs = np.array([0.1, -0.2, 0.3]) / gamma * 1e2
    kim = 2 * np.pi * npix / fov * 1e3
    rf1, rf2, rf3 = epg.T(90, 90), epg.T(90, 0), epg.T(90, 0)
    eye = 0.5 * np.eye(3)
    gy, gz = epg.S(eye[1] * kim), epg.S(eye[2] * kim)
    gc1, gc2, gc3, gc4 = (epg.S(np.asarray(c, float)) for c in crushers)
    gs1 = epg.G(TE1 / 2, Gs, duration=True)
    gs2 = epg.G(TE2 / 2, Gs, duration=True)
    gslong = epg.G(100.0, Gs, duration=True)
    seq = [[rf1], [gs1, gc1, gy, rf2, gy, gc2, gs1], epg.ADC,
           [gs2, gc3, gz, rf3, gz, gc4, gs2], epg.ADC,
           [gslong], epg.ADC, [gslong], epg.ADC]
    F, k = epg.simulate(seq, kgrid=1.0, max_nstate=max_nstate,
                        probe=("F", "k"))
    images = []
    for i in range(4):
        Fi, ki = F[i].squeeze(0), k[i].squeeze(0)
        keep = np.all(np.abs(ki) <= kfilt, axis=-1)
        images.append(imaging.dft(grid, Fi[keep], ki[keep]).numpy())
    return np.stack(images)


def test_press_golden(port_f64):
    kc = 2 * np.pi * 50.0
    images = press_images([[kc] * 3] * 4)
    assert np.abs(images - _golden("press")["images"]).max() < 1e-10


def gre2d_kspace(n=16, fov=200e-3, fa=30.0, tr=10.0, prune=1e-4,
                 max_nstate=256):
    """examples/gradient_echo_2d.py: (nphase, nread) k-space of the
    ellipse phantom."""
    y, x = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    outer = ((x / 0.85) ** 2 + (y / 0.95) ** 2 < 1).astype(float)
    wm = (((x / 0.55) ** 2 + ((y - 0.05) / 0.65) ** 2) < 1
          ).astype(float) * outer
    gm = np.clip(outer - wm, 0, 1)
    csf = ((((x + 0.15) / 0.2) ** 2 + ((y + 0.2) / 0.25) ** 2) < 1
           ).astype(float) * outer
    wm, gm = np.clip(wm - csf, 0, 1), np.clip(gm - csf, 0, 1)
    mask = np.max([wm, gm, csf], axis=0) > 1e-5
    PD, T1 = [0.8, 0.7, 1.0], [1.55e3, 0.83e3, 4.16e3]
    T2, T2p = [0.09e3, 0.07e3, 1.65e3], [0.322e3, 0.183e3, 0.0591e3]
    pds = np.stack([gm * PD[0], wm * PD[1], csf * PD[2]]).reshape(
        3, -1)[:, mask.flat]
    pixels = (np.mgrid[-n // 2:n // 2, -n // 2:n // 2]
              .reshape(2, -1).T[mask.flat] * fov / np.array([n, n]))
    init = epg.System(weights=pds[None], modulation=-1 / np.asarray([T2p]))
    rf = epg.T(fa, 0)
    adc = epg.Imaging(pixels, voxel_size=fov / n, phase=-rf.phi,
                      reduce=(1, 2))
    tau1 = np.asarray([i * tr / n for i in range(n)])
    tau2 = np.asarray([tr * (n - 1 - i) / n for i in range(n)])
    rlx1 = epg.E(tau1, [T1], [T2]) * epg.C(tau1)
    rlx2 = epg.E(tau2, [T1], [T2]) * epg.C(tau2)
    kx, ky = np.array([2 * np.pi / fov, 0.0]), np.array([0.0, 2 * np.pi / fov])
    gx1 = epg.S(np.asarray([kx * (i - n / 2) for i in range(n)]))
    gx2 = epg.S(np.asarray([kx * (n - i + 1) for i in range(n)]))
    gxspl = epg.S(1.5 * kx * n / 2)
    lines = range(-n // 2, n // 2)
    gp1 = [epg.S(ky * i) if i else epg.NULL for i in lines]
    gp2 = [epg.S(-ky * i) if i else epg.NULL for i in lines]
    seq = [init] + [[rf, gx1, gp1[i], rlx1, adc, rlx2, gx2, gxspl, gp2[i]]
                    for i in range(n)]
    return np.asarray(epg.simulate(seq, prune=prune, kgrid=1e-8,
                                   max_nstate=max_nstate))


def test_gre2d_golden(port_f64):
    g = _golden("gre2d")
    ks = gre2d_kspace()
    scale = np.abs(g["kspace"]).max()
    assert np.abs(ks - g["kspace"]).max() < 1e-4 * scale


def _imaging_train(e, positions):
    return [e.T(90, 90), e.S(1, duration=1.0), e.T(30, 0),
            e.S(1, duration=1.0),
            e.Imaging(positions, reduce=False, voxel_size=2e-3)]


@pytest.mark.parametrize("pkg", ["golden", "jax"])
def test_imaging_probe_golden(port_f64, pkg):
    g = _golden("imaging_probe")
    sig = np.asarray(epg.simulate(_imaging_train(epg, g["positions"]),
                                  kvalue=400.0))
    want = g["signal"] if pkg == "golden" else np.asarray(jepg.simulate(
        _imaging_train(jepg, g["positions"]), kvalue=400.0))
    assert np.abs(sig - want).max() < 1e-10
