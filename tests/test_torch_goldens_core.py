"""The reference's float64 goldens through the port's general path.

``tests/golden/*.npz`` hold the reference epgpy's signals
(``tools/make_golden.py``); ``tests/test_fuzz.py`` and
``tests/test_shiftnd.py`` hold the JAX package to them.  The same
sequences, rebuilt from the goldens' specs with epgpy_torch's operators,
run through ``simulate()`` in float64 on the CPU (the planned general
path) at the JAX tests' own limits:

* ``fuzz.npz``: T/Phi/E/P/R/S(int)/SPOILER trains, 1e-10, max_nstate 12;
* ``fuzz_physics.npz``: diffusion (scalar and tensor D) and two-pool
  EPG-X trains, 1e-8, with ``probe=["F0", "Z0"]`` and the X cases'
  ``init``/``density``;
* ``fuzz_modify.npz``: trains rewritten by ``modify()``, 1e-10;
* ``diffusion_se.npz``: a diffusion-weighted spin echo, 1e-10.
"""

import json
import os

import numpy as np
import pytest

import epgpy_torch as epg

from torch_support import GOLDEN_DIR, port_f64  # noqa: F401


def _load(name):
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    return g, json.loads(bytes(g["specs_json"]).decode())


def _ref(g, i):
    return g[f"sig_re_{i:02d}"] + 1j * g[f"sig_im_{i:02d}"]


_G, _SPECS = _load("fuzz")


def _build_fuzz(specs):
    seq = []
    for sp in specs:
        k = sp["k"]
        if k == "T":
            seq.append(epg.T(np.asarray(sp["alpha"]), sp["phi"]))
        elif k == "E":
            seq.append(epg.E(sp["tau"], sp["T1"], np.asarray(sp["T2"]),
                             g=sp["g"]))
        elif k == "P":
            seq.append(epg.P(sp["tau"], sp["g"]))
        elif k == "R":
            seq.append(epg.R(sp["rT"], sp["rL"], r0=sp["r0"]))
        elif k == "Phi":
            seq.append(epg.Phi(sp["phi"]))
        elif k == "S":
            seq.append(epg.S(sp["kint"]))
        elif k == "SPOILER":
            seq.append(epg.SPOILER)
        elif k == "ADC":
            seq.append(epg.ADC)
        else:  # pragma: no cover
            raise ValueError(k)
    return seq


@pytest.mark.parametrize("i", range(len(_SPECS)))
def test_fuzz_golden(port_f64, i):
    sig = epg.simulate(_build_fuzz(_SPECS[i]), max_nstate=12)
    assert np.abs(sig.ravel() - _ref(_G, i)).max() < 1e-10, f"sequence {i}"


_GP, _PSPECS = _load("fuzz_physics")


@pytest.mark.parametrize("i", range(len(_PSPECS)))
def test_fuzz_physics_golden(port_f64, i):
    sp = _PSPECS[i]
    if sp["kind"] == "D":
        Dv = np.asarray(sp["D"])
        if not sp["aniso"]:
            Dv = float(Dv)
        seq = [epg.T(90, 90)]
        for it in sp["items"]:
            seq += [epg.S(it["kint"]), epg.D(it["tau"], Dv, k=it["kint"]),
                    epg.T(it["alpha"], 0), epg.ADC]
        sig = np.asarray(epg.simulate(seq, kvalue=sp["kvalue"],
                                      probe=["F0", "Z0"]))
    else:
        khi = epg.exchange_matrix(sp["k12"], axis=-1, ncomp=2,
                                  densities=sp["densities"])
        X = epg.X(sp["TR"], khi, axis=-1, T1=sp["T1"], T2=sp["T2"],
                  g=sp["g"])
        seq = []
        for _ in range(sp["ntr"]):
            seq += [epg.T(sp["alpha"], 0), epg.ADC, X, epg.S(1)]
        init = (np.array([0, 0, 1.0])
                * np.array(sp["densities"])[:, None, None])
        sig = np.asarray(epg.simulate(seq, max_nstate=8, init=init,
                                      density=sp["densities"]))
    assert np.abs(sig.ravel() - _ref(_GP, i)).max() < 1e-8, f"sequence {i}"


_GM, _MSPECS = _load("fuzz_modify")


@pytest.mark.parametrize("i", range(len(_MSPECS)))
def test_fuzz_modify_golden(port_f64, i):
    sp = _MSPECS[i]
    seq = [epg.T(90, 90)]
    for n in range(sp["ntr"]):
        seq += [epg.S(1, duration=sp["durs"][n]),
                epg.T(sp["alphas"][n], sp["phis"][n]), epg.ADC]
    kw = {"T1": sp["T1"], "T2": np.asarray(sp["T2"])}
    if sp["g"] is not None:
        kw["g"] = np.asarray(sp["g"])[None, :]
    if sp["att"] is not None:
        kw["att"] = sp["att"]
    sig = epg.simulate(epg.modify(seq, **kw))
    assert np.abs(sig.ravel() - _ref(_GM, i)).max() < 1e-10, f"sequence {i}"


@pytest.mark.parametrize("i, tau", enumerate((5.0, 10.0, 20.0)))
def test_diffusion_se_golden(port_f64, i, tau):
    """tests/test_shiftnd.py:73: the echo and its closed-form attenuation
    exp(-b D), b = 2/3 k^2 tau per lobe."""
    g = np.load(os.path.join(GOLDEN_DIR, "diffusion_se.npz"))
    Dc, kvalue = 1e-3, 500.0
    seq = [epg.T(90, 90), epg.S(1, duration=tau), epg.D(tau, Dc, k=1),
           epg.T(180, 0), epg.S(1, duration=tau), epg.D(tau, Dc, k=1),
           epg.ADC]
    sig = epg.simulate(seq, kvalue=kvalue)
    assert np.abs(sig - g["signal"][i]).max() < 1e-10
    b = 2.0 * (kvalue * 1e-3) ** 2 * (tau * 1e-3) / 3.0
    assert np.allclose(np.abs(sig), np.exp(-b * Dc), atol=1e-8)
