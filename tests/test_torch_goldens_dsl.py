"""The reference's float64 goldens of the sequence DSL and the shaped
pulses through the port.

``tests/golden/*.npz`` hold the reference epgpy's results
(``tools/make_golden.py``); the JAX package's tests hold it to them.  The
same cases, rebuilt with epgpy_torch's names, run in float64 on the CPU
at the JAX tests' own limits:

* ``fuzz_expr`` (14 cases; ``tests/test_fuzz.py:227-245``): random
  expression trees of two variables as flip angles and relaxation times,
  the DSL's ``Sequence.jacobian`` w.r.t. both against the reference's
  symbolic chain rule, 1e-8;
* ``fuzz_rfpulse`` (10 cases; ``tests/test_fuzz.py:253-263``): random
  real and complex envelopes at an explicit rf, swept over off-resonance
  by ``modify(g=...)``, 1e-8 on the signal;
* ``rfpulse_profile`` (``tests/test_rfpulse_io.py:46-54``): a 90-degree
  calibration of a shaped pulse, its rf within rtol 1e-6 of the
  reference's and its off-resonance profile within 1e-8.
"""

import json
import os

import numpy as np
import pytest

import epgpy_torch as epg
from epgpy_torch.sequence import Sequence, Variable, math, operators

from torch_support import GOLDEN_DIR, port_f64  # noqa: F401


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


def _specs(g):
    return json.loads(bytes(g["specs_json"]).decode())


def _ref(g, kind, i):
    return g[f"{kind}_re_{i:02d}"] + 1j * g[f"{kind}_im_{i:02d}"]


_GE = _golden("fuzz_expr")
_ESPECS = _specs(_GE)
_GR = _golden("fuzz_rfpulse")
_RSPECS = _specs(_GR)


def _expr_build(node, V, M):
    """Mirror of tools/make_golden.py:_expr_build (shared tree spec)."""
    op = node[0]
    if op == "var":
        return V[node[1]]
    if op == "const":
        return node[1]
    a = _expr_build(node[1], V, M)
    if op == "exp":
        return M.exp(a * (-0.2))
    if op == "sqr":
        return a * a
    b = _expr_build(node[2], V, M)
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    return a / (b * b + 0.5)


@pytest.mark.parametrize("i", range(len(_ESPECS)))
def test_fuzz_expr_golden(port_f64, i):
    sp = _ESPECS[i]
    V = {"x": Variable("x"), "y": Variable("y")}
    seq = []
    for n in range(sp["ntr"]):
        alpha = _expr_build(sp["trees_a"][n], V, math) * 10 + 20
        tau = _expr_build(sp["trees_t"][n], V, math) * 0.5 + 2
        seq += [operators.T(alpha, 90), operators.E(tau, 1000.0, 80.0),
                "ADC", operators.S(1)]
    _, jac = Sequence(seq).jacobian(["x", "y"])(**sp["vals"])
    assert np.abs(jac.numpy() - _ref(_GE, "jac", i)).max() < 1e-8


@pytest.mark.parametrize("i", range(len(_RSPECS)))
def test_fuzz_rfpulse_golden(port_f64, i):
    sp = _RSPECS[i]
    env = np.asarray(sp["env_re"]) + 1j * np.asarray(sp["env_im"])
    pulse = epg.RFPulse(env, sp["dur"], rf=sp["rf"])
    seq = epg.modify([pulse], g=np.asarray(sp["freqs"]), expand=False)
    sig = epg.simulate(list(seq) + [epg.ADC])
    assert np.abs(sig.ravel() - _ref(_GR, "sig", i)).max() < 1e-8


def test_rfpulse_profile_golden(port_f64):
    g = _golden("rfpulse_profile")
    values = g["values_re"] + 1j * g["values_im"]
    pulse = epg.RFPulse(values, 2.0, alpha=90.0)
    assert np.isclose(pulse.rf, g["rf"], rtol=1e-6)
    seq = epg.modify([pulse], g=g["freqs"], expand=False)
    sig = epg.simulate(list(seq) + [epg.ADC])
    assert np.abs(sig - g["signal"]).max() < 1e-8
