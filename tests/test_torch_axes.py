"""``axes=`` pinning in epgpy_torch against epgpy_tpu.

The pinning (reference epgpy/common.py:337-347; JAX
``common.shape_with_axes`` / ``set_axes``) moves an operator's batch axes
to chosen positions of the simulation's batch:

* T, Phi, E, P, R, ScalarOp and MatrixOp with ``axes=`` give JAX's
  signals (float64, 1e-12) and equal their explicitly broadcast forms;
* ``shape_with_axes`` refuses an axes tuple of the wrong length;
* a pinned op in a periodic block is planned (stacked or constant slot,
  never a precomputed diagonal) and gives JAX's signal;
* a pinned train of every kernel family is declined by every matcher:
  ``simulate(fisp_kernel="force")`` dispatches nothing, as in JAX.
"""

import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import engine, fisp_dispatch as tfd
from epgpy_tpu import fisp_dispatch as jfd

from torch_support import family_train, port_f32, port_f64  # noqa: F401

ATOL = 1e-12
ALPHA = np.array([20.0, 45.0, 70.0])
T2S = np.array([30.0, 60.0, 90.0, 150.0])


def _ops(e):
    """(name, pinned train, explicitly broadcast train) in package `e`:
    each op's sweep pinned to batch axis 1 (or 2), beside a flip sweep on
    axis 0."""
    g = np.array([0.01, -0.02])
    mat = np.stack([np.diag([np.exp(1j * p), np.exp(-1j * p), 1.0])
                    for p in (0.3, 0.9)])
    arr = np.stack([[0.9, 0.9, 0.97], [0.8, 0.8, 0.95], [0.7, 0.7, 0.9],
                    [0.6, 0.6, 0.85]]).astype(complex)
    base = [e.T(ALPHA, 90)]
    tail = [e.ADC, e.S(1)]
    return {
        "T": ([e.T(90, 90), e.T(T2S, 0, axes=1)] + tail,
              [e.T(90, 90), e.T(T2S[None, :], 0)] + tail),
        "Phi": (base + [e.Phi(T2S, axes=1), e.T(30, 0)] + tail,
                base + [e.Phi(T2S[None, :]), e.T(30, 0)] + tail),
        "E": (base + [e.E(5.0, 1000.0, T2S, axes=1)] + tail,
              base + [e.E(5.0, 1000.0, T2S[None, :])] + tail),
        "E2": (base + [e.E(5.0, 1000.0, T2S, axes=(2,))] + tail,
               base + [e.E(5.0, 1000.0, T2S[None, None, :])] + tail),
        "P": (base + [e.P(4.0, g, axes=1), e.T(30, 0)] + tail,
              base + [e.P(4.0, g[None, :]), e.T(30, 0)] + tail),
        "R": (base + [e.R(T2S / 100.0, 0.05, r0=0.05, axes=1)] + tail,
              base + [e.R((T2S / 100.0)[None, :], 0.05, r0=0.05)] + tail),
        "ScalarOp": (base + [e.ScalarOp(arr, axes=1)] + tail,
                     base + [e.ScalarOp(arr[None])] + tail),
        "MatrixOp": (base + [e.MatrixOp(mat, axes=1), e.T(30, 0)] + tail,
                     base + [e.MatrixOp(mat[None]), e.T(30, 0)] + tail),
    }


@pytest.mark.parametrize("name", sorted(_ops(tepg)))
def test_pinned_op_equals_jax_and_broadcast_form(port_f64, name):
    pinned, explicit = _ops(tepg)[name]
    jpinned, _ = _ops(jepg)[name]
    got = tepg.simulate(pinned * 3)
    assert tepg.getshape(pinned) == jepg.getshape(jpinned)
    want = np.asarray(jepg.simulate(jpinned * 3))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < ATOL
    bcast = tepg.simulate(explicit * 3)
    assert np.abs(got - bcast).max() == 0.0


def test_scalar_pulse_with_axes(port_f64):
    sm = tepg.StateMatrix([0, 0, 1], nstate=2)
    assert tepg.T(90.0, 0.0, axes=1)(sm).shape == (1, 1)


def test_shape_with_axes_validates(port_f64):
    with pytest.raises(ValueError, match="axes"):
        tepg.T(np.array([30.0, 60.0, 90.0]), 0.0, axes=(0, 1)).shape
    from epgpy_torch import common
    assert common.shape_with_axes((3, 4), (0, 2)) == (3, 1, 4)
    assert common.shape_with_axes((3,), 2) == (1, 1, 3)


def _planned_train(e):
    """A periodic block whose pinned E varies per repetition (a stacked
    slot) beside a constant pinned P (a constant slot)."""
    seq = [e.T(90, 90)]
    for i in range(6):
        seq += [e.T(ALPHA + i, 90), e.E(5.0, 1000.0 + 50 * i, T2S, axes=1),
                e.ADC, e.P(3.0, np.array([0.01, 0.03]), axes=2), e.S(1)]
    return seq


def test_pinned_ops_plan_and_equal_jax(port_f64):
    seq = _planned_train(tepg)
    flat = engine.flatten_sequence(seq)
    entry = engine._plan_and_payload(flat)
    assert ("scan", 6) in entry.kinds
    slots = entry.payload[entry.kinds.index(("scan", 6))][1]
    # the pinned E stays an E (no precomputed diagonal), stacked per rep
    assert any(s[0] == "stack" and type(s[1]) is tepg.E for s in slots)
    assert all(type(s[1]).__name__ != "PrecomputedDiagonal" for s in slots)
    got = tepg.simulate(seq)
    want = np.asarray(jepg.simulate(_planned_train(jepg)))
    assert got.shape == want.shape == (6, 3, 4, 2)
    assert np.abs(got - want).max() < ATOL
    eager, _ = tepg.simulate_simple(
        tepg.StateMatrix().broadcast(tepg.getshape(seq)), seq,
        probes=[tepg.Probe("F0")])
    assert np.abs(got - np.stack([v[0].numpy() for v in eager])).max() == 0


def _pinned(e, seq):
    """Every E of a train pinned to batch axis 0 (where its sweep already
    is: the signal does not change)."""
    return [e.E(op.tau, op.T1, op.T2, op.g, axes=0)
            if type(op) is e.E else op for op in seq]


@pytest.mark.parametrize("fam", ["fisp", "mse", "bssfp", "dess", "megre",
                                 "dw", "comp"])
def test_pinned_family_trains_are_declined(port_f32, fam):
    """Each family takes its train and declines the same train pinned; the
    pinned train's counts and signal equal JAX's forced simulate (the JAX
    matchers' ``axes`` guards)."""
    kw = dict(fisp_kernel="force", max_nstate=8)
    if fam == "dw":
        kw["kvalue"] = 2.0
    counts = []
    for e, fd in ((tepg, tfd), (jepg, jfd)):
        fd.DISPATCH_COUNTS.clear()
        plain = np.asarray(e.simulate(family_train(e, fam), **kw))
        assert sum(fd.DISPATCH_COUNTS.values()) == 1
        fd.DISPATCH_COUNTS.clear()
        pinned = np.asarray(e.simulate(_pinned(e, family_train(e, fam)),
                                       **kw))
        counts.append(dict(fd.DISPATCH_COUNTS))
        assert np.abs(pinned - plain).max() < 1e-5
    assert counts[0] == counts[1] == {}
