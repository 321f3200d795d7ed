"""The sequence DSL of epgpy_torch against epgpy_tpu's.

``tests/test_sequence.py``'s cases, each built in both packages from the
same numbers and held to its own assertion in the port and to the JAX
package's result within 1e-10 (float64 on the CPU; the closures return
tensors on the working device).  A parametrised case checks the routes:
the 4-op and 5-op DSL trains, with per-atom and scalar T1, through
``signal``, ``jacobian`` and ``hessian`` with ``fisp_kernel="force"`` in
float32 give the port the dispatch counts JAX's give (the signal reaches
the fisp or composite kernel family; the derivative trains take the
general diff path, as in JAX: their unit coefficients are per-atom arrays
and the Hessian's ops carry order2 entries).
"""

import pickle

import numpy as np
import pytest

import epgpy_tpu as jepg
import epgpy_torch as tepg
from epgpy_torch import fisp_dispatch as tfd
from epgpy_torch import sequence as tseq
from epgpy_tpu import fisp_dispatch as jfd
from epgpy_tpu import sequence as jseq

from torch_support import port_f32, port_f64  # noqa: F401

TOL = 1e-10
BOTH = [(tseq, tepg), (jseq, jepg)]


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() < tol


def _cpmg(m, n, T2=None):
    T2 = m.Variable("T2") if T2 is None else T2
    o = m.operators
    return m.Sequence([o.T(90, 90)] + [o.E(4.5, 1400.0, T2), o.S(1),
                                       o.T(150, 0), o.E(4.5, 1400.0, T2),
                                       o.S(1), "ADC"] * n)


def test_expression_algebra(port_f64):
    out = []
    for m, _ in BOTH:
        x, y = m.Variable("x"), m.Variable("y")
        e = 2 * x + y ** 2 - 1
        assert np.allclose(_np(e(x=3, y=4)), 2 * 3 + 16 - 1)
        assert {str(v) for v in e.variables} == {"x", "y"}
        e2 = e.map(y=5)
        assert np.allclose(_np(e2(x=1)), 2 + 25 - 1)
        f = m.functions.exp(-x / 10.0)
        g = m.math.power(abs(x - 7.0), 1.5) + m.math.arctan2(x, y)
        assert np.allclose(_np(f(x=10.0)), np.exp(-1.0))
        out.append([_np(e(x=3, y=4)), _np(f(x=10.0)), _np(g(x=2.0, y=3.0))])
    for a, b in zip(*out):
        _close(a, b)


def test_expression_derive(port_f64):
    out = []
    for m, _ in BOTH:
        x, y = m.Variable("x"), m.Variable("y")
        e = x ** 2 * y + 3 * x
        vals = [_np(e.derive("x")(x=2.0, y=5.0)),
                _np(e.derive("y")(x=2.0, y=5.0)),
                _np(e.derive("x").derive("y")(x=2.0, y=5.0)),
                _np(e.derive("z")(x=1.0, y=1.0)),
                _np(m.math.exp(-x * y).derive("x")(
                    x=np.array([0.5, 1.0]), y=2.0))]
        assert np.allclose(vals[:4], [2 * 2 * 5 + 3, 4.0, 4.0, 0.0])
        out.append(vals)
    for a, b in zip(*out):
        _close(a, b)


def test_sequence_signal(port_f64):
    necho = 4
    sig = _cpmg(tseq, necho).signal(T2=35.0)
    assert sig.device.type == "cpu"
    ref = tepg.simulate(
        [tepg.T(90, 90)] + [tepg.E(4.5, 1400.0, 35.0), tepg.S(1),
                            tepg.T(150, 0), tepg.E(4.5, 1400.0, 35.0),
                            tepg.S(1), tepg.ADC] * necho)
    assert {str(v) for v in _cpmg(tseq, 1).variables} == {"T2"}
    assert np.abs(sig.numpy() - np.moveaxis(ref, 0, -1)).max() < 1e-12
    _close(sig, _cpmg(jseq, necho).signal(T2=35.0))


def test_sequence_jacobian_fd(port_f64):
    seq = _cpmg(tseq, 3)
    sig, jac = seq.jacobian(["T2"])(T2=35.0)
    eps = 1e-4
    fd = (seq.signal(T2=35.0 + eps) - seq.signal(T2=35.0 - eps)) / (2 * eps)
    assert (jac[..., 0] - fd).abs().max() < 1e-7
    jsig, jjac = _cpmg(jseq, 3).jacobian(["T2"])(T2=35.0)
    _close(sig, jsig)
    _close(jac, jjac)


def _chain(m):
    R2 = m.Variable("R2")
    o = m.operators
    return m.Sequence([o.T(90, 90)] + [
        o.E(4.5, 1400.0, 1.0 / R2), o.S(1), o.T(150, 0),
        o.E(4.5, 1400.0, 1.0 / R2), o.S(1), "ADC"] * 3)


def test_sequence_expression_chain_rule(port_f64):
    seq = _chain(tseq)
    r2 = 1.0 / 35.0
    sig, jac = seq.jacobian(["R2"])(R2=r2)
    eps = 1e-7
    fd = (seq.signal(R2=r2 + eps) - seq.signal(R2=r2 - eps)) / (2 * eps)
    assert (jac[..., 0] - fd).abs().max() < 1e-4 * max(1, fd.abs().max())
    _close(jac, _chain(jseq).jacobian(["R2"])(R2=r2)[1])


def _t2b1(m, n=2):
    T2, B1 = m.Variable("T2"), m.Variable("B1")
    o = m.operators
    return m.Sequence([o.T(90, 90)] + [
        o.E(4.5, 1400.0, T2), o.S(1), o.T(150 * B1, 0),
        o.E(4.5, 1400.0, T2), o.S(1), "ADC"] * n)


def test_sequence_hessian_shapes(port_f64):
    sig, jac, hes = _t2b1(tseq).hessian(["T2", "B1"])(T2=35.0, B1=0.9)
    assert jac.shape[-1] == 2
    assert hes.shape[-2:] == (2, 2)
    assert (hes[..., 0, 1] - hes[..., 1, 0]).abs().max() < 1e-10
    want = _t2b1(jseq).hessian(["T2", "B1"])(T2=35.0, B1=0.9)
    for a, b in zip((sig, jac, hes), want):
        _close(a, b)


def test_sequence_crlb(port_f64):
    seq = _cpmg(tseq, 5)
    crb = seq.crlb(["T2"])(T2=35.0)
    assert bool(torch_isfinite(crb))
    seq2 = tseq.Sequence(seq.operators[:1 + 6 * 2])
    assert float(crb) < float(seq2.crlb(["T2"])(T2=35.0))
    _close(crb, _cpmg(jseq, 5).crlb(["T2"])(T2=35.0), 1e-10 * float(crb))


def torch_isfinite(x):
    return np.isfinite(_np(x)).all()


def _mrf_block(m):
    alpha = m.Variable("alpha")
    o = m.operators
    return [o.T(alpha, 90), o.E(5.0, 1000.0, 80.0), "ADC", o.S(1)]


def test_repeat_mrf_builder(port_f64):
    out = []
    for m, _ in BOTH:
        block = _mrf_block(m)
        sig = m.Sequence(m.repeat(block, alpha=[20.0, 40.0, 60.0])).signal()()
        assert sig.shape[-1] == 3
        seq2 = m.Sequence(m.repeat(block, nrep=3, alpha="fa{:02d}"))
        assert {str(v) for v in seq2.variables} == {"fa01", "fa02", "fa03"}
        sig2, jac2 = seq2.jacobian(["fa01", "fa02", "fa03"])(
            fa01=20.0, fa02=40.0, fa03=60.0)
        assert np.abs(_np(sig2) - _np(sig)).max() < 1e-12
        assert jac2.shape[-1] == 3
        out.append((sig, jac2))
    _close(out[0][0], out[1][0])
    _close(out[0][1], out[1][1])


def test_string_variable_args(port_f64):
    out = []
    for m, _ in BOTH:
        o = m.operators
        seq = m.Sequence([o.T("alpha", 90), o.E(10.0, "T1", 80.0), "ADC"])
        assert {str(v) for v in seq.variables} == {"alpha", "T1"}
        sig = seq.signal()(alpha=90.0, T1=1000.0)
        ref = m.Sequence([o.T(m.Variable("alpha"), 90),
                          o.E(10.0, m.Variable("T1"), 80.0), "ADC"]
                         ).signal()(alpha=90.0, T1=1000.0)
        assert np.abs(_np(sig) - _np(ref)).max() == 0
        out.append(sig)
    _close(*out)


def test_sequence_adc_times(port_f64):
    out = []
    for m, _ in BOTH:
        o = m.operators
        seq = m.Sequence([o.T(90, 90), o.Wait(5.0), "ADC", o.Wait(3.0),
                          "ADC"])
        times = np.asarray(seq.adc_times(), dtype=float)
        assert np.allclose(times, [5.0, 8.0])
        out.append(times)
    _close(*out)


def _obs(seed, truth):
    rng = np.random.default_rng(seed)
    return _np(truth) + 1e-3 * rng.normal(size=truth.shape)


def test_confint(port_f64):
    out = []
    truth = _cpmg(jseq, 6).signal(T2=35.0)
    obs = _obs(0, truth)
    for m, _ in BOTH:
        cints = m.Sequence(_cpmg(m, 6)).confint(obs, ["T2"])(T2=35.0)
        assert cints.shape[-1] == 1
        assert np.isfinite(_np(cints)).all()
        out.append(cints)
    _close(out[0], out[1], 1e-10 * float(np.abs(_np(out[1])).max()))


def test_sequence_pickling(port_f64):
    """DSL objects pickle; the port's function nodes (``math.sqrt``) too:
    they hold the function's name."""
    out = []
    for m, _ in BOTH:
        T2 = m.Variable("T2")
        o = m.operators
        seq = m.Sequence([o.T(90, 90), o.E(5, 1000, T2 + 1.0), o.S(1),
                          "ADC"])
        seq2 = pickle.loads(pickle.dumps(seq))
        a, b = seq.signal(T2=49.0), seq2.signal(T2=49.0)
        assert np.abs(_np(a) - _np(b)).max() < 1e-12
        out.append(b)
    _close(*out)
    T2 = tseq.Variable("T2")
    seq = tseq.Sequence([tseq.T(90, 90), tseq.E(5, 1000, tseq.math.sqrt(
        T2 * T2) + 1.0), tseq.operators.S(1), "ADC"])
    _close(pickle.loads(pickle.dumps(seq)).signal(T2=49.0), out[0])


def _crlb_train(m, a1, a2):
    T2 = m.Variable("T2")
    o = m.operators
    return m.Sequence([o.T(90, 90)] + [
        o.E(5.0, 1000.0, T2), o.S(1), o.T(a1, 0),
        o.E(5.0, 1000.0, T2), o.S(1), "ADC",
        o.E(5.0, 1000.0, T2), o.S(1), o.T(a2, 0),
        o.E(5.0, 1000.0, T2), o.S(1), "ADC"])


def test_sequence_crlb_gradient_fd(port_f64):
    """crlb(variables, gradient=params): the analytic CRLB gradient
    matches finite differences of the CRLB value and JAX's."""
    seq = _crlb_train(tseq, tseq.Variable("a1"), tseq.Variable("a2"))
    vals = {"T2": 45.0, "a1": 120.0, "a2": 100.0}
    crb, grad = seq.crlb(["T2"], gradient=["a1", "a2"])(**vals)
    crb0 = seq.crlb(["T2"])(**vals)
    assert np.allclose(_np(crb), _np(crb0))
    eps = 1e-3
    for j, name in enumerate(("a1", "a2")):
        up = dict(vals)
        up[name] += eps
        dn = dict(vals)
        dn[name] -= eps
        fd = (_np(seq.crlb(["T2"])(**up))
              - _np(seq.crlb(["T2"])(**dn))) / (2 * eps)
        assert np.allclose(_np(grad)[..., j], fd, rtol=1e-4), name
    jcrb, jgrad = _crlb_train(jseq, jseq.Variable("a1"), jseq.Variable(
        "a2")).crlb(["T2"], gradient=["a1", "a2"])(**vals)
    _close(crb, jcrb, 1e-10 * float(np.abs(_np(jcrb)).max()))
    _close(grad, jgrad, 1e-10 * float(np.abs(_np(jgrad)).max()))


def test_confint_cband(port_f64):
    out = []
    truth = _cpmg(jseq, 6).signal(T2=35.0)
    obs = _obs(1, truth)
    for m, _ in BOTH:
        cints, cband = _cpmg(m, 6).confint(obs, ["T2"], return_cband=True)(
            T2=35.0)
        assert np.isfinite(_np(cints)).all()
        assert cband.shape[-1] == truth.shape[-1]
        assert np.all(_np(cband) >= 0)
        out.append((cints, cband))
    for a, b in zip(*out):
        _close(a, b, 1e-10 * float(np.abs(_np(b)).max()))


def test_dsl_null_operator(port_f64):
    out = []
    for m, _ in BOTH:
        o = m.operators
        s = m.Sequence([o.T(90, 90), o.Null(), o.ADC])
        s2 = m.Sequence([o.T(90, 90), o.ADC])
        assert np.allclose(_np(s.signal()()), _np(s2.signal()()))
        out.append(s.signal()())
    _close(*out)


def test_confint_observed_information_sign(port_f64):
    """The port's stats.confint on a model with an analytic Jacobian and
    Hessian: the observed information J^H J - Re(conj(H) res) gives the
    finite-difference covariance, and JAX's intervals."""
    import torch

    from epgpy_torch import stats as tstats
    from epgpy_tpu import stats as jstats

    t = np.linspace(0.1, 3.0, 12)
    theta0 = np.asarray([1.3, 0.7])

    def pred(th):
        return th[0] * np.exp(-t * th[1])

    rng = np.random.default_rng(3)
    obs = pred(theta0) + 0.05 * rng.standard_normal(t.size)

    def sse(th):
        r = obs - pred(th)
        return float(np.sum(r * r))

    eps = 1e-5
    H = np.zeros((2, 2))
    for i in range(2):
        for j in range(2):
            pp = theta0.copy(); pp[i] += eps; pp[j] += eps    # noqa: E702
            pm = theta0.copy(); pm[i] += eps; pm[j] -= eps    # noqa: E702
            mp = theta0.copy(); mp[i] -= eps; mp[j] += eps    # noqa: E702
            mm = theta0.copy(); mm[i] -= eps; mm[j] -= eps    # noqa: E702
            H[i, j] = (sse(pp) - sse(pm) - sse(mp) + sse(mm)) / (4 * eps ** 2)
    info_fd = H / 2
    e = np.exp(-t * theta0[1])
    jac = np.stack([e, -theta0[0] * t * e], axis=-1)
    hess = np.zeros((t.size, 2, 2))
    hess[:, 0, 1] = hess[:, 1, 0] = -t * e
    hess[:, 1, 1] = theta0[0] * t * t * e
    cints, _ = tstats.confint(torch.as_tensor(obs),
                              torch.as_tensor(pred(theta0)),
                              torch.as_tensor(jac), torch.as_tensor(hess))
    dof = t.size - 2
    cov_fd = np.linalg.inv(info_fd) * sse(theta0) / dof
    want = tstats.get_tstat_interval(0.95, dof) * np.sqrt(np.diag(cov_fd))
    assert np.abs(_np(cints) - want).max() < 1e-3 * want.max()
    jc, _ = jstats.confint(obs, pred(theta0), jac, hess)
    _close(cints, jc)


def test_repeat_zero_and_negative_setitem(port_f64):
    for m, _ in BOTH:
        v = m.Variable("T2")
        assert m.repeat([m.E(5.0, 1400.0, v), "ADC"], 0) == []
        s = m.Sequence([m.T(90, 90), m.E(5.0, 1400.0, v), "ADC"])
        s[-1] = "SPOILER"
        assert len(s) == 3
        assert s[-1] is m.operators.SPOILER


def test_hessian_cross_pair_order(port_f64):
    out = []
    for m, _ in BOTH:
        T2v, B1v = m.Variable("T2"), m.Variable("B1")
        seq = m.Sequence([m.T(90 * B1v, 90),
                          m.E(5.0, 1400.0, T2v * T2v / 50.0), "ADC"])
        h12 = _np(seq.hessian(["T2"], ["B1"])(T2=50.0, B1=1.0)[2])
        h21 = _np(seq.hessian(["B1"], ["T2"])(T2=50.0, B1=1.0)[2])
        assert np.abs(h12).max() > 0
        assert np.allclose(h12, np.swapaxes(h21, -1, -2), atol=1e-10)
        out.append(h12)
    _close(*out)


def test_setitem_numpy_integer_index(port_f64):
    out = []
    for m, _ in BOTH:
        v = m.Variable("T2")
        s = m.Sequence([m.T(90, 90), m.E(5.0, 1400.0, v), "ADC"])
        s[np.int64(0)] = m.T(45, 0)
        assert len(s) == 3
        sig = s.signal()(T2=50.0)
        assert np.isfinite(_np(sig)).all()
        out.append(sig)
    _close(*out)


# -- routes: the DSL's trains reach the kernel families JAX's reach --

TR, TE = 12.0, 5.0
ALPHAS = [float(a) for a in np.linspace(10.0, 60.0, 6)]


def _dsl_train(m, form):
    o = m.operators
    if form == "5op":
        block = [o.T("alpha", 90), o.E(TE, "T1", "T2"), "ADC",
                 o.E(TR - TE, "T1", "T2"), o.S(1)]
    else:
        block = [o.T("alpha", 90), o.E(TR, "T1", "T2"), "ADC", o.S(1)]
    return m.Sequence(m.repeat(block, alpha=ALPHAS))


@pytest.mark.parametrize("form", ["5op", "4op"])
@pytest.mark.parametrize("t1", ["per_atom", "scalar"])
@pytest.mark.parametrize("how", ["signal", "jacobian", "hessian"])
def test_dsl_dispatch_counts_equal_jax(port_f32, form, t1, how):
    vals = dict(T1=np.array([800.0, 1000.0, 1200.0]) if t1 == "per_atom"
                else 1000.0, T2=np.array([50.0, 60.0, 70.0]))
    opts = {"options": {"fisp_kernel": "force", "max_nstate": 8}}
    counts, outs = [], []
    for (m, _), fd in zip(BOTH, (tfd, jfd)):
        fd.DISPATCH_COUNTS.clear()
        seq = _dsl_train(m, form)
        if how == "signal":
            out = seq.signal(**opts)(**vals)
        elif how == "jacobian":
            out = seq.jacobian(["T1", "T2"], **opts)(**vals)[1]
        else:
            out = seq.hessian(["T1", "T2"], **opts)(**vals)[2]
        counts.append(dict(fd.DISPATCH_COUNTS))
        outs.append(_np(out))
    assert counts[0] == counts[1]
    if how == "signal":
        assert counts[0] == {"fisp" if form == "5op" else "comp": 1}
    else:
        assert counts[0] == {}
    scale = np.abs(outs[1]).max()
    assert np.abs(outs[0] - outs[1]).max() < 1e-5 * max(scale, 1.0)


def test_chunked_pass_replay_path(port_f64, monkeypatch):
    """The card's chunked-program path (the planned diff program of a
    stage, the last chunk padded with zero directions and cut back, one
    captured program replayed per stage) with an eager stand-in for the
    CUDA graph: a flagship-style DSL Hessian in chunks of 3 and a
    Jacobian in chunks of 4 equal the eager passes (jvp through the plain
    eager loop, ``diff.simulate_diff_eager``)."""
    from epgpy_torch import diff

    class EagerGraph:
        def __init__(self, fn, bases):
            self.fn = fn
            diff.GRAPH_COUNTS["captures"] += 1

        def __call__(self, *bases):
            return self.fn(*bases)

    n = 4
    alphas = [f"a{i}" for i in range(n)]
    taus = [f"t{i}" for i in range(n)]
    o = tseq.operators
    seq = tseq.Sequence(tseq.repeat([o.T("alpha", 90),
                                     o.E("TR", "T1", "T2"), o.ADC,
                                     o.S(1)], alpha=alphas, TR=taus))
    vals = {**dict(zip(alphas, [20.0, 35.0, 50.0, 40.0])),
            **dict(zip(taus, [11.0, 12.5, 14.0, 13.0]))}
    f = seq.hessian(["magnitude", "T1", "T2"], alphas + taus,
                    options={"max_nstate": 6, "jacobian_chunk": 3})
    g = seq.jacobian(["T1"] + alphas + taus,
                     options={"max_nstate": 6, "jacobian_chunk": 4})
    T1 = np.array([900.0, 1300.0])
    with monkeypatch.context() as m:
        m.setattr(diff, "simulate_diff", diff.simulate_diff_eager)
        want = f(vals, T1=T1, T2=80.0) + g(vals, T1=T1, T2=80.0)
    monkeypatch.setattr(diff, "_graph_passes", lambda: True)
    monkeypatch.setattr(diff, "_PassGraph", EagerGraph)
    before = diff.GRAPH_COUNTS["captures"]
    got = f(vals, T1=T1, T2=80.0)
    # the Hessian blocks push every Jacobian column the outputs read: no
    # Jacobian stage, one capture
    assert diff.GRAPH_COUNTS["captures"] - before == 1
    got += g(vals, T1=T1, T2=80.0)
    assert diff.GRAPH_COUNTS["captures"] - before == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max() < 1e-12
