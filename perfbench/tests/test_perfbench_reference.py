"""Each reference against the port's plain twins at a small size, in
float64 on the CPU (the test may import the port; the references may
not)."""

import copy

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import mrf_bssfp, mrf_fisp, serving


@pytest.fixture
def f64():
    import epgpy_torch as epg

    epg.config.set_device("cpu")
    epg.config.set_precision("float64")
    yield epg
    epg.config.set_precision("float32")
    epg.config.set_device("cuda")


def _cfg(bench, name, npulse):
    cfg = copy.deepcopy(harness.load_cell(
        bench, f"{name}.dict")["config"])
    cfg["train"]["npulse"] = npulse
    return cfg


def test_fisp_reference_matches_port(bench, f64):
    from epgpy_torch.models import cuda_fisp
    from epgpy_torch.models.mrf import fisp_mrf_dictionary

    cfg = _cfg(bench, "mrf_fisp", 80)
    p = torch.tensor(mrf_fisp.grid(cfg)[::9973][:64])
    want = mrf_fisp.fingerprints(cfg, p)
    tr = mrf_fisp.train(cfg)
    re, im = fisp_mrf_dictionary(tr["FA"], tr["TR"], tr["TE"], p[:, 0],
                                 p[:, 1], p[:, 2], nstate=tr["nstate"])
    assert (torch.complex(re, im) - want).abs().max() < 1e-12
    re, im = cuda_fisp.fisp_dictionary_plain(
        torch.tensor(tr["FA"]), torch.tensor(tr["phase_deg"]),
        torch.tensor(tr["TR"]), tr["TE"], p[:, 0], p[:, 1], p[:, 2],
        nstate=tr["nstate"], normalize=True)
    assert (torch.complex(re, im)
            - mrf_fisp.fingerprints(cfg, p, normalize=True)).abs().max() \
        < 1e-12


def test_bssfp_reference_matches_port(bench, f64):
    from epgpy_torch.models import cuda_bssfp

    epg = f64
    cfg = _cfg(bench, "mrf_bssfp", 150)
    g = mrf_bssfp.grid(cfg)[::9973][:64]
    p = torch.tensor(g)
    want = mrf_bssfp.fingerprints(cfg, p)
    tr = mrf_bssfp.train(cfg)
    t = torch.tensor
    re, im = cuda_bssfp.bssfp_dictionary_plain(
        t(tr["FA"]), t(tr["phase"]), t(tr["TR"]), t(tr["TE"]), p[:, 0],
        p[:, 1], torch.ones(len(p), dtype=torch.float64), p[:, 2],
        demodulate=True, inversion=tr["TI"])
    assert (torch.complex(re, im) - want).abs().max() < 1e-12
    # and the operator train a user writes, on the general path
    seq = [epg.T(180, 0), epg.E(tr["TI"], g[:, 0], g[:, 1], g[:, 2])]
    for i in range(len(tr["FA"])):
        seq += [epg.T(float(tr["FA"][i]), float(tr["phase"][i])),
                epg.E(tr["TE"][i], g[:, 0], g[:, 1], g[:, 2]),
                epg.Adc(phase=-float(tr["phase"][i])),
                epg.E(tr["TR"][i] - tr["TE"][i], g[:, 0], g[:, 1], g[:, 2])]
    sig = epg.simulate(seq, fisp_kernel=False)
    assert np.abs(sig.T - want.numpy()).max() < 1e-12


def test_reference_lower_precision_is_lower(bench):
    cfg = _cfg(bench, "mrf_fisp", 200)
    p = torch.tensor(mrf_fisp.grid(cfg)[::99991][:16])
    want = mrf_fisp.fingerprints(cfg, p, normalize=True)
    e32 = (mrf_fisp.fingerprints(cfg, p, dtype=torch.float32,
                                 normalize=True) - want).abs().max()
    e16 = (mrf_fisp.fingerprints(cfg, p, dtype=torch.bfloat16,
                                 normalize=True) - want).abs().max()
    assert e32 < 1e-6 < 1e-3 < e16


def test_fd_jacobian_matches_port(bench, f64):
    """The serving reference's central-difference Jacobian against the
    port's forward-mode Jacobian twin."""
    from epgpy_torch.models import cuda_fisp

    cfg = _cfg(bench, "mrf_fisp", 60)
    theta = torch.tensor([[800.0, 60.0, 0.9], [1500.0, 120.0, 1.1]],
                         dtype=torch.float64)
    s, J = serving.model_and_jacobian(mrf_fisp, cfg, theta, 1e-4)
    tr = mrf_fisp.train(cfg)
    (re, im), (jre, jim) = cuda_fisp.fisp_jacobian_plain(
        torch.tensor(tr["FA"]), torch.tensor(tr["phase_deg"]),
        torch.tensor(tr["TR"]), tr["TE"], theta[:, 0], theta[:, 1],
        theta[:, 2], nstate=tr["nstate"])
    assert (s - torch.complex(re, im)).abs().max() < 1e-12
    scale = J.abs().amax(dim=(0, 1))
    err = (J - torch.complex(jre, jim)).abs().amax(dim=(0, 1)) / scale
    assert float(err.max()) < 1e-6


def test_gn_reference_matches_port(bench, f64):
    """The reference Gauss-Newton against the port's gauss_newton_refine
    in float64 from the same start, on the same noisy signals."""
    from epgpy_torch.models import cuda_fisp
    from epgpy_torch.parallel import gauss_newton_refine

    cfg = _cfg(bench, "mrf_fisp", 60)
    tr = mrf_fisp.train(cfg)
    rng = np.random.default_rng(3)
    truth = torch.tensor([[900.0, 70.0, 0.95], [1400.0, 40.0, 1.08],
                          [600.0, 150.0, 0.8]], dtype=torch.float64)
    y = mrf_fisp.fingerprints(cfg, truth) * (1.3 - 0.4j)
    y = y + 0.002 * torch.tensor(rng.standard_normal(y.shape)
                                 + 1j * rng.standard_normal(y.shape))
    theta0 = truth * torch.tensor([1.04, 0.95, 1.02], dtype=torch.float64)
    kw = dict(iters=5, damping=1e-3,
              bounds=[(100, 4000), (5, 400), (0.5, 1.5)])
    want = serving.refine(mrf_fisp, cfg, theta0, y, fd_step=1e-5, **kw)

    def sj(theta):
        th = torch.as_tensor(theta)
        (re, im), (jre, jim) = cuda_fisp.fisp_jacobian_plain(
            torch.tensor(tr["FA"]), torch.tensor(tr["phase_deg"]),
            torch.tensor(tr["TR"]), tr["TE"], th[0], th[1], th[2],
            nstate=tr["nstate"])
        return (re.T, im.T), (jre.transpose(0, 1), jim.transpose(0, 1))

    got = gauss_newton_refine(sj, theta0.T.numpy(), y.real.T.numpy(),
                              y.imag.T.numpy(), solve_scale=True, **kw)
    assert np.abs(got.T - want.numpy()).max() / 1000 < 1e-7
