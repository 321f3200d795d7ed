"""epgpy_torch.models.mrf vs the goldens, the JAX model and the bench probe.

Tolerances: float64 vs the reference golden <= 1e-10 (the JAX budget,
docs/DESIGN.md:105); float64 vs the JAX float64 model <= 1e-11 (same
recurrence, different operation order); the benchmark's f64 reference
probe (bench_baseline.json, first 8 atoms of the 102,400-atom grid over
1000 pulses): <= 1e-10 in float64 and <= 1e-6 for the float32 plain twin
of the CUDA kernel (the H100 parity bar).
"""

import json
import os

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from epgpy_torch.models import cuda_fisp, mrf as tmrf
from epgpy_tpu.models import mrf as jmrf

from torch_support import GOLDEN_DIR, cplx, port_f32, port_f64  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fisp_dictionary_golden(port_f64):
    g = np.load(os.path.join(GOLDEN_DIR, "fisp_mrf.npz"))
    re, im = tmrf.fisp_mrf_dictionary(g["FAs"], 12.0, 5.0, g["T1s"],
                                      g["T2s"], nstate=10, phi=90.0)
    assert re.dtype == torch.float64
    assert np.abs(cplx(re, im).T - g["signal"]).max() < 1e-10


def test_fisp_signal_golden(port_f64):
    g = np.load(os.path.join(GOLDEN_DIR, "fisp_mrf.npz"))
    for b in range(g["signal"].shape[1]):
        re, im = tmrf.fisp_mrf_signal(g["FAs"], 90.0, 12.0, 5.0,
                                      g["T1s"][b], g["T2s"][b], nstate=10)
        assert np.abs(cplx(re, im) - g["signal"][:, b]).max() < 1e-10


@pytest.mark.parametrize("kw", [
    dict(B1s=[0.8, 1.0, 1.2]),
    dict(inversion=20.0, B1s=[0.9, 1.0, 1.1]),
    dict(demodulate=True, phi=np.linspace(0, 170, 24)),
    dict(dfs=[-0.03, 0.0, 0.04], inversion=15.0, B1s=[0.85, 1.0, 1.05]),
    dict(normalize=True, TE=np.linspace(2.0, 5.0, 24)),
], ids=["b1", "inversion", "demod", "df_inversion", "normalize_var_te"])
def test_fisp_dictionary_matches_jax(port_f64, kw):
    FA = 10 + 40 * np.abs(np.sin(np.arange(24) / 3.0))
    TR = np.linspace(11.0, 15.0, 24)
    kw = dict(kw)
    TE = kw.pop("TE", 5.0)
    T1s, T2s = np.asarray([400.0, 900.0, 1500.0]), [40.0, 70.0, 110.0]
    want = cplx(*jmrf.fisp_mrf_dictionary(FA, TR, TE, T1s, T2s, nstate=8,
                                          **kw))
    got = cplx(*tmrf.fisp_mrf_dictionary(FA, TR, TE, T1s, T2s, nstate=8,
                                         **kw))
    assert np.abs(got - want).max() < 1e-11
    js = cplx(*jmrf.fisp_mrf_signal(FA, 90.0, TR, TE, 900.0, 70.0, 0.9,
                                    nstate=8, inversion=20.0,
                                    demodulate=True))
    ts = cplx(*tmrf.fisp_mrf_signal(FA, 90.0, TR, TE, 900.0, 70.0, 0.9,
                                    nstate=8, inversion=20.0,
                                    demodulate=True))
    assert np.abs(js - ts).max() < 1e-11


def _bench_probe():
    with open(os.path.join(ROOT, "bench_baseline.json")) as fh:
        base = json.load(fh)
    ref8 = (np.asarray(base["probe_re"]) + 1j * np.asarray(base["probe_im"]))
    FA = bench.make_train(1000)
    T1, T2, B1 = (x[:8] for x in bench.make_atoms(102400))
    return FA, T1, T2, B1, ref8.T                               # (8, P)


def test_bench_probe_f64(port_f64):
    FA, T1, T2, B1, ref8 = _bench_probe()
    got = cplx(*tmrf.fisp_mrf_dictionary(FA, 12.0, 5.0, T1, T2, B1,
                                         nstate=10))
    assert np.abs(got - ref8).max() < 1e-10


def test_bench_probe_f32_plain_twin(port_f32):
    FA, T1, T2, B1, ref8 = _bench_probe()
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    got = cplx(*cuda_fisp.fisp_dictionary_cuda(
        t(FA), 90.0, 12.0, 5.0, t(T1), t(T2), t(B1), nstate=10))
    assert got.dtype == np.complex64
    assert np.abs(got - ref8).max() < 1e-6


def test_smoke_workload_is_the_bench_workload():
    """chip_smoke.py re-implements the benchmark's train and atom grid
    (it must not import the JAX side): they agree exactly."""
    assert np.array_equal(chip_smoke.make_train(1000), bench.make_train(1000))
    for a, b in zip(chip_smoke.make_atoms(102400), bench.make_atoms(102400)):
        assert np.array_equal(a, b)
    assert (chip_smoke.TR, chip_smoke.TE) == (bench.TR, bench.TE)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_dictionary_files_cross_load(port_f64, tmp_path, writer):
    """A dictionary saved by one package loads in the other."""
    rng = np.random.default_rng(7)
    re, im = rng.normal(size=(2, 5, 12))
    T1s, T2s = rng.uniform(200, 2000, 5), rng.uniform(20, 200, 5)
    path = str(tmp_path / "dict.npz")
    save, load = ((tmrf.save_dictionary, jmrf.load_dictionary)
                  if writer == "torch" else
                  (jmrf.save_dictionary, tmrf.load_dictionary))
    tre = torch.as_tensor(re) if writer == "torch" else re
    save(path, tre, im, T1s, T2s, TR=12.0, FA=np.arange(12.0))
    d = load(path)
    assert sorted(d) == ["B1s", "FA", "T1s", "T2s", "TR", "im", "re"]
    assert np.array_equal(d["re"], re) and np.array_equal(d["im"], im)
    assert np.array_equal(d["T1s"], T1s) and np.array_equal(d["B1s"],
                                                            np.ones(5))
    assert float(d["TR"]) == 12.0
