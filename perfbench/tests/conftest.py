"""Fixtures of the benchmark's own tests (``python -m pytest
perfbench/tests``): the cells' parts at a size the CPU holds, and the
port on the CPU with its plain twins counted as the kernels would be."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

#: the traffic's sizes cut for the CPU: a few pulses, a 6 x 6 x 3 grid
#: (jitter cut with it, so that jittered atoms stay physical), a small
#: pool and batch, every voxel of a batch sampled, two warm-up calls
SMALL_TRAFFIC = dict(jitter_steps=0.05, batch_voxels=16, pool_voxels=64,
                     atom_chunk=40, sample_voxels_per_batch=16,
                     sample_atoms_per_call=8, reference_block_atoms=50,
                     warmup_gn_calls=2)


def small(parts, npulse=24, points=(6, 6, 3)):
    p = dict(parts)
    cfg = copy.deepcopy(p["config"])
    cfg["train"]["npulse"] = npulse
    for a, n in zip(cfg["grid"]["axes"], points):
        cfg["grid"][a][2] = n
    p["config"] = cfg
    p["traffic"] = {k: SMALL_TRAFFIC.get(k, v)
                    for k, v in p["traffic"].items()}
    return p


@pytest.fixture(scope="session")
def bench():
    return harness.load_benchmark()


@pytest.fixture
def cpu_port(monkeypatch):
    """The port on the CPU: its plain twins stand in for the kernels and
    count as their launches would; simulate() takes the kernel families'
    route (``fisp_kernel="force"``), which on the CPU runs their twins."""
    import epgpy_torch as epg
    from epgpy_torch.models import cuda_bssfp, cuda_fisp, mrf

    def counted(module, counter, fn):
        def wrapped(*a, **k):
            setattr(module, counter, getattr(module, counter) + 1)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mrf, "fisp_full_ladder_plain", counted(
        cuda_fisp, "LAUNCHES", mrf.fisp_full_ladder_plain))
    monkeypatch.setattr(cuda_bssfp, "bssfp_echoes_plain", counted(
        cuda_bssfp, "LAUNCHES", cuda_bssfp.bssfp_echoes_plain))
    monkeypatch.setattr(cuda_fisp, "fisp_jacobian_echoes_plain", counted(
        cuda_fisp, "JAC_LAUNCHES", cuda_fisp.fisp_jacobian_echoes_plain))
    simulate = epg.simulate

    def forced(*a, **k):
        k.setdefault("fisp_kernel", "force")
        return simulate(*a, **k)

    monkeypatch.setattr(epg, "simulate", forced)
    yield epg
    epg.config.set_device("cuda")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def run_small(parts, *, seed=2**33 + 7, seconds=0.5, trace=False,
              device="cpu", **kw):
    import time
    return harness.run_cell(parts, seed=seed, seconds=seconds, trace=trace,
                            device=device, t_start=time.perf_counter(), **kw)
