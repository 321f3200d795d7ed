"""The trace reduction on a hand-made timeline: device busy and idle time,
kernel time by name, device time by the span that launched it, and the
idle time split by what the host was doing."""

import pytest
import torch

from perfbench import tracing
from perfbench.metrics import _common

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, corr=0):
        self._v = (name, dev, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _trace():
    ev = [
        Ev("bench.window", CPU, 0, 100),
        Ev("prog.dictionary", CPU, 10, 20),
        Ev("cudaLaunchKernel", CPU, 12, 1, corr=1),
        Ev("cudaLaunchKernel", CPU, 20, 1, corr=2),
        Ev("bench.sample", CPU, 40, 5),
        Ev("cudaLaunchKernel", CPU, 41, 1, corr=3),
        Ev("void fisp_half_kernel<12, 11, false>(FispArgs)", CUDA, 15, 30,
           corr=1),
        Ev("elementwise_kernel<Mul>", CUDA, 45, 10, corr=2),
        Ev("index_kernel", CUDA, 60, 5, corr=3),
        # the device-side mirror of a span is not an operation
        Ev("prog.dictionary", CUDA, 15, 40),
        Ev("bench.wait", CPU, 70, 20),
    ]
    return tracing.Trace(ev, "bench.window")


def test_busy_idle_and_kernels():
    tr = _trace()
    ns = pytest.approx
    assert tr.window_s == ns(100e-9)
    assert tr.busy_s == ns(45e-9)              # [15, 55] and [60, 65]
    assert tr.kernel_time("fisp_half_kernel") == (ns(30e-9), 1)
    assert tr.span_device_time("prog.dictionary") == ns(40e-9)
    assert tr.span_device_time("prog.dictionary",
                               exclude="fisp_half_kernel") == ns(10e-9)
    assert tr.span_device_time("bench.sample") == ns(5e-9)


def test_idle_split_by_host_span():
    b = _trace().breakdown()
    assert b["device_ops"][0][0].startswith("void fisp_half_kernel")
    idle = dict(b["idle_gaps"])
    # gaps [0, 15], [55, 60], [65, 100]
    assert idle == pytest.approx({"host": 30e-9, "prog.dictionary": 5e-9,
                                  "bench.wait": 20e-9})


class _Run:
    def __init__(self, trace):
        self.trace = trace
        self.shapes = {"fisp_half": dict(atoms=1000, pulses=100, nstate=10)}
        self.peaks = {"fp32_flops": 66.9e12, "hbm_bytes_per_s": 3.35e12}

    def counts(self, kernel):
        from perfbench.counts import fisp_half
        return fisp_half


def test_roofline_and_idle_readers():
    from perfbench.counts import fisp_half

    run = _Run(_trace())
    shape = run.shapes["fisp_half"]
    least = max(fisp_half.flops(shape) / 66.9e12,
                fisp_half.nbytes(shape) / 3.35e12)
    assert abs(_common.roofline(run, "fisp_half") / (100 * least / 30e-9)
               - 1) < 1e-12
    assert _common.roofline(run, "fisp_jac") is None
    assert abs(_common.idle_pct(run) - 55.0) < 1e-9
    assert _common.roofline(_Run(None), "fisp_half") is None
