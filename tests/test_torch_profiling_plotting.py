"""Traces and EPG diagrams of epgpy_torch (``utils/profiling.py``,
``utils/plotting.py``): ``trace`` writes a Chrome trace and ``annotate``
names a region in it; ``plot_epg`` renders headless under Agg, as
tests/test_utils.py does for the JAX package, and draws the same k-state
trajectory as JAX's.
"""

import glob
import json

import numpy as np
import pytest

import epgpy_torch as tepg
import epgpy_tpu as jepg
from epgpy_torch.utils import profiling

from torch_support import port_f64  # noqa: F401


def test_trace_writes_a_chrome_trace(port_f64, tmp_path):
    seq = [tepg.T(90, 90)] + [tepg.S(1), tepg.T(150, 0), tepg.S(1),
                              tepg.ADC] * 4
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("epg-region"):
            sig = tepg.simulate(seq)
    assert sig.shape == (4, 1)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "epg-region" in names
    assert any(e.key == "epg-region" for e in prof.key_averages())


def _cpmg(e):
    return [e.T(90, 90)] + [e.S(1, duration=2), e.T(150, 0),
                            e.S(1, duration=2), e.ADC] * 3


def _lines(fig):
    """Every drawn line of every axis: (x, y, alpha, width, color)."""
    from matplotlib.colors import to_rgba

    out = []
    for ax in fig.axes:
        for ln in ax.get_lines():
            out.append((np.asarray(ln.get_xdata(), float),
                        np.asarray(ln.get_ydata(), float),
                        ln.get_alpha(), ln.get_linewidth(),
                        to_rgba(ln.get_color()), ln.get_linestyle()))
    return out


def _same_drawing(a, b):
    """The same set of lines: a 2-D table's rows may come in another order
    (the merge engines order cells differently), which changes only the
    order the lines are drawn in."""
    def key(line):
        return (tuple(np.round(line[0], 9)), tuple(np.round(line[1], 9)),
                round(line[2] or 0.0, 9), line[3:])

    la, lb = sorted(_lines(a), key=key), sorted(_lines(b), key=key)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert np.allclose(x[0], y[0]) and np.allclose(x[1], y[1])
        assert (x[2] is None) == (y[2] is None)
        if x[2] is not None:
            assert abs(x[2] - y[2]) <= 1e-9
        assert x[3:] == y[3:]


def test_plot_epg_headless(port_f64, tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from epgpy_torch.utils.plotting import plot_epg

    fig = plot_epg(_cpmg(tepg), title="CPMG")
    out = tmp_path / "epg.png"
    fig.savefig(out)
    assert out.stat().st_size > 1000


@pytest.mark.parametrize("train", ["cpmg", "gre_2d"])
def test_plot_epg_matches_jax(port_f64, train):
    """The same lines (k-paths, stored-Z dots, RF stems, ADC marks) with
    the same alphas and colors as JAX's diagram: on the 1-D CPMG train and
    on a 2-D shift train whose off-axis k is color coded."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    from epgpy_torch.utils.plotting import plot_epg
    from epgpy_tpu.utils.plotting import plot_epg as jplot_epg

    def seq(e):
        if train == "cpmg":
            return _cpmg(e)
        return [e.T(90, 90), e.S([1.0, 0.5], duration=2), e.T(60, 0),
                e.S([0.5, -1.0], duration=2), e.T(40, 90), e.ADC,
                e.S([1.0, 1.0], duration=2), e.ADC]

    kw = dict(kgrid=None if train == "cpmg" else 0.5)
    got = plot_epg(seq(tepg), figname="port", **kw)
    want = jplot_epg(seq(jepg), figname="jax", **kw)
    try:
        _same_drawing(got, want)
    finally:
        plt.close(got)
        plt.close(want)


def test_k_colors_maps():
    """Off-axis k colormaps equal JAX's."""
    pytest.importorskip("matplotlib")
    from epgpy_torch.utils.plotting import k_colors_1d, k_colors_2d
    from epgpy_tpu.utils import plotting as jp

    v = np.linspace(-3, 3, 7)
    assert np.array_equal(k_colors_1d(v, 2.0), jp.k_colors_1d(v, 2.0))
    x, y = np.meshgrid(np.linspace(-1, 1, 5), np.linspace(-1, 1, 5))
    assert np.array_equal(k_colors_2d(x, y, 1.0, 1.0),
                          jp.k_colors_2d(x, y, 1.0, 1.0))
