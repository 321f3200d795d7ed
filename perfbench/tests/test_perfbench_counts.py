"""The closed-form counts, tied to the operations the repository counted
on the plain twins at the main-path shapes (``chip_smoke.count_ops`` /
``linear_ops``: fisp_half 70.55 GFLOP at 102,400 x 1000, nstate 10;
bssfp 5.74 GFLOP at 163,840 x 500; fisp_jac 357.8 GFLOP at 102,400 x
1000), read here as constants.  Those counts cover every ladder row of
every pulse; the closed forms cover the rows the train has reached, a
few tenths of a percent fewer at 1000 pulses."""

import json

import pytest

from perfbench import harness
from perfbench.counts import _ladder, bssfp, fisp_half, fisp_jac

MAIN = dict(atoms=102400, pulses=1000, nstate=10)


@pytest.mark.parametrize("mod, shape, counted", [
    (fisp_half, MAIN, 70.55e9),
    (fisp_jac, MAIN, 357.8e9),
    (bssfp, dict(atoms=163840, pulses=500), 5.74e9),
])
def test_counts_tie_to_the_twins(mod, shape, counted):
    got = mod.flops(shape)
    assert got <= counted * 1.002
    assert got >= counted * 0.99


def test_reached_rows():
    assert _ladder.reached_rows(1, 10) == 1
    assert _ladder.reached_rows(3, 10) == 1 + 2 + 3
    assert _ladder.reached_rows(11, 10) == 66
    assert _ladder.reached_rows(1000, 10) == 66 + 989 * 11
    # every row of every pulse, less the triangle not yet reached
    assert _ladder.reached_rows(1000, 10) == 1000 * 11 - 55


@pytest.mark.parametrize("mod", [fisp_half, fisp_jac, bssfp])
def test_counts_scale_with_atoms(mod):
    a = dict(MAIN, atoms=1)
    assert mod.flops(dict(MAIN, atoms=2**20)) == 2**20 * mod.flops(a)
    assert mod.nbytes(dict(MAIN, atoms=2**20)) > 2 * 1000 * 2**20 * 4


def test_peaks_and_kernel_names():
    peaks = json.loads((harness.HERE / "peaks.json").read_text())
    assert peaks["fp32_flops"] == 66.9e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    for mod, name in ((fisp_half, "fisp_half_kernel"),
                      (fisp_jac, "fisp_jac_kernel"),
                      (bssfp, "bssfp_kernel")):
        assert mod.KERNEL == name
        src = (harness.ROOT / "epgpy_torch" / "csrc" /
               f"{name[:-len('_kernel')]}.cu").read_text()
        assert name + "(" in src
