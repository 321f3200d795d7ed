"""A cell on the card, as committed, at its full size with a short window
(``python -m pytest perfbench/tests -m cuda`` on a machine with a card;
skips without one)."""

import pytest
from conftest import run_small

from perfbench import harness


@pytest.mark.cuda
def test_cell_on_the_card(bench, cuda):
    parts = harness.load_cell(bench, "mrf_bssfp.dict")
    out = run_small(parts, device=cuda, seconds=2.0)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
