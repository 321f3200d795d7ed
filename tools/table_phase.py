#!/usr/bin/env python3
"""``chip_smoke.phase_table`` alone on the GPU: the coordinate-table
trains of the bench at bench and full width (planned against eager,
float32 against float64, the dense engine against the table engine), with
the card's name and power limit.  The table path launches no kernel, so
nothing is built.

    python3 tools/table_phase.py         # on the GPU machine, ~35 s
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main():
    t0 = time.perf_counter()
    card = chip_smoke.phase_environment(torch)
    import epgpy_torch as epg

    epg.config.set_device("cuda")
    epg.config.set_precision("float32")
    chip_smoke._timed(chip_smoke.phase_table, torch, epg, card)
    print(f"[time] total {time.perf_counter() - t0:.1f} s")
    print(card)


if __name__ == "__main__":
    main()
