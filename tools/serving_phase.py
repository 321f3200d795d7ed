#!/usr/bin/env python3
"""``chip_smoke.phase_mwf`` and ``phase_streamed_serving`` alone on the GPU:
EPG-NNLS myelin-water mapping (examples/mwf_mapping.py's scenario at its
widths over 262,144 voxels: the basis on the CPMG kernel, the batched
FISTA fit, float32 against float64) and dictionary-free serving of a
2^20-atom MRF dictionary (tools/million_atom_serving.py's scenario at its
defaults: the streamed rank-32 compression over fisp_half blocks, the
atom-chunked match, the materialized dictionary's match), with the card's
name and power limit.  Builds the kernel library first.

    python3 tools/serving_phase.py          # on the GPU machine
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
    chip_smoke._timed(chip_smoke.phase_build)
    mwf = chip_smoke._timed(chip_smoke.phase_mwf, torch, epg, card)
    srv = chip_smoke._timed(chip_smoke.phase_streamed_serving, torch, epg,
                            card)
    print(f"[numbers] {mwf}")
    print(f"[numbers] {srv}")
    print(f"[time] total {time.perf_counter() - t0:.1f} s")
    print(card)


if __name__ == "__main__":
    main()
