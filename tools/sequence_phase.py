#!/usr/bin/env python3
"""``chip_smoke.phase_diff_planned``, ``phase_sequence`` and
``phase_slice_profile`` alone on the GPU: the planned diff path against
its eager form on small trains of every op form (captures and replays of
a first and a memoized call), the sequence DSL (the headline train's
build, Sequence.signal through fisp_half and the 4-op train through
composite, the (T1, T2) Jacobian on the planned general diff path with
its eager A/B at a small depth, the flagship DSL Hessian against its
direct-operator form) and the slice-profile dictionaries (the sliced
dictionary at 102,400 atoms x 1000 pulses, its checks, the example's
shaped-pulse oracle), with the card's name and power limit.  Builds the
kernel library first.  Every phase runs; a failed one prints its
traceback and the script exits 1.

    python3 tools/sequence_phase.py   # on the GPU machine
"""

import os
import sys
import time
import traceback

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
    failed = 0
    for phase in (chip_smoke.phase_diff_planned, chip_smoke.phase_sequence,
                  chip_smoke.phase_slice_profile):
        try:
            print(f"[numbers] {chip_smoke._timed(phase, torch, epg, card)}")
        except Exception:
            traceback.print_exc()
            failed += 1
    print(f"[time] total {time.perf_counter() - t0:.1f} s")
    print(card)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
