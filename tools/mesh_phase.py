#!/usr/bin/env python3
"""``chip_smoke.phase_mesh`` alone on the GPU: the single-controller
device mesh (four shards on one card) over the headline dictionary, the
sharded serve of 8,192 voxels, the fused design, the sequence-optimization
example's CRLB steps and the ten atom-sharded kernel wrappers, with the
card's name and power limit.  Builds the kernel library first.

    python3 tools/mesh_phase.py          # on the GPU machine
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
    mesh = chip_smoke._timed(chip_smoke.phase_mesh, torch, epg, card)
    print(f"[numbers] {mesh}")
    print(f"[time] total {time.perf_counter() - t0:.1f} s")
    print(card)


if __name__ == "__main__":
    main()
