#!/usr/bin/env python3
"""``chip_smoke.phase_sequence`` and ``phase_slice_profile`` alone on the
GPU: the sequence DSL (the headline train's build, Sequence.signal through
fisp_half and the 4-op train through composite, the (T1, T2) Jacobian on
the general diff path, the flagship DSL Hessian against its
direct-operator form) and the slice-profile dictionaries (the sliced
dictionary at 102,400 atoms x 1000 pulses, its checks, the example's
shaped-pulse oracle), with the card's name and power limit.  Builds the
kernel library first.

    python3 tools/sequence_phase.py [--jac-n N]   # on the GPU machine

``--jac-n`` sets the DSL Jacobian train's depth (default
``chip_smoke.DSL_JAC_N``).
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jac-n", type=int, default=chip_smoke.DSL_JAC_N)
    args = ap.parse_args()
    chip_smoke.DSL_JAC_N = args.jac_n
    t0 = time.perf_counter()
    card = chip_smoke.phase_environment(torch)
    import epgpy_torch as epg

    epg.config.set_device("cuda")
    epg.config.set_precision("float32")
    chip_smoke._timed(chip_smoke.phase_build)
    seq = chip_smoke._timed(chip_smoke.phase_sequence, torch, epg, card)
    sp = chip_smoke._timed(chip_smoke.phase_slice_profile, torch, epg, card)
    print(f"[numbers] {seq}")
    print(f"[numbers] {sp}")
    print(f"[time] total {time.perf_counter() - t0:.1f} s")
    print(card)


if __name__ == "__main__":
    main()
