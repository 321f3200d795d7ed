"""Time the segmented tangent kernels of several checkouts on one card.

    python3 tools/jac_kernel_ab.py ROOT [ROOT ...] [--reps N]

Runs one turn per checkout -- each ROOT, then this checkout -- and then
the same turns in reverse order (A, B, B, A for one ROOT), each turn in
its own process, which imports that checkout's ``epgpy_torch``
(building its CUDA kernels from that checkout's sources) and its
``chip_smoke.py`` input makers, and times by CUDA events (best of `reps`
after one warm-up, ``chip_smoke._cuda_ms``) at the main-path shapes:

* ``fisp_jac``: the FISP headline train, 102,400 atoms x 1000 pulses,
  nstate 10 (``chip_smoke.make_train`` / ``make_atoms``);
* ``fisp_jac`` with the dD group: the same train with DW-FISP's
  attenuation (``chip_smoke.DWF_KVALUE``'s b-value bases, D 1e-3);
* ``megre_jac``: 262,144 atoms x 200 TRs x 3 echoes, nstate 8
  (``chip_smoke.make_megre_case``);
* ``fisp_hess``: the flagship per-pulse Hessian, 256 atoms x 400 pulses,
  nstate 10, second order (``chip_smoke.flagship_train`` /
  ``design_atoms``);
* ``composite_jac``: the MPRAGE Jacobian of ``chip_smoke.py`` 4o, 102,400
  atoms x 156 stages, nstate 8, all four groups (``comp_jac_draws`` /
  ``comp_jac_sequence`` through ``fisp_dispatch.match_composite``).

Each turn prints one JSON line with its times and the kernels' ptxas lines
(registers, stack frame) where it built them; the last lines give the
card's name and power limit and the mean of each checkout's two turns.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"fisp": (102400, 1000), "megre": (262144, 200)}


def turn(root, reps):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import epgpy_torch as epg
    from epgpy_torch import _build, fisp_dispatch
    from epgpy_torch.models import (cuda_composite, cuda_fisp, cuda_hessian,
                                    cuda_megre)

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = "cuda"
    epg.config.set_device(dev)
    epg.config.set_precision("float32")
    natoms, npulse = SHAPES["fisp"]
    P = npulse
    FA = cs.make_train(P)
    T1, T2, B1 = cs.make_atoms(natoms)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    fargs = (t(FA), t(np.full(P, 90.0)), t(np.full(P, cs.TR)), cs.TE,
             t(T1), t(T2), t(B1), None)
    # the DW-FISP attenuation of the chip_smoke train: b-value bases
    # k^2 tau (k in rad/mm, tau in s), D 1e-3 mm^2/s
    b = (cs.DWF_KVALUE * 1e-3) ** 2 * cs.DWF_TAU * 1e-3
    dkw = dict(diffusion=(b, b, cs.DWF_D), diff_ramp=True,
               track_diffusivity=True)
    margs, mkw = cs._tensors(torch, *cs.make_megre_case(
        dict(m=3, nstate=8), SHAPES["megre"][0], SHAPES["megre"][1]), dev)
    out = {"root": root}
    out["fisp_jac_ms"] = cs._cuda_ms(torch, lambda: cuda_fisp.
                                     fisp_jacobian_echoes(*fargs, nstate=10),
                                     reps)
    out["fisp_jac_dD_ms"] = cs._cuda_ms(
        torch, lambda: cuda_fisp.fisp_jacobian_echoes(*fargs, nstate=10,
                                                      **dkw), reps)
    out["megre_jac_ms"] = cs._cuda_ms(
        torch, lambda: cuda_megre.megre_jacobian_echoes(*margs, **mkw), reps)
    del margs
    hFA, hTAU = cs.flagship_train()
    hT1, hT2 = cs.design_atoms()
    hargs = (t(hFA), 90.0, t(hTAU), t(hT1), t(hT2))
    out["fisp_hess_ms"] = cs._cuda_ms(
        torch, lambda: cuda_hessian.fisp_hessian_cuda(*hargs, nstate=10),
        reps)
    params = fisp_dispatch.match_composite(
        cs.comp_jac_sequence(epg, *cs.comp_jac_draws()), 1.0)
    cargs, ckw = fisp_dispatch._comp_call(params, cs.COMPJ_NSTATE)
    out["composite_jac_ms"] = cs._cuda_ms(
        torch, lambda: cuda_composite.composite_jacobian_echoes(*cargs,
                                                                **ckw), reps)
    log = _build.build_info()["log"].splitlines()
    out["ptxas"] = [f"{a.split('for')[-1].strip()[-48:]}: {b.strip()}; "
                    f"{c.strip()}"
                    for a, b, c in zip(log, log[1:], log[2:])
                    if "Function properties" in a
                    and any(k in a for k in ("fisp_jac", "megre_jac",
                                             "hess_", "composite_jac"))]
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        turn(os.path.abspath(a.roots[0]), a.reps)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    order = [os.path.abspath(r) for r in a.roots] + [HERE]
    runs = {}
    for root in order + order[::-1]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), root,
                            "--turn", "--reps", str(a.reps)],
                           capture_output=True, text=True, cwd=root)
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-3000:])
            raise SystemExit(f"turn in {root} failed")
        line = r.stdout.strip().splitlines()[-1]
        print(line)
        runs.setdefault(root, []).append(json.loads(line))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    for root, rs in runs.items():
        mean = {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]
                if k.endswith("_ms")}
        print(json.dumps({"root": root, "mean_ms": mean, "card": card}))


if __name__ == "__main__":
    main()
