"""The precision control of the checks that decide ``correct``, and the
readings its limits are set from.

    python perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--program] [--control]

In one process, for each seed: with ``--program``, a short window of the
program and its check (the lower readings); with ``--control``, the same
window with the plain reference put in the program's place, computed in
the precision below the configuration's (the upper readings).  The
configurations state float32; the precision below is the traffic kind's
``CONTROL``: for dictionaries, which run no matrix product, bfloat16
arithmetic; for serving, whose float32 products the program runs with
TF32 off, float32 arithmetic with TF32 products (inputs rounded to TF32,
accumulated in float32, as the card's TF32 mode computes).  Prints one
JSON line per run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


class ReferenceSystem:
    """The reference in the program's place, in lower precision: its
    arithmetic (fingerprints, normalisation, PD, the Gauss-Newton model)
    in `dtype`, and with `tf32_products` the inputs of its matrix
    products rounded to TF32 (as the card's TF32 mode computes them)."""

    dictionary_kernel = "reference"
    jacobian_kernel = "fisp_jac"

    def __init__(self, ref, cfg, traffic, dtype, tf32_products=False):
        from perfbench.reference import serving

        self.ref, self.cfg, self.dtype = ref, cfg, dtype
        self.fd_step = traffic.get("fd_step")
        self.serving = serving
        self.low = serving.tf32 if tf32_products else (lambda x: x)
        self.tf32_products = tf32_products

    def dictionary(self, params, normalize):
        f = self.ref.fingerprints(self.cfg, params.T, dtype=self.dtype,
                                  normalize=normalize)
        return f.real, f.imag

    def dictionary_launches(self):
        return 0

    def reconstruct(self, sig_re, sig_im, dict_re, dict_im, grid,
                    atom_chunk):
        low, dt = self.low, self.dtype
        s_cat = low(torch.cat([sig_re, sig_im], dim=1))
        V = sig_re.shape[0]
        best = torch.zeros(V, dtype=torch.int64, device=sig_re.device)
        val = torch.full((V,), -1.0, device=sig_re.device)
        for off in range(0, dict_re.shape[0], atom_chunk):
            br, bi = dict_re[off:off + atom_chunk], dict_im[off:off + atom_chunk]
            n = torch.sqrt(torch.sum(br * br + bi * bi, dim=1, keepdim=True))
            br, bi = ((x / n).to(dt).float() for x in (br, bi))
            x = s_cat @ low(torch.cat([br, bi], dim=1)).T
            y = s_cat @ low(torch.cat([-bi, br], dim=1)).T
            mx, am = torch.max(x * x + y * y, dim=1)
            take = mx > val
            best = torch.where(take, am + off, best)
            val = torch.where(take, mx, val)
        d = torch.complex(dict_re[best], dict_im[best])
        pd = self.serving.rounded(self.serving.pd_scale(
            d, torch.complex(sig_re, sig_im)), dt)
        return {"index": best, "pd_re": pd.real, "pd_im": pd.imag,
                "maps": grid[best]}

    def refine(self, signal_and_jac, theta0, sig_re, sig_im, *, iters,
               damping, bounds):
        sig = torch.complex(sig_re.T, sig_im.T)
        theta = self.serving.refine(
            self.ref, self.cfg,
            torch.as_tensor(np.asarray(theta0).T, device=sig.device), sig,
            iters=iters, damping=damping, bounds=bounds,
            fd_step=self.fd_step, dtype=self.dtype,
            tf32_products=self.tf32_products)
        return theta.T.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    bench = harness.load_benchmark()
    parts = harness.load_cell(bench, args.workload)
    sides = ([("program", None)] * args.program
             + [("control", parts["kind"].CONTROL)] * args.control)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side, low in sides:
            system = None if low is None else ReferenceSystem(
                parts["reference"], parts["config"], parts["traffic"], *low)
            t0 = time.perf_counter()
            out = harness.run_cell(parts, seed=seed, seconds=args.seconds,
                                   trace=False, device="cuda:0",
                                   t_start=t0, system=system,
                                   check_paths=system is None)
            print(json.dumps({"workload": args.workload, "side": side,
                              "seed": seed, "correct": out["correct"],
                              "attempted": out["attempted"],
                              "failed": out["failed"],
                              "checks": out["checks"],
                              "metrics": out["metrics"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
