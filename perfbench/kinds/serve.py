"""Serving traffic: back-to-back batches of noisy voxels drawn from a pool
of reference fingerprints; each batch is matched against the
configuration's dictionary (built once in set-up) and refined by
Gauss-Newton with the program's Jacobian.  The check compares a sample
of every batch's voxels with the reference's match and Gauss-Newton.

The adapter (``systems/<config>/serve.py``) gives ``System`` with the
dictionary interface (see ``kinds/dictionary.py``) and
``reconstruct``, ``refine``, ``tracked_train``, ``signal_and_jacobian``,
``jacobian_counts()`` and ``jacobian_kernel``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.kinds import _loop
from perfbench.reference import serving as ref_serving
from perfbench.tracing import WINDOW

#: the control's precision: (arithmetic, TF32 products).  The program
#: runs its float32 matrix products with TF32 off, so the precision below
#: is TF32 products
CONTROL = (torch.float32, True)


class Loop(_loop.Loop):
    def setup(self):
        cfg, tf = self.cfg, self.traffic
        dev = self.device
        g = self.ref.grid(cfg).astype(np.float32)
        self.grid_rows = torch.as_tensor(g, device=dev)            # (B, 3)
        grid = self.grid_rows.T.contiguous()                       # (3, B)
        launches = self.system.dictionary_launches()
        self.dre, self.dim = self.system.dictionary(grid, False)
        self.sync()
        if (self.check_paths
                and self.system.dictionary_launches() - launches != 1):
            raise RuntimeError("the dictionary build missed its kernel")
        # the pool of clean fingerprints, by the reference in float64
        tr = tf["truth"]
        n = tf["pool_voxels"]
        T1 = self.uniform(n, *tr["T1"]).double()
        T2 = torch.minimum(self.uniform(n, *tr["T2"]).double(),
                           tr["t2_max_over_t1"] * T1)
        B1 = self.uniform(n, *tr["B1"]).double()
        truth = torch.stack([T1, T2, B1], dim=1)
        blk = tf["reference_block_atoms"]
        self.pool = torch.cat([
            self.ref.fingerprints(self.cfg, truth[b:b + blk]).to(
                torch.complex64) for b in range(0, n, blk)])
        self.V = tf["batch_voxels"]
        P = self.pool.shape[1]
        self.shapes[self.system.jacobian_kernel] = dict(
            atoms=self.V, pulses=P, nstate=cfg["train"]["nstate"])
        self.samples = []
        theta = self.batch()             # warm-up: the cell's one shape
        # then the program's memos of per-train host work (the engine's
        # preamble, the dispatch's matchers) filled to their steady state:
        # every Gauss-Newton call builds a new train, which takes a new
        # entry until the memo evicts its oldest.  (A reference put in the
        # program's place builds no train.)
        if hasattr(self.system, "tracked_train"):
            for _ in range(tf["warmup_gn_calls"]):
                self.signal_and_jac(theta)
        self.samples.clear()
        self.sync()

    def inputs(self):
        tf = self.traffic
        V, P = self.V, self.pool.shape[1]
        vi = torch.randint(0, self.pool.shape[0], (V,), generator=self.gen,
                           device=self.device)
        mag = self.uniform(V, *tf["pd_magnitude"])
        ph = self.uniform(V, 0.0, 2 * math.pi)
        pd = torch.polar(mag, ph)
        nre = torch.randn((V, P), generator=self.gen, device=self.device)
        nim = torch.randn((V, P), generator=self.gen, device=self.device)
        sig = (self.pool[vi] * pd[:, None]
               + tf["noise_sigma"] * torch.complex(nre, nim))
        return sig

    def signal_and_jac(self, theta):
        sp = self.spans
        with sp("prog.op_build"):
            seq = self.system.tracked_train(theta)
        with sp("prog.jac_call", sync=True):
            sig, jac = self.system.signal_and_jacobian(seq)
        return (sig.real, sig.imag), (jac.real, jac.imag)

    def batch(self):
        tf, sp = self.traffic, self.spans
        with sp("bench.inputs"):
            sig = self.inputs()
            sre, sim = sig.real.contiguous(), sig.imag.contiguous()
        with sp("prog.match", sync=True):
            rec = self.system.reconstruct(sre, sim, self.dre, self.dim,
                                          self.grid_rows, tf["atom_chunk"])
        theta0 = rec["maps"].T.cpu().numpy()
        with sp("prog.refine"):
            theta = self.system.refine(
                self.signal_and_jac, theta0, sre.T, sim.T,
                iters=tf["gn_iters"], damping=tf["gn_damping"],
                bounds=tf["gn_bounds"])
        with sp("bench.sample"):
            s = self.rng.choice(self.V, tf["sample_voxels_per_batch"],
                                replace=False)
            st = torch.as_tensor(s, device=self.device)
            self.samples.append(dict(
                sig=sig[st], index=rec["index"][st],
                pd=torch.complex(rec["pd_re"][st], rec["pd_im"][st]),
                maps=rec["maps"][st],
                theta=torch.as_tensor(np.asarray(theta)[:, s].T.copy(),
                                      device=self.device)))
        return theta

    def jacobian_counts(self):
        return self.system.jacobian_counts() if self.check_paths else None

    def window(self, seconds):
        sp = self.spans
        iters = self.traffic["gn_iters"]
        t0 = time.perf_counter()
        with sp(WINDOW):
            while True:
                before = self.jacobian_counts()
                with sp("bench.batch"):
                    self.batch()
                after = self.jacobian_counts()
                if before is not None and any(
                        b - a != iters for a, b in zip(before, after)):
                    self.bad.add(self.attempted)
                self.attempted += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        elapsed = time.perf_counter() - t0
        return {"voxels_per_s": self.attempted * self.V / elapsed}

    def release(self):
        """Free the program's dictionary and the pool before the check."""
        self.dre = self.dim = self.pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits):
        """match_gap: how far the reference's correlation of the matched
        atom falls below the reference's best over the grid, as a share of
        the best; pd_err: |pd - reference pd| / |reference pd| of the
        matched atom; theta0_err: |map - grid value| of the matched atom
        (exact); map_err: the refined maps against the reference's
        Gauss-Newton from the same matched atoms, relative per parameter.
        Each is the largest over the sampled voxels of every batch."""
        tf = self.traffic
        per = {k: torch.cat([s[k] for s in self.samples])
               for k in self.samples[0]}
        nb = [len(s["index"]) for s in self.samples]
        sig = per["sig"].to(torch.complex128)
        idx = per["index"]
        grid64 = self.grid_rows.double()
        best, at = ref_serving.correlations(
            self.ref, self.cfg, grid64, sig, idx,
            block=tf["reference_block_atoms"])
        d = self.ref.fingerprints(self.cfg, grid64[idx])
        pd_ref = ref_serving.pd_scale(d, sig)
        theta_ref = ref_serving.refine(
            self.ref, self.cfg, grid64[idx], sig, iters=tf["gn_iters"],
            damping=tf["gn_damping"], bounds=tf["gn_bounds"],
            fd_step=tf["fd_step"])
        rows = {
            "match_gap": (best - at) / best,
            "pd_err": (per["pd"].to(torch.complex128) - pd_ref).abs()
            / pd_ref.abs(),
            "theta0_err": (per["maps"] - self.grid_rows[idx]).abs().amax(1)
            .double(),
            "map_err": ((per["theta"].double() - theta_ref).abs()
                        / theta_ref.abs()).amax(1),
        }
        numbers = {}
        for name, v in rows.items():
            v = v.cpu()
            numbers[name] = float(v.max())
            for b, part in enumerate(torch.split(v, nb)):
                if not bool((part <= limits[name]).all()):
                    self.bad.add(b)
        return numbers
