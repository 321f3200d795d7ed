"""Dictionary traffic: back-to-back calls of the configuration's
dictionary entry over its whole atom grid, each grid offset by a fresh
sub-step jitter drawn on the device; at most two calls in flight.  The
check compares a sample of every timed call's atoms, and the last call
whole, with the reference's unit-norm fingerprints.

The adapter (``systems/<config>/dictionary.py``) gives ``System`` with
``dictionary(params, normalize)``, ``dictionary_launches()`` and
``dictionary_kernel``; the reference gives ``grid``, ``steps``,
``constrain``, ``train`` and ``fingerprints``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.kinds import _loop
from perfbench.tracing import WINDOW

#: the control's precision: (arithmetic, TF32 products).  The dictionary
#: path runs no matrix product, so its float32 is held against bfloat16
CONTROL = (torch.bfloat16, False)


class Loop(_loop.Loop):
    def setup(self):
        cfg, tf = self.cfg, self.traffic
        g = self.ref.grid(cfg).astype(np.float32)
        self.grid = torch.as_tensor(g.T.copy(), device=self.device)  # (3, B)
        self.B = self.grid.shape[1]
        half = tf["jitter_steps"] * self.ref.steps(cfg)
        self.half = torch.as_tensor(half[:, None], dtype=torch.float32,
                                    device=self.device)
        self.samples = []
        self.shapes[self.system.dictionary_kernel] = dict(
            atoms=self.B, pulses=len(self.ref.train(cfg)["FA"]),
            nstate=cfg["train"].get("nstate", 0))
        self.call()                      # warm-up: the cell's one shape
        self.samples.clear()
        self.sync()

    def params(self):
        u = torch.rand(self.grid.shape, generator=self.gen,
                       device=self.device)
        p = self.grid + (2 * u - 1) * self.half
        self.ref.constrain(self.cfg, p.T)
        return p

    def call(self):
        sp = self.spans
        with sp("bench.inputs"):
            p = self.params()
        with sp("prog.dictionary"):
            re, im = self.system.dictionary(p, self.traffic["normalize"])
        with sp("bench.sample"):
            idx = torch.randint(0, self.B,
                                (self.traffic["sample_atoms_per_call"],),
                                generator=self.gen, device=self.device)
            self.samples.append((p[:, idx], re[idx], im[idx]))
        return p, re, im

    def window(self, seconds):
        sp = self.spans
        launches = self.system.dictionary_launches()
        prev = None
        self.sync()
        t0 = time.perf_counter()
        with sp(WINDOW):
            while True:
                self.last = self.call()
                self.attempted += 1
                ev = None
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                if prev is not None:
                    with sp("bench.wait"):
                        prev.synchronize()
                prev = ev
                if time.perf_counter() - t0 >= seconds:
                    break
            self.sync()
        elapsed = time.perf_counter() - t0
        reached = self.system.dictionary_launches() - launches
        if self.check_paths and reached != self.attempted:
            # which calls missed the kernel is not known: count the misses
            self.bad.update(range(self.attempted - reached))
        return {"atoms_per_s": self.attempted * self.B / elapsed}

    def check(self, limits):
        """fingerprint_err: the largest |program - reference| over every
        sampled atom of every timed call and over every atom of the last
        call (unit-norm rows, the reference in float64)."""
        lim = limits["fingerprint_err"]
        block = self.traffic["reference_block_atoms"]

        def errors(p, re, im):
            """Per atom max |program - reference|, block by block."""
            out = []
            for b0 in range(0, p.shape[1], block):
                want = self.ref.fingerprints(self.cfg, p[:, b0:b0 + block].T,
                                             normalize=True)
                got = torch.complex(re[b0:b0 + block], im[b0:b0 + block])
                out.append((got.to(want.dtype) - want).abs().amax(dim=1))
                del want, got
            return torch.cat(out)

        per = [torch.cat(x, dim=d) for x, d in
               zip(zip(*self.samples), (1, 0, 0))]
        err = errors(*per).cpu()
        n = len(self.samples[0][1])
        for k, e in enumerate(torch.split(err, n)):
            if not float(e.max()) <= lim:
                self.bad.add(k)
        worst = float(err.max())
        last = float(errors(*self.last).max())
        if not last <= lim:
            self.bad.add(self.attempted - 1)
        return {"fingerprint_err": max(worst, last)}
