"""What every traffic kind's loop shares: the cell's parts, the seed's
generators, the spans, and what the check needs.

Every input comes from ``--seed``: a ``torch.Generator`` on the device
for the tensors, a NumPy generator for the host-side sample indices.  A
loop keeps a sample of what the timed calls returned and judges it
against the plain reference once the window has closed.
"""

from __future__ import annotations

import numpy as np
import torch


class Loop:
    def __init__(self, parts, seed, device, spans, check_paths=True):
        self.cfg, self.traffic = parts["config"], parts["traffic"]
        if (self.traffic["loop"], self.traffic["clients"]) != ("closed", 1):
            raise ValueError("the generator drives one closed-loop client")
        self.ref, self.system = parts["reference"], parts["system"]
        self.device = torch.device(device)
        self.spans = spans
        self.check_paths = check_paths
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.rng = np.random.default_rng(int(seed) % (1 << 63))
        self.attempted = 0
        self.bad = set()          # indices of timed calls found at fault
        self.shapes = {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def uniform(self, shape, lo, hi):
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return lo + (hi - lo) * u

    @property
    def failed(self):
        return len(self.bad)

    def release(self):
        """Free what the program holds before the check runs."""
