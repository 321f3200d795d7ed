"""MRF-FISP serving through epgpy_torch: the dictionary built once by the
dictionary entry, then ``parallel.mrf_reconstruct`` and
``parallel.gauss_newton_refine`` with a Jacobian probe through
``engine.simulate``."""

from __future__ import annotations

import numpy as np

import epgpy_torch as epg
from epgpy_torch import fisp_dispatch
from epgpy_torch.models import cuda_fisp
from epgpy_torch.parallel import gauss_newton_refine, mrf_reconstruct

from . import dictionary


class System(dictionary.System):
    #: kernel of the Jacobian probe
    jacobian_kernel = "fisp_jac"

    def jacobian_counts(self):
        """(dispatches to the Jacobian kernel family, its launches)."""
        return (fisp_dispatch.DISPATCH_COUNTS.get("jac:fisp", 0),
                cuda_fisp.JAC_LAUNCHES)

    def reconstruct(self, sig_re, sig_im, dict_re, dict_im, grid,
                    atom_chunk):
        return mrf_reconstruct(sig_re, sig_im, dict_re, dict_im, grid,
                               atom_chunk=atom_chunk)

    def refine(self, signal_and_jac, theta0, sig_re, sig_im, *, iters,
               damping, bounds):
        return gauss_newton_refine(signal_and_jac, theta0, sig_re, sig_im,
                                   iters=iters, damping=damping,
                                   bounds=bounds, solve_scale=True)

    def tracked_train(self, theta):
        """The train at theta (3, V) as a user writes it, tracking T1 and
        T2 on the E ops and B1 on the T ops (d alpha_i / d B1 = FA_i)."""
        t = self.train
        T1, T2, B1 = theta
        o1 = ["T1", "T2"]
        seq = []
        for fa in t["FA"]:
            seq += [epg.T((fa * B1).astype(np.float32), t["phase_deg"],
                          order1={"B1": {"alpha": float(fa)}}),
                    epg.E(t["TE"], T1, T2, order1=o1), epg.ADC,
                    epg.E(t["TR"] - t["TE"], T1, T2, order1=o1), epg.S(1)]
        return seq

    def signal_and_jacobian(self, seq):
        """Signal (P, V) and Jacobian (P, V, 3) tensors on the device."""
        return epg.simulate(seq, max_nstate=self.train["nstate"],
                            asarray=False,
                            probe=[epg.ADC,
                                   epg.Jacobian(["T1", "T2", "B1"])])
