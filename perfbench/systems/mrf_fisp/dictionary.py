"""MRF-FISP dictionaries through epgpy_torch's dictionary entry
(``models.mrf.fisp_mrf_dictionary``)."""

from __future__ import annotations

import torch

from epgpy_torch.models import cuda_fisp
from epgpy_torch.models.mrf import fisp_mrf_dictionary


class System:
    #: kernel of the dictionary entry
    dictionary_kernel = "fisp_half"

    def __init__(self, train, device):
        self.train = train
        self.FA = torch.as_tensor(train["FA"], dtype=torch.float32,
                                  device=device)

    def dictionary(self, params, normalize):
        """(re, im), each (B, P), of atoms params (3, B) = (T1, T2, B1)."""
        t = self.train
        return fisp_mrf_dictionary(self.FA, t["TR"], t["TE"], params[0],
                                   params[1], params[2],
                                   phi=t["phase_deg"], nstate=t["nstate"],
                                   normalize=normalize)

    def dictionary_launches(self):
        return cuda_fisp.LAUNCHES
