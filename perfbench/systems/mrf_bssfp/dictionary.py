"""bSSFP MRF dictionaries through epgpy_torch's dictionary entry
(``models.cuda_bssfp.bssfp_dictionary_cuda``)."""

from __future__ import annotations

import torch

from epgpy_torch.models import cuda_bssfp


class System:
    dictionary_kernel = "bssfp"

    def __init__(self, train, device):
        self.train = train
        self.pulses = [torch.as_tensor(train[k], dtype=torch.float32,
                                       device=device)
                       for k in ("FA", "phase", "TR", "TE")]
        self._ones = torch.ones(0, device=device)

    def dictionary(self, params, normalize):
        """(re, im), each (B, P), of atoms params (3, B) = (T1, T2, df);
        B1 = 1."""
        if self._ones.shape[0] != params.shape[1]:
            self._ones = torch.ones_like(params[0])
        return cuda_bssfp.bssfp_dictionary_cuda(
            *self.pulses, params[0], params[1], self._ones, params[2],
            demodulate=self.train["demodulate"], inversion=self.train["TI"],
            normalize=normalize)

    def dictionary_launches(self):
        return cuda_bssfp.LAUNCHES
