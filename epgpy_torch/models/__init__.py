"""Model-level simulators and kernels (counterpart of ``epgpy_tpu/models``)."""

from . import cuda_fisp, mrf, planes
from .cuda_fisp import fisp_dictionary_cuda, fisp_dictionary_plain
from .mrf import (fisp_mrf_signal, fisp_mrf_dictionary, save_dictionary,
                  load_dictionary)

__all__ = ["cuda_fisp", "mrf", "planes", "fisp_dictionary_cuda",
           "fisp_dictionary_plain", "fisp_mrf_signal", "fisp_mrf_dictionary",
           "save_dictionary", "load_dictionary"]
