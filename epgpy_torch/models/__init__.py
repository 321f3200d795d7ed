"""Model-level simulators and kernels (counterpart of ``epgpy_tpu/models``)."""

from . import (cuda_bssfp, cuda_composite, cuda_dess, cuda_fisp,
               cuda_hessian, cuda_megre, cuda_mse, cuda_msedesign, mrf, mse,
               planes, slice_profile, ssfp)
from .cuda_bssfp import (bssfp_dictionary_cuda, bssfp_dictionary_plain,
                         bssfp_jacobian_cuda, bssfp_jacobian_plain)
from .cuda_composite import (composite_cuda, composite_jacobian_cuda,
                             composite_jacobian_plain, composite_plain)
from .cuda_dess import (dess_dictionary_cuda, dess_dictionary_plain,
                        dess_jacobian_cuda, dess_jacobian_plain)
from .cuda_fisp import (fisp_dictionary_cuda, fisp_dictionary_plain,
                        fisp_full_ladder_cuda, fisp_full_ladder_plain)
from .cuda_megre import (megre_dictionary_cuda, megre_dictionary_plain,
                         megre_jacobian_cuda, megre_jacobian_plain)
from .cuda_mse import (cpmg_dictionary_cuda, cpmg_dictionary_plain,
                       cpmg_jacobian_cuda, cpmg_jacobian_plain)
from .cuda_msedesign import cpmg_design_cuda, cpmg_design_plain
from .mrf import (fisp_mrf_signal, fisp_mrf_dictionary, save_dictionary,
                  load_dictionary)
from .mse import cpmg_sequence, mse_signal
from .slice_profile import fisp_mrf_dictionary_sliced, slice_profile_scales
from .ssfp import bssfp_sequence, dess_sequence, spgr_sequence

__all__ = ["cuda_bssfp", "cuda_composite", "cuda_dess", "cuda_fisp",
           "cuda_hessian", "cuda_megre", "cuda_mse", "cuda_msedesign", "mrf",
           "mse", "planes", "slice_profile", "ssfp",
           "bssfp_dictionary_cuda", "bssfp_dictionary_plain",
           "bssfp_jacobian_cuda", "bssfp_jacobian_plain",
           "composite_cuda", "composite_plain", "composite_jacobian_cuda",
           "composite_jacobian_plain",
           "dess_dictionary_cuda", "dess_dictionary_plain",
           "dess_jacobian_cuda", "dess_jacobian_plain",
           "fisp_dictionary_cuda", "fisp_dictionary_plain",
           "fisp_full_ladder_cuda", "fisp_full_ladder_plain",
           "megre_dictionary_cuda", "megre_dictionary_plain",
           "megre_jacobian_cuda", "megre_jacobian_plain",
           "cpmg_dictionary_cuda", "cpmg_dictionary_plain",
           "cpmg_jacobian_cuda", "cpmg_jacobian_plain", "cpmg_design_cuda",
           "cpmg_design_plain", "fisp_mrf_signal", "fisp_mrf_dictionary",
           "save_dictionary", "load_dictionary", "cpmg_sequence",
           "mse_signal", "bssfp_sequence", "dess_sequence",
           "spgr_sequence", "fisp_mrf_dictionary_sliced",
           "slice_profile_scales"]
