"""Device meshes, MRF serving and sequence design: atom-sharded
execution, dictionary matching and its streamed compression,
reconstruction, Gauss-Newton refinement, CRLB design of the MRF and TSE
trains (the FA-train CRLB with its tangent axis sharded), EPG-NNLS T2
spectra and myelin-water maps (counterpart of ``epgpy_tpu/parallel``).
The mesh is single controller (``mesh.py``): one process, whole tensors
in and out."""

from .mesh import atom_sharding, make_mesh
from .crlb import (FA_BOUNDS, TR_BOUNDS, crlb_train_step,
                   fingerprint_crlb_loss, mrf_design_loss,
                   mrf_design_loss_grad_fused, mrf_design_slsqp,
                   mrf_design_step, mse_design_loss_grad_fused,
                   tse_design_slsqp)
from .match import (compress_dictionary, dictionary_match, full_precision,
                    load_compression, project_signals, save_compression,
                    streamed_compress_dictionary)
from .recon import gauss_newton_refine, mrf_reconstruct
from .t2spectrum import nnls, t2_basis, t2_spectrum_map

__all__ = ["make_mesh", "atom_sharding", "crlb_train_step",
           "fingerprint_crlb_loss", "dictionary_match",
           "compress_dictionary", "project_signals", "full_precision",
           "mrf_reconstruct", "gauss_newton_refine", "mrf_design_loss",
           "mrf_design_loss_grad_fused", "mrf_design_slsqp",
           "mrf_design_step", "mse_design_loss_grad_fused",
           "tse_design_slsqp", "FA_BOUNDS", "TR_BOUNDS",
           "streamed_compress_dictionary", "save_compression",
           "load_compression", "t2_basis", "nnls", "t2_spectrum_map"]
