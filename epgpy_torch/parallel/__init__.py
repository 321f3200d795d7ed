"""MRF serving and sequence design: dictionary matching, reconstruction,
Gauss-Newton refinement, CRLB design of the MRF train (counterpart of
``epgpy_tpu/parallel``; the atom-sharded forms and the rest of that package
are not ported yet, ROADMAP queue 1)."""

from .crlb import (FA_BOUNDS, TR_BOUNDS, mrf_design_loss,
                   mrf_design_loss_grad_fused, mrf_design_slsqp,
                   mrf_design_step)
from .match import (compress_dictionary, dictionary_match, full_precision,
                    project_signals)
from .recon import gauss_newton_refine, mrf_reconstruct

__all__ = ["dictionary_match", "compress_dictionary", "project_signals",
           "full_precision", "mrf_reconstruct", "gauss_newton_refine",
           "mrf_design_loss", "mrf_design_loss_grad_fused",
           "mrf_design_slsqp", "mrf_design_step", "FA_BOUNDS", "TR_BOUNDS"]
