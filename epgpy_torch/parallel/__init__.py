"""MRF serving: dictionary matching, reconstruction, Gauss-Newton
refinement (counterpart of ``epgpy_tpu/parallel``; the atom-sharded forms
and the rest of that package are not ported yet, ROADMAP queue 1)."""

from .match import (compress_dictionary, dictionary_match, full_precision,
                    project_signals)
from .recon import gauss_newton_refine, mrf_reconstruct

__all__ = ["dictionary_match", "compress_dictionary", "project_signals",
           "full_precision", "mrf_reconstruct", "gauss_newton_refine"]
