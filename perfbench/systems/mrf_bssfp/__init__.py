"""bSSFP MRF through epgpy_torch."""
