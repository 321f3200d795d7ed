"""MRF-FISP through epgpy_torch."""
