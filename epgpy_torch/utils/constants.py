"""Physical constants (counterpart of ``epgpy_tpu/utils/constants.py``)."""

gamma_1H = 42.576e3  # kHz/T
gamma_23Na = 11.262e3  # kHz/T
