"""The bSSFP dictionary kernel (``csrc/bssfp.cu``): three state floats per
atom at k = 0.

Per atom: 20 operations of set-up (the inversion and its relaxation), and
per pulse 70 (the rotation of (F+, Z), the TE decay and precession, the
demodulation, the TR relaxation and precession).  Bytes: FA, phase, TR
and TE per pulse, T1, T2, B1 and df per atom, the (2, P, B) echoes."""

KERNEL = "bssfp_kernel"
SETUP, PER_PULSE = 20, 70


def flops(shape):
    B, P = shape["atoms"], shape["pulses"]
    return B * (SETUP + PER_PULSE * P)


def nbytes(shape):
    B, P = shape["atoms"], shape["pulses"]
    return 4 * (4 * P + 4 * B + 2 * P * B)
