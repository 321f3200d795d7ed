"""The FISP dictionary kernel (``csrc/fisp_half.cu``).

Per atom: 6 operations of set-up (relaxation factors), and per pulse 29
for the per-atom terms (the flip's rotation coefficients from FA * B1,
the echo) plus 60 per reached ladder row (the 3 x 3 complex rotation of
(F+, F-, Z) folded onto real planes, the two relaxations, the shift).
Bytes: FA, phase and TR per pulse, T1, T2 and B1 per atom, the (2, P, B)
echoes."""

from ._ladder import reached_rows

KERNEL = "fisp_half_kernel"
SETUP, PER_PULSE, PER_ROW = 6, 29, 60


def flops(shape):
    B, P, n = shape["atoms"], shape["pulses"], shape["nstate"]
    return B * (SETUP + PER_PULSE * P + PER_ROW * reached_rows(P, n))


def nbytes(shape):
    B, P = shape["atoms"], shape["pulses"]
    return 4 * (3 * P + 3 * B + 2 * P * B)
