"""The FISP Jacobian kernel (``csrc/fisp_jac.cu``): the echoes and their
derivatives in T1, T2 and B1.

Per atom: 9 operations of set-up, and per pulse 62 for the per-atom terms
plus 312 per reached ladder row (the primal row and its three tangent
rows pushed through the same rotation, relaxations and shift, with the
derivative terms of the flip and the decays).  Bytes: FA, phase and TR
per pulse, T1, T2 and B1 per atom, the (2 + 2 * 3, P, B) echoes and
tangents."""

from ._ladder import reached_rows

KERNEL = "fisp_jac_kernel"
SETUP, PER_PULSE, PER_ROW, TANGENTS = 9, 62, 312, 3


def flops(shape):
    B, P, n = shape["atoms"], shape["pulses"], shape["nstate"]
    return B * (SETUP + PER_PULSE * P + PER_ROW * reached_rows(P, n))


def nbytes(shape):
    B, P = shape["atoms"], shape["pulses"]
    return 4 * (3 * P + 3 * B + (2 + 2 * TANGENTS) * P * B)
