"""Share of the FISP Jacobian kernel's roofline (csrc/fisp_jac.cu)."""
from perfbench.metrics._common import roofline


def read(run):
    return roofline(run, "fisp_jac")
