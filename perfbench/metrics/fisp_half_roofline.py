"""Share of the FISP dictionary kernel's roofline (csrc/fisp_half.cu)."""
from perfbench.metrics._common import roofline


def read(run):
    return roofline(run, "fisp_half")
