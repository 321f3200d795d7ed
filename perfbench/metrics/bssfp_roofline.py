"""Share of the bSSFP dictionary kernel's roofline (csrc/bssfp.cu)."""
from perfbench.metrics._common import roofline


def read(run):
    return roofline(run, "bssfp")
