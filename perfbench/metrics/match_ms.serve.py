"""Host ms per batch of the match (parallel.mrf_reconstruct: the float64
normalisation and the chunked FP32 products), ending in a device sync."""
from perfbench.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "prog.match")
