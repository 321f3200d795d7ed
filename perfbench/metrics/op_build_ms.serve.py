"""Host ms per Gauss-Newton iteration of building the tracked train
(the operator constructors T, E, ADC, S over the batch's parameters)."""
from perfbench.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "prog.op_build")
