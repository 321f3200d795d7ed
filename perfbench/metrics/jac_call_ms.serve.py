"""Host ms per Gauss-Newton iteration of engine.simulate with the Jacobian
probe (the dispatch's host matcher, the fisp_jac kernel and the
assembly), ending in a device sync."""
from perfbench.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "prog.jac_call")
