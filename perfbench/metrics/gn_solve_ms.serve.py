"""Self time per iteration of parallel.gauss_newton_refine: the refine
span less its callbacks (train build and simulate), per iteration."""


def read(run):
    refine = sum(run.spans.durations("prog.refine"))
    inner = (sum(run.spans.durations("prog.op_build"))
             + sum(run.spans.durations("prog.jac_call")))
    n = len(run.spans.durations("prog.jac_call"))
    return 1e3 * (refine - inner) / n if n else None
