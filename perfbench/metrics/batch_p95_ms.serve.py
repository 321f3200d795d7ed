"""95th percentile of the host time of a whole batch (match and
refinement) over every batch of the window."""
import numpy as np


def read(run):
    d = run.spans.durations("bench.batch")
    return 1e3 * float(np.percentile(d, 95)) if d else None
