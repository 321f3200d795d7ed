"""Helpers the per-layer readers share.  A reader's ``read(run)`` returns
the metric's value, or None where the run has nothing to read (no trace,
no such kernel or span): the harness then leaves the metric out."""


def roofline(run, kernel):
    """Percent of the kernel's roofline over the traced window: the least
    time of its launches by the closed-form counts at the published peaks
    (the larger of operations over the FP32 rate and bytes over the HBM
    rate), over the device time the profiler gave them."""
    shape = run.shapes.get(kernel)
    if run.trace is None or shape is None:
        return None
    counts = run.counts(kernel)
    seconds, launches = run.trace.kernel_time(counts.KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    least = max(counts.flops(shape) / run.peaks["fp32_flops"],
                counts.nbytes(shape) / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least * launches / seconds


def idle_pct(run):
    """Percent of the traced window in which no operation ran on the
    device."""
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mean_ms(run, span):
    """Mean host-clock duration of a span, in ms."""
    d = run.spans.durations(span)
    return 1e3 * sum(d) / len(d) if d else None
