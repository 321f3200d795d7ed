"""Device ms per dictionary call of everything the entry launched except
its kernel: the wrapper's argument preparation and the normalisation
epilogue (cuda_fisp._finish)."""


def read(run):
    if run.trace is None or run.calls == 0:
        return None
    counts = run.counts(run.system.dictionary_kernel)
    s = run.trace.span_device_time("prog.dictionary", exclude=counts.KERNEL)
    return 1e3 * s / run.calls if s > 0 else None
