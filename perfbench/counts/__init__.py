"""Closed-form operations and bytes of the program's kernels, one module
per kernel, each with ``KERNEL`` (the substring of its device name in the
profiler's trace), ``flops(shape)`` and ``nbytes(shape)``.  They count the
work the shapes need, whatever implements it: the recurrence over the
ladder rows the train has reached, each input read once and each output
written once, in float32 (4 bytes)."""
