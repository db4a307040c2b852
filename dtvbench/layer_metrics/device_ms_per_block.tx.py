"""Kernel time per block (superframe), in ms: the profiler's kernel
durations over the traced calls, divided by their blocks."""

from dtvbench.layer_metrics._device import per_call


def value(run):
    s = run.summary
    v = per_call(run, s.total_s("kernel") * 1e3) if s else None
    return None if not v else v / run.outcome.work["blocks_per_call"]
