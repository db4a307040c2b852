"""Kernels the card ran per receive call: the profiler's kernel
activities over the traced calls."""

from dtvbench.layer_metrics._device import per_call


def value(run):
    s = run.summary
    return per_call(run, float(s.count("kernel"))) if s else None
