"""Share of the traced window in which no operation ran on the card,
served calls (the union of kernel, copy and set intervals from the
profiler's trace)."""

from dtvbench.layer_metrics._device import idle_share


def value(run):
    return idle_share(run)
