"""Samples of air per second, in millions, through the served path from
the client's side (host input in, host output out): all the window's
samples over all of its time."""

from dtvbench.metrics._rate import msps


def value(run) -> float:
    return msps(run)
