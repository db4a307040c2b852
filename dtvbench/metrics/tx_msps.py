"""IQ samples the card made per second, in millions, with the
modulator setting the pace: all the window's samples over all of its
time, synchronised at its end."""

from dtvbench.metrics._rate import msps


def value(run) -> float:
    return msps(run)
