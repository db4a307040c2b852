"""Samples per second over the whole window, shared by the rate
metrics: every sample made or taken in, over all the window's time up to
its closing synchronise."""


def msps(run) -> float:
    return run.record.samples / run.record.seconds / 1e6
