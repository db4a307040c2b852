"""Host time of the served calls' copies between host and card, in ms
per call: the self time of the program's ``dtv.stream.copy_in`` and
``dtv.stream.copy_out`` spans over the traced calls.  The wait for the
card's queue before the first copy out is a span of its own, left out."""

from dtvbench.layer_metrics._spans import self_ms


def value(run):
    return self_ms(run, ("dtv.stream.copy_in", "dtv.stream.copy_out"))
