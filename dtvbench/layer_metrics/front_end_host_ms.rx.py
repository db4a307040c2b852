"""Host time of the receiver's front end per call, in ms: the self time
of the program's ``dtv.rx.front_end`` spans (``rx/dvbt._front_end``,
``rx/j83b.front``: the host launching the FFT, demap or matched filter)
over the traced calls."""

from dtvbench.layer_metrics._spans import self_ms


def value(run):
    return self_ms(run, ("dtv.rx.front_end",))
