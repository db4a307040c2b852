"""Host-only work of a served call after its results have reached the
host, in ms per call: the self time of the program's ``dtv.stream.host``
spans (DVB-T receive's TPS fields and phase check, a ``modulate_stream``'s
``np.concatenate``) over the traced calls."""

from dtvbench.layer_metrics._spans import self_ms


def value(run):
    return self_ms(run, ("dtv.stream.host",))
