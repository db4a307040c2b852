"""Host time of pass sizing per receive call, in ms: the total time of
the program's ``dtv.sizing`` spans (``utils/device.working_bytes``, whose
``mem_get_info`` query may wait behind queued work) over the traced
calls."""

from dtvbench.layer_metrics._spans import total_ms


def value(run):
    return total_ms(run, ("dtv.sizing",))
