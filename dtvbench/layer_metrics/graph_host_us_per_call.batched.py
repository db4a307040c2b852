"""Host time of a captured call inside the program, in µs: the total
time of the program's ``dtv.graph.call`` spans (``utils/graph.StaticCall``:
copy in, replay, copy out) over the traced calls."""

from dtvbench.layer_metrics._spans import total_ms


def value(run):
    ms = total_ms(run, ("dtv.graph.call",))
    return None if ms is None else ms * 1e3
