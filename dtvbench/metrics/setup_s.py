"""Process start to the first timed call, in s: loading, building or
loading the kernels, making the inputs, warming up the cell's shapes."""


def value(run) -> float:
    return run.setup_s
