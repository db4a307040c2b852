"""Mean host time of a captured call, in µs: the harness's span from
the call to its return, over the window's calls that the profiler did
not trace."""


def value(run):
    spans = run.record.unprofiled_spans()
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e6
