"""The 95th percentile of the host-to-host time of the served calls, in
ms: every call of the traced run's window that the profiler did not
trace.  A tail, kept beside the bounded rate: its runs spread too widely
on the card's host for a bound (PERF.md)."""

import statistics


def value(run):
    spans = run.record.unprofiled_spans()
    if len(spans) < 2:
        return None
    return statistics.quantiles(spans, n=100, method="inclusive")[94] * 1e3
