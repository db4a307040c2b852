"""The program's own spans in the traced window, shared by the per-layer
readers: the host events named ``dtv.*`` that ``dtv_utils_torch/utils/
trace.span`` records while a profiler session is active.

A span's total time is its duration; its self time is its duration less
the part of it that the ``dtv.*`` spans nested inside it on the same
thread cover.  Both are clipped to the traced window, summed over the
spans of the names asked for and given per traced call, in ms; None where
the trace holds no such span (a program without the spans).
"""

from dtvbench.trace import union_s

PREFIX = "dtv."


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0)


def _read(run, names: tuple[str, ...], self_time: bool) -> float | None:
    s = run.summary
    if s is None:
        return None
    spans = [e for e in s.host if e.get("name", "").startswith(PREFIX)]
    hits = [e for e in spans if e["name"] in names]
    if not hits:
        return None
    us = 0.0
    for e in hits:
        a, b = max(e["ts"], s.start), min(_end(e), s.end)
        if b <= a:
            continue
        us += b - a
        if self_time:
            kids = [(max(k["ts"], a), min(_end(k), b)) for k in spans
                    if k is not e and k.get("tid") == e.get("tid")
                    and e["ts"] <= k["ts"] and _end(k) <= _end(e)]
            us -= union_s([(x, y) for x, y in kids if y > x])
    return us / 1e3 / s.calls


def total_ms(run, names: tuple[str, ...]) -> float | None:
    """The total time of the spans ``names`` per traced call, in ms."""
    return _read(run, names, self_time=False)


def self_ms(run, names: tuple[str, ...]) -> float | None:
    """The self time of the spans ``names`` per traced call, in ms."""
    return _read(run, names, self_time=True)
