"""Readings of the traced window shared by the per-layer readers."""


def idle_share(run) -> float | None:
    """1 − the union of device activities ÷ the traced window; None
    where the trace holds no device activity."""
    s = run.summary
    if s is None or not s.acts:
        return None
    return 1.0 - s.busy_s() / s.window_s


def per_call(run, total: float) -> float | None:
    s = run.summary
    if s is None or not s.acts:
        return None
    return total / s.calls
